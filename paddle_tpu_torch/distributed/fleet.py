"""Fleet — the distributed-training API, the port of
paddle_tpu/distributed/fleet.py (ref: python/paddle/fluid/incubate/fleet/
base/fleet_base.py, incubate/fleet/collective/__init__.py:64
Collective(Fleet), :343 DistributedStrategy, :393 CollectiveOptimizer).

One process per rank, as the reference runs it on GPUs: a role maker
reads the rank's topology from the launcher's environment
(``distributed/launch.py``), ``fleet.init`` joins the
``torch.distributed`` process group (NCCL on a GPU unless the caller
names gloo, gloo on the CPU — :func:`~..framework.core.backend_for`),
and ``distributed_optimizer(...).minimize`` appends the backward and
update ops, then compiles the program for data parallelism over the
group (``CompiledProgram.with_data_parallel``: the gradient sync with the
strategy's bucketing and wire tier).  ``fleet.main_program`` is what each
rank runs, on ``fleet.place``.

The plain data-parallel path is ported: bucketed or per-leaf gradient
sync, the bf16 cast tier and the int8/int4 blockwise-quantized tiers,
and the meta-optimizers, composed in the JAX package's order: ``use_dgc``
(DGC momentum in place of Momentum), ``lamb``, ``sharding`` /
``sharded_update`` (ZeRO-1: ``ShardedUpdateOptimizer`` over the ``dp``
axis of the process group, its scatter at the strategy's wire tier —
``bf16_allreduce``'s cast or ``quant_configs``' int8/int4 — and no
gradient all-reduce inserted), ``amp`` (the inner optimizer wrapped by
``contrib.mixed_precision.decorate`` from ``amp_configs``),
``recompute`` (the backward's checkpoints), ``gradient_merge`` and
``localsgd`` (no gradient sync; the parameters averaged every
``k_steps``), and ``overlap_grad_sync`` (the buckets cut in gradient
ready order, ``overlap_configs``' ``bucket_mb`` and ``min_buckets``, and
fired from backward hooks by the executor).  ZeRO-3 is
``framework.fsdp.apply_fsdp_sharding`` + ``CompiledProgram.with_mesh``,
outside fleet, as in the JAX package.  ``strategy.mesh`` takes the
port's mesh (``MeshLayout(...).build_mesh()``, a ``ProcessMesh``) where
the JAX package takes a jax ``Mesh``: one data axis is data parallelism
over that axis, data x fsdp compiles ``with_mesh``, and a mesh with a
tensor (``tp``) or sequence (``sp``) axis, beside the data and fsdp axes
or not, compiles ``with_mesh`` with the sequence axis and feed specs
splitting every fed array of two dims or more on dim 0 over the batch
axes (dp and fsdp) and dim 1 over ``sp``.
``tensor_parallel`` / ``tensor_parallel_configs`` are taken as in the JAX
package: the layout comes from the parameters' ``dist_attr`` and the
mesh.  ``nccl_comm_num`` and
``use_hierarchical_allreduce`` are taken and change nothing, as in the
JAX package (one communicator a group; the backend schedules the
all-reduce).  ``pipeline`` / ``pipeline_configs`` (``accumulate_steps``
microbatches, ``num_stages``) cut the trained program into stages
(``framework.pipe.apply_pipeline``) and compile it ``with_mesh`` over an
explicit ``strategy.mesh`` with a ``pp`` axis, or over the job's ranks
split into (dp, pp) with pp = ``num_stages`` (default: every rank a
stage); ZeRO-1 beside it shards over the dp ranks.  ``pipeline_configs``
may also name ``apply_pipeline``'s ``shard_weights`` and
``feed_shapes`` (the microbatch's shapes the stage cut is planned at).
``auto_shard`` / ``auto_shard_configs`` (``hbm_budget_gb``, ``max_tp``,
``min_shard_numel``, ``num_devices`` (default: the world size),
``feed_shapes``, ``report_path``, ``fsdp_prefetch_distance``,
``max_pipe``, ``max_expert``, ``num_microbatches``, ``pipe_schedule``,
``pipe_shard_weights``, ``remat``) plan the layout statically
(``framework/shard_planner.py``), check that every rank reached the same
plan (:func:`plan_hash`), stamp the winner (a fsdp x tp one too) and
compile it ``with_mesh``;
``fleet.plan`` is the ranked plan.  A flag whose path is not ported (a
mesh of another kind or with an expert axis, pp beside fsdp, tp or sp, an
auto-shard winner the port does not run) raises
:class:`UnimplementedError` naming it; none is ignored.  Expert parallelism composes
``parallel.apply_expert_sharding`` with ``CompiledProgram.with_mesh``
outside fleet; the manual ``moe_ffn(ep_degree=n, axis_name="dp")``
build rides fleet's plain data parallelism.
``barrier_worker`` meets the other workers through the host collective
service (``distributed/gloo.py``) when ``PADDLE_GLOO_ENDPOINT`` is set."""

from __future__ import annotations

import datetime
import os
from typing import Optional

from ..framework.core import CUDAPlace, Place, backend_for
from ..framework.errors import InvalidArgumentError, UnimplementedError

#: seconds a collective may wait for its peers before the group fails
COLLECTIVE_TIMEOUT_S = 600


# ---------------------------------------------------------------------------
# role makers (ref: incubate/fleet/base/role_maker.py)
# ---------------------------------------------------------------------------


class RoleMakerBase:
    """A rank's place in the job: its index and the worker count, the
    device it drives, the backend and the rendezvous address."""

    def __init__(self):
        self._worker_index = 0
        self._worker_num = 1
        self._local_rank = 0
        self._place: Optional[Place] = None
        self._backend: Optional[str] = None
        self._init_method: Optional[str] = None

    def worker_index(self):
        return self._worker_index

    def worker_num(self):
        return self._worker_num

    def is_first_worker(self):
        return self._worker_index == 0

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def local_rank(self):
        return self._local_rank

    def place(self) -> Place:
        return self._place if self._place is not None else \
            CUDAPlace(self._local_rank)

    def backend(self) -> str:
        return backend_for(self.place(), self._backend)

    def init_method(self) -> Optional[str]:
        return self._init_method

    def generate_role(self):
        pass


def _env_int(names, default):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def _selected_gpu(local_rank: int) -> int:
    """This rank's GPU: ``FLAGS_selected_gpus`` (the launcher sets one id
    per rank; a comma list is indexed by the local rank), else the local
    rank."""
    sel = os.environ.get("FLAGS_selected_gpus", "")
    ids = [int(t) for t in sel.split(",") if t.strip()]
    if not ids:
        return local_rank
    return ids[local_rank] if len(ids) > 1 else ids[0]


def _rendezvous(address: Optional[str]) -> Optional[str]:
    """``tcp://host:port`` from ``address`` or MASTER_ADDR/MASTER_PORT."""
    if not address:
        host, port = os.environ.get("MASTER_ADDR"), \
            os.environ.get("MASTER_PORT")
        if not (host and port):
            return None
        address = f"{host}:{port}"
    return address if "://" in address else f"tcp://{address}"


class TPURoleMaker(RoleMakerBase):
    """The rank's topology from the launcher's environment (the analog of
    PaddleCloudRoleMaker's env discovery, role_maker.py:480; the name is
    the JAX package's): ``RANK`` / ``PADDLE_TRAINER_ID``, ``WORLD_SIZE``
    / ``PADDLE_TRAINERS_NUM``, ``LOCAL_RANK``, ``FLAGS_selected_gpus``,
    ``PADDLE_DISTRI_BACKEND`` and ``MASTER_ADDR`` / ``MASTER_PORT``.

    The rank runs on ``CUDAPlace(selected GPU)`` unless the caller passes
    ``place`` (``CPUPlace()`` to run on the CPU); ``backend`` overrides
    the environment's."""

    def __init__(self, coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 place: Optional[Place] = None,
                 backend: Optional[str] = None):
        super().__init__()
        self._coordinator = coordinator_address
        self._num_processes = num_processes
        self._process_id = process_id
        self._place_arg = place
        self._backend_arg = backend
        self._generated = False

    def generate_role(self):
        if self._generated:
            return
        rank = self._process_id if self._process_id is not None else \
            _env_int(("RANK", "PADDLE_TRAINER_ID"), 0)
        world = self._num_processes if self._num_processes is not None \
            else _env_int(("WORLD_SIZE", "PADDLE_TRAINERS_NUM"), 1)
        if not 0 <= rank < world:
            raise InvalidArgumentError(
                f"role maker: rank {rank} outside a world of {world}")
        self._worker_index, self._worker_num = rank, world
        self._local_rank = _env_int(("LOCAL_RANK",), rank)
        self._place = self._place_arg if self._place_arg is not None else \
            CUDAPlace(_selected_gpu(self._local_rank))
        self._backend = self._backend_arg or \
            os.environ.get("PADDLE_DISTRI_BACKEND") or None
        self._init_method = _rendezvous(self._coordinator)
        self._generated = True


PaddleCloudRoleMaker = TPURoleMaker


class UserDefinedRoleMaker(RoleMakerBase):
    """ref: role_maker.py:991 — a topology the caller states: rank
    ``current_id`` of ``workers``, on ``place`` (default the GPU of that
    index), meeting at ``init_method`` (default MASTER_ADDR/MASTER_PORT)
    when there is more than one worker."""

    def __init__(self, current_id=0, workers=1, place=None, backend=None,
                 init_method=None, **kw):
        super().__init__()
        self._worker_index = int(current_id)
        self._worker_num = int(workers)
        self._local_rank = self._worker_index
        self._place = place
        self._backend = backend
        self._init_method = _rendezvous(init_method)


# ---------------------------------------------------------------------------
# DistributedStrategy (ref: incubate/fleet/collective/__init__.py:343)
# ---------------------------------------------------------------------------


class DistributedStrategy:
    """Every field of the JAX package's strategy.  Ported paths:
    ``fuse_all_reduce_ops`` / ``fuse_grad_size_in_MB`` (bucketing),
    ``bf16_allreduce``, ``quant_allreduce`` / ``quant_configs``,
    ``sharding`` / ``sharded_update`` (ZeRO-1), ``amp``
    / ``amp_configs``, ``lamb`` / ``lamb_configs``, ``recompute`` /
    ``recompute_configs``, ``gradient_merge`` /
    ``gradient_merge_configs``, ``localsgd`` / ``localsgd_configs``,
    ``use_dgc``, ``overlap_grad_sync`` / ``overlap_configs``, ``mesh`` (a
    ``ProcessMesh`` of the dp, fsdp, tp and sp axes),
    ``tensor_parallel`` / ``tensor_parallel_configs`` (taken: the layout
    comes from ``dist_attr`` and the mesh), ``pipeline`` /
    ``pipeline_configs``, ``nccl_comm_num`` and
    ``use_hierarchical_allreduce`` (no-ops), ``auto_shard`` /
    ``auto_shard_configs`` and ``build_strategy``."""

    def __init__(self):
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 2.0 ** 15,
                            "use_dynamic_loss_scaling": True,
                            "use_pure_bf16": True}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01}
        self.use_dgc = False
        self.sharding = False
        self.sharded_update = False
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "num_stages": None}
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        # gradient bucketing, on by default as in the reference's
        # collective strategy
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.bf16_allreduce = False
        # blockwise-quantized grad collectives (ops/quantize_wire.py)
        self.quant_allreduce = False
        self.quant_configs = {"dtype": "int8", "block_size": 256,
                              "stochastic_rounding": False}
        self.overlap_grad_sync = False
        self.overlap_configs = {"bucket_mb": 4, "min_buckets": 4}
        self.mesh = None
        self.auto_shard = False
        self.auto_shard_configs = {
            "hbm_budget_gb": None, "max_tp": None, "min_shard_numel": 2048,
            "num_devices": None, "feed_shapes": None, "report_path": None,
            "fsdp_prefetch_distance": 0, "max_pipe": 1,
            "num_microbatches": 1, "pipe_schedule": "1f1b",
            "pipe_shard_weights": False, "remat": False,
        }
        self.exec_strategy = None
        self.build_strategy = None


def _refuse_unported(s):
    mesh = getattr(s, "mesh", None)
    from ..framework.mesh_layout import ProcessMesh, check_ported_axes
    if mesh is None:
        return
    if not isinstance(mesh, ProcessMesh):
        raise UnimplementedError(
            f"DistributedStrategy.mesh={mesh!r}: the port takes its own "
            f"mesh, MeshLayout(...).build_mesh() (a ProcessMesh over the "
            f"process group, one process per rank)")
    check_ported_axes(dict(mesh.shape), "DistributedStrategy.mesh")
    from ..framework.mesh_layout import EXPERT_AXIS
    if dict(mesh.shape).get(EXPERT_AXIS, 1) > 1:
        raise UnimplementedError(
            f"DistributedStrategy.mesh over the axes {dict(mesh.shape)}: "
            f"an expert axis through fleet is not ported yet (the JAX "
            f"package's fleet reaches expert layouts through auto_shard's "
            f"planner); compose parallel.apply_expert_sharding with "
            f"CompiledProgram.with_mesh, or build moe_ffn(ep_degree=n, "
            f"axis_name='dp') under plain data parallelism")
    if _sharded(s) and mesh.size > 1 and len(mesh.axis_names) != 1:
        # the JAX package's refusal (its fleet shards the update over one
        # axis); a hybrid grid composes with_mesh and the optimizer
        raise ValueError(
            "sharded_update currently shards over a single-axis "
            "(data-parallel) mesh; got axes "
            f"{tuple(mesh.axis_names)} — use CompiledProgram"
            ".with_mesh + ShardedUpdateOptimizer directly for "
            "hybrid grids")


def _batch_axes(mesh):
    """The axes of ``mesh`` the batch splits over: its dp and fsdp axes."""
    from ..framework.mesh_layout import DATA_AXIS, FSDP_AXIS
    axes = tuple(a for a in mesh.axis_names if a in (DATA_AXIS, FSDP_AXIS))
    return axes[0] if len(axes) == 1 else (axes or None)


def _seq_feed_specs(program, mesh):
    """Under a sequence axis, every fed array of two dims or more splits
    dim 0 over the batch axes and dim 1 over ``sp`` (the JAX package's
    ``feed_specs={f: P("dp", "sp")}``); none without one."""
    from ..framework.mesh_layout import SEQ_AXIS
    if SEQ_AXIS not in mesh.axis_names:
        return None
    batch = _batch_axes(mesh)
    return {v.name: (batch, SEQ_AXIS) for v in program.list_vars()
            if getattr(v, "is_data", False) and len(tuple(v.shape)) >= 2}


#: the ``pipeline_configs`` keys handed to ``apply_pipeline`` besides the
#: JAX package's ``accumulate_steps`` and ``num_stages``
_PIPE_OPTIONS = ("shard_weights", "feed_shapes")


def _pipe_layout(s):
    """(pipe stages, mesh) of ``strategy.pipeline``: an explicit
    ``strategy.mesh`` must have a ``pp`` axis of size >= 2; otherwise the
    job's ranks split into (dp, pp) with pp = ``pipeline_configs[
    "num_stages"]`` (default: every rank a stage)."""
    from ..framework.mesh_layout import PIPE_AXIS, MeshLayout
    if s.mesh is not None:
        stages = int(dict(s.mesh.shape).get(PIPE_AXIS, 0))
        if stages < 2:
            raise InvalidArgumentError(
                "DistributedStrategy: pipeline=True needs a mesh with a "
                f"'pp' axis of size >= 2; got axes {dict(s.mesh.shape)}")
        return stages, s.mesh
    n = fleet.worker_num()
    stages = int(dict(s.pipeline_configs or {}).get("num_stages") or 0) or n
    if n % stages:
        raise InvalidArgumentError(
            f"DistributedStrategy: num_stages={stages} does not divide the "
            f"{n} ranks of the job")
    return stages, MeshLayout(data=n // stages, pipe=stages).build_mesh()


def _dp_axis(s) -> str:
    """The axis one-axis data parallelism runs over: the strategy mesh's
    one axis, else ``dp``."""
    mesh = getattr(s, "mesh", None)
    if mesh is not None and len(mesh.axis_names) == 1:
        return mesh.axis_names[0]
    return "dp"


# ---------------------------------------------------------------------------
# Fleet singleton (ref: fleet_base.py Fleet)
# ---------------------------------------------------------------------------


class _Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._origin_program = None
        self._compiled_program = None
        self._plan = None          # the last auto_shard Plan
        self._plan_hashes = None   # every rank's sha256 of that plan

    # -- lifecycle -------------------------------------------------------
    def init(self, role_maker: Optional[RoleMakerBase] = None,
             is_collective: bool = True):
        """Read the rank's role and, with more than one worker, join the
        ``torch.distributed`` process group on the role's backend."""
        self._role_maker = role_maker or TPURoleMaker()
        self._role_maker.generate_role()
        rm = self._role_maker
        world = rm.worker_num()
        if world > 1:
            import torch.distributed as dist
            if dist.is_initialized():
                if dist.get_world_size() != world or \
                        dist.get_rank() != rm.worker_index():
                    raise InvalidArgumentError(
                        f"fleet.init: the process group is rank "
                        f"{dist.get_rank()} of {dist.get_world_size()}, the "
                        f"role maker says {rm.worker_index()} of {world}")
            else:
                place, backend = rm.place(), rm.backend()
                if rm.init_method() is None:
                    raise InvalidArgumentError(
                        "fleet.init: no rendezvous address for "
                        f"{world} workers — launch with `python -m "
                        "paddle_tpu_torch.distributed.launch`, or set "
                        "MASTER_ADDR and MASTER_PORT")
                if isinstance(place, CUDAPlace):
                    import torch
                    from ..framework.core import device_for
                    torch.cuda.set_device(device_for(place))
                from .launch import client_store
                timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
                store = client_store(rm.init_method(), world, timeout)
                meet = {"store": store} if store is not None else \
                    {"init_method": rm.init_method()}
                dist.init_process_group(
                    backend, world_size=world, rank=rm.worker_index(),
                    timeout=timeout, **meet)
        return self

    def _ensure_init(self):
        if self._role_maker is None:
            self.init()

    # -- topology --------------------------------------------------------
    def worker_index(self):
        self._ensure_init()
        return self._role_maker.worker_index()

    def worker_num(self):
        self._ensure_init()
        return self._role_maker.worker_num()

    def is_first_worker(self):
        self._ensure_init()
        return self._role_maker.is_first_worker()

    @property
    def place(self) -> Place:
        """The device this rank drives: ``CUDAPlace(selected GPU)``, or
        the place the role maker was given."""
        self._ensure_init()
        return self._role_maker.place()

    @property
    def backend(self) -> str:
        self._ensure_init()
        return self._role_maker.backend()

    @property
    def _gloo(self):
        """The host collective service (``distributed/gloo.py``) of this
        job, made from the launcher's environment the first time it is
        asked for; None without ``PADDLE_GLOO_ENDPOINT``."""
        if not hasattr(self, "_gloo_ctx"):
            from .gloo import init_from_env
            self._gloo_ctx = init_from_env()
        return self._gloo_ctx

    def barrier_worker(self):
        """Block until every worker reaches this point (ref:
        fleet_base.py barrier_worker -> GlooWrapper::Barrier): through the
        host collective service when ``PADDLE_GLOO_ENDPOINT`` is set,
        else through the process group (a no-op for one worker)."""
        g = self._gloo
        if g is not None:
            g.barrier()
            return
        import torch.distributed as dist
        if self.worker_num() > 1 and dist.is_initialized():
            dist.barrier()

    # -- programs --------------------------------------------------------
    @property
    def main_program(self):
        """The program each rank runs: the data-parallel
        ``CompiledProgram`` with more than one worker, else the program
        as minimize left it."""
        return self._compiled_program or self._origin_program

    @property
    def _origin_main_program(self):
        return self._origin_program

    @property
    def plan(self):
        """The ranked auto-shard Plan of the last ``auto_shard=True``
        minimize (``framework/shard_planner.py``), or None."""
        return self._plan


fleet = _Fleet()


# ---------------------------------------------------------------------------
# CollectiveOptimizer (ref: collective/__init__.py:393)
# ---------------------------------------------------------------------------


def _sharded(s) -> bool:
    return bool(getattr(s, "sharded_update", False) or
                getattr(s, "sharding", False))


class CollectiveOptimizer:
    def __init__(self, optimizer, strategy: Optional[DistributedStrategy]):
        self._inner = optimizer
        self._strategy = strategy or DistributedStrategy()

    @staticmethod
    def _validate(s):
        """Reject strategy combinations with contradictory step semantics
        (the reference's StrategyCompiler drops invalid meta-optimizers
        silently, ref: fleet/base/strategy_compiler.py; here an explicit
        error beats a silently changed recipe).  The JAX package's checks,
        in its order and with its messages, for every flag: they run
        before ``_refuse_unported``, so a contradictory strategy raises as
        it does there even where one of its flags is not ported."""
        if getattr(s, "bf16_allreduce", False) and \
                getattr(s, "quant_allreduce", False):
            raise InvalidArgumentError(
                "DistributedStrategy: bf16_allreduce and quant_allreduce "
                "both rewrite the grad-collective wire format and cannot "
                "compose — pick one (bf16 is the 16-bit tier of the "
                "compression ladder: keep quant_allreduce and set "
                "quant_configs['dtype'] = 'bfloat16' for the same wire "
                "bytes)")
        if getattr(s, "quant_allreduce", False):
            # fail at strategy level, not deep in the bucket pass
            from ..ops.quantize_wire import CompressionSpec
            CompressionSpec.from_attr(dict(s.quant_configs or {}))
        if getattr(s, "auto_shard", False):
            manual = [name for name in ("sharded_update", "sharding",
                                        "tensor_parallel")
                      if getattr(s, name, False)]
            if manual:
                raise InvalidArgumentError(
                    f"DistributedStrategy: auto_shard=True and manual "
                    f"{'/'.join(name + '=True' for name in manual)} both "
                    f"claim the sharding layout and cannot compose — the "
                    f"planner already searches ZeRO/tp configurations; "
                    f"pick one (drop the manual flag, or set "
                    f"auto_shard=False to keep the hand-picked layout)")
            if s.mesh is not None:
                raise InvalidArgumentError(
                    "DistributedStrategy: auto_shard=True and an explicit "
                    "strategy.mesh both pin the device layout and cannot "
                    "compose — the planner builds the winning mesh itself; "
                    "pick one (drop strategy.mesh, or set auto_shard=False)")
            if s.localsgd:
                raise InvalidArgumentError(
                    "DistributedStrategy: auto_shard prices per-step grad "
                    "sync that localsgd removes — the cost model would be "
                    "wrong; pick one")
        if getattr(s, "pipeline", False):
            if s.localsgd:
                raise ValueError(
                    "DistributedStrategy: pipeline accumulates "
                    "per-microbatch grads into one update per step; "
                    "localsgd removes that per-step sync — the "
                    "combination is contradictory")
            if s.recompute:
                raise InvalidArgumentError(
                    "DistributedStrategy: pipeline=True and "
                    "recompute=True both claim the recompute schedule — "
                    "the 1F1B lowering already rematerializes each "
                    "stage's forward at its backward tick, so explicit "
                    "recompute checkpoints would be ignored; drop one")
        if getattr(s, "overlap_grad_sync", False) and s.localsgd:
            raise ValueError(
                "DistributedStrategy: overlap_grad_sync schedules the "
                "per-step grad collectives that localsgd removes — the "
                "combination is contradictory")
        if s.localsgd and s.gradient_merge:
            raise ValueError(
                "DistributedStrategy: localsgd and gradient_merge both "
                "rewrite the update cadence (periodic param averaging vs "
                "k-step grad accumulation) and cannot compose — pick one")
        if s.localsgd and s.use_dgc:
            raise ValueError(
                "DistributedStrategy: localsgd removes the per-step grad "
                "allreduce that DGC compresses — the combination is "
                "contradictory")
        if s.lamb and s.use_dgc:
            raise ValueError(
                "DistributedStrategy: lamb and use_dgc both replace the "
                "base optimizer (LambOptimizer vs DGCMomentumOptimizer)")
        sharded = getattr(s, "sharded_update", False) or \
            getattr(s, "sharding", False)
        if sharded and s.localsgd:
            raise ValueError(
                "DistributedStrategy: sharded_update needs the per-step "
                "reduce_scatter grad sync that localsgd removes — the "
                "combination is contradictory")
        if sharded and s.use_dgc:
            raise ValueError(
                "DistributedStrategy: use_dgc masks top-k of the FULL "
                "gradient; a shard-local top-k diverges across replicas — "
                "sharded_update cannot compose with DGC")
        if sharded and s.lamb:
            raise ValueError(
                "DistributedStrategy: lamb trust ratios need full-tensor "
                "norms and cannot run on ZeRO shards — disable one")

    def _quant_spec(self):
        """The strategy's CompressionSpec (int8/int4 tiers), or None.
        The bfloat16 tier rides the cast path instead."""
        s = self._strategy
        if not getattr(s, "quant_allreduce", False):
            return None
        from ..ops.quantize_wire import CompressionSpec
        spec = CompressionSpec.from_attr(dict(s.quant_configs or {}))
        return None if spec.dtype == "bfloat16" else spec

    def _build_strategy(self):
        """Map the DistributedStrategy comm knobs onto the compiler's
        BuildStrategy (the reference keeps them on BuildStrategy; fleet
        mirrors them)."""
        from ..framework.compiler import BuildStrategy
        s = self._strategy
        build = s.build_strategy or BuildStrategy()
        build.fuse_all_reduce_ops = bool(getattr(s, "fuse_all_reduce_ops",
                                                 False))
        build.fuse_grad_size_in_MB = getattr(s, "fuse_grad_size_in_MB", 32)
        if getattr(s, "overlap_grad_sync", False):
            ov = dict(getattr(s, "overlap_configs", None) or {})
            build.overlap_grad_sync = True
            build.overlap_bucket_size_in_MB = ov.get("bucket_mb", 4)
            build.overlap_min_buckets = ov.get("min_buckets", 4)
        if getattr(s, "bf16_allreduce", False):
            build.allreduce_compress_dtype = "bfloat16"
        if getattr(s, "quant_allreduce", False):
            spec = self._quant_spec()
            if spec is not None:
                build.allreduce_quant_spec = spec.to_attr()
            else:                      # bfloat16 tier -> the cast path
                build.allreduce_compress_dtype = "bfloat16"
        return build

    def _wrapped(self, shard_ranks):
        """The inner optimizer, swapped and wrapped by the strategy's
        meta-optimizers in the JAX package's order (its ``_compose``):
        ``use_dgc`` swaps a raw ``MomentumOptimizer`` for a
        ``DGCMomentumOptimizer`` of its settings (any other optimizer
        stays, as there); ``lamb`` replaces it by a ``LambOptimizer`` of
        its learning rate and ``lamb_configs["lamb_weight_decay"]``;
        ``sharding`` / ``sharded_update`` over ``shard_ranks`` data-parallel
        ranks (more than one) wraps it in a ``ShardedUpdateOptimizer`` over
        the ``dp`` axis (the bf16 cast
        for ``bf16_allreduce``, the strategy's int8/int4 spec for
        ``quant_allreduce``); then ``decorate`` for ``amp``,
        ``RecomputeOptimizer`` with
        ``recompute_configs["checkpoints"]``, ``GradientMergeOptimizer``
        and ``LocalSGDOptimizer``."""
        from .. import optimizer as opt_mod
        s = self._strategy
        optimizer = self._inner
        # the DGC swap happens on the raw inner optimizer, before any
        # wrapper hides its type (ref: incubate/fleet/collective/
        # __init__.py:478)
        if s.use_dgc and isinstance(optimizer, opt_mod.MomentumOptimizer):
            optimizer = opt_mod.DGCMomentumOptimizer(
                learning_rate=optimizer._learning_rate,
                momentum=optimizer._momentum,
                rampup_begin_step=0,
                use_nesterov=optimizer._use_nesterov,
                regularization=optimizer.regularization,
                grad_clip=optimizer._grad_clip)
        if s.lamb and not isinstance(optimizer, opt_mod.LambOptimizer):
            optimizer = opt_mod.LambOptimizer(
                learning_rate=optimizer._learning_rate,
                lamb_weight_decay=s.lamb_configs.get("lamb_weight_decay",
                                                     0.01))
        if _sharded(s) and shard_ranks > 1:
            optimizer = opt_mod.ShardedUpdateOptimizer(
                optimizer, nranks=shard_ranks, axis_name=_dp_axis(s),
                compress_dtype="bfloat16" if getattr(s, "bf16_allreduce",
                                                     False) else None,
                quant_spec=self._quant_spec())
        if s.amp:
            from ..contrib.mixed_precision import decorate
            optimizer = decorate(
                optimizer,
                init_loss_scaling=s.amp_configs.get("init_loss_scaling",
                                                    2.0 ** 15),
                use_dynamic_loss_scaling=s.amp_configs.get(
                    "use_dynamic_loss_scaling", True),
                use_pure_bf16=s.amp_configs.get("use_pure_bf16", True))
        if s.recompute:
            rc = opt_mod.RecomputeOptimizer(optimizer)
            rc._set_checkpoints(s.recompute_configs.get("checkpoints", []))
            optimizer = rc
        if s.gradient_merge:
            optimizer = opt_mod.GradientMergeOptimizer(
                optimizer, k_steps=s.gradient_merge_configs.get("k_steps", 1),
                avg=s.gradient_merge_configs.get("avg", True))
        if s.localsgd:
            optimizer = opt_mod.LocalSGDOptimizer(
                optimizer, k_steps=s.localsgd_configs.get("k_steps", 1),
                begin_step=s.localsgd_configs.get("begin_step", 1))
        return optimizer

    def _minimize_auto(self, loss, startup_program=None,
                       parameter_list=None, no_grad_set=None):
        """``strategy.auto_shard``: the plain training program first (the
        backward and update ops, no layout), then the planner ranks the
        (data, fsdp, tp, pipe, expert) layouts of the job's ranks
        statically (``shard_planner.plan_sharding``, nothing launched),
        every rank checks that all of them reached the same plan, and the
        winner is stamped onto this program (``stamp_winning_layout``:
        the expert, ZeRO-3 and pipeline rewrites; a winner the port does
        not run raises by name) and compiled ``with_mesh`` over its
        mesh."""
        from ..flags import flag
        from ..framework.mesh_layout import (EXPERT_AXIS, FSDP_AXIS,
                                             _flat_axes)
        from ..framework.shard_planner import (plan_sharding,
                                               stamp_winning_layout)
        s = self._strategy
        cfgs = dict(s.auto_shard_configs or {})
        program = loss.block.program
        # a manual per-parameter fsdp or expert stamp claims the layout the
        # planner searches (tp annotations are fine: it searches the tp
        # dimension they declare)
        for p in program.all_parameters():
            da = getattr(p, "dist_attr", None)
            if da and FSDP_AXIS in _flat_axes(tuple(da)):
                raise InvalidArgumentError(
                    f"DistributedStrategy: auto_shard=True and a manual "
                    f"per-param dist_attr override on {p.name!r} "
                    f"({tuple(da)!r}) both claim the {FSDP_AXIS!r} axis "
                    f"and cannot compose — drop the manual stamp or set "
                    f"auto_shard=False")
            if da and EXPERT_AXIS in _flat_axes(tuple(da)):
                raise InvalidArgumentError(
                    f"DistributedStrategy: auto_shard=True and a manual "
                    f"ep_degree stamp on {p.name!r} ({tuple(da)!r}) both "
                    f"claim the {EXPERT_AXIS!r} axis and cannot compose "
                    f"— build the MoE layer dense (ep_degree=None) and "
                    f"let the planner search max_expert, or set "
                    f"auto_shard=False")
        for op in program.global_block().ops:
            if op.type == "c_expert_alltoall" and \
                    op.attrs.get("_axis_name"):
                raise InvalidArgumentError(
                    "DistributedStrategy: auto_shard=True cannot compose "
                    "with a manually expert-parallel MoE build (found a "
                    "c_expert_alltoall over axis "
                    f"{op.attrs['_axis_name']!r}) — build the MoE layer "
                    "dense (ep_degree=None) and pass "
                    "auto_shard_configs={'max_expert': ...}, or set "
                    "auto_shard=False")

        opt_ops, params_grads = self._wrapped(1).minimize(
            loss, startup_program, parameter_list, no_grad_set)

        ndev = int(cfgs.get("num_devices") or fleet.worker_num())
        budget = cfgs.get("hbm_budget_gb")
        if budget is None:
            budget = float(flag("hbm_budget_gb") or 0.0) or None
        min_numel = int(cfgs.get("min_shard_numel") or 2048)
        plan = plan_sharding(
            program, ndev, loss_name=loss.name,
            feed_shapes=cfgs.get("feed_shapes"),
            fetch_names=[loss.name], hbm_budget_gb=budget,
            build_strategy=self._build_strategy(),
            max_tp=cfgs.get("max_tp"), min_shard_numel=min_numel,
            module="auto_shard",
            report_path=cfgs.get("report_path"),
            max_pipe=int(cfgs.get("max_pipe") or 1),
            max_expert=int(cfgs.get("max_expert") or 1),
            num_microbatches=int(cfgs.get("num_microbatches") or 1),
            remat=bool(cfgs.get("remat")),
            pipe_schedule=str(cfgs.get("pipe_schedule") or "1f1b"),
            pipe_shard_weights=bool(cfgs.get("pipe_shard_weights")))
        fleet._plan = plan
        fleet._plan_hashes = _same_plan_everywhere(plan)
        layout = stamp_winning_layout(
            program, plan, min_shard_numel=min_numel,
            prefetch_distance=int(cfgs.get("fsdp_prefetch_distance")
                                  or 0),
            feed_shapes=cfgs.get("feed_shapes"))
        fleet._origin_program = program
        mesh = layout.build_mesh()
        if mesh is not None:
            from ..framework.compiler import CompiledProgram
            fleet._compiled_program = CompiledProgram(program).with_mesh(
                mesh, loss_name=loss.name, batch_axis=layout.batch_axes,
                build_strategy=self._build_strategy())
        else:
            fleet._compiled_program = None
        return opt_ops, params_grads

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """The (wrapped) inner optimizer's backward and update ops, then —
        with more than one worker — the data-parallel compile over the
        process group (``fleet.main_program``): the gradient sync goes
        right after the ``backward`` op, ahead of an AMP program's
        ``check_finite_and_unscale``, so every rank sees the same
        overflow verdict.  Under ``localsgd`` no gradient sync is
        inserted: the ranks average their parameters every ``k_steps``
        instead (``local_sgd_sync``); under ``sharding`` neither: the
        sharded update scatters the gradients itself.  A data x fsdp
        ``strategy.mesh`` compiles ``with_mesh`` over it instead, a
        one-axis one ``with_data_parallel`` over its axis."""
        fleet._ensure_init()
        s = self._strategy
        fleet._strategy = s
        self._validate(s)
        if getattr(s, "auto_shard", False):
            return self._minimize_auto(loss, startup_program,
                                       parameter_list, no_grad_set)
        _refuse_unported(s)
        if s.mesh is not None and s.mesh.size != fleet.worker_num():
            raise ValueError(
                f"DistributedStrategy.mesh: {s.mesh!r} needs {s.mesh.size} "
                f"ranks, the job has {fleet.worker_num()}")
        stages, mesh = _pipe_layout(s) if s.pipeline else (1, s.mesh)
        opt_ops, params_grads = self._wrapped(
            fleet.worker_num() // stages).minimize(
            loss, startup_program, parameter_list, no_grad_set)
        program = loss.block.program
        fleet._origin_program = program
        from ..framework.compiler import CompiledProgram
        loss_name = None if (s.localsgd or _sharded(s)) else loss.name
        if s.pipeline:
            # the JAX package's _finish_pipeline: cut the trained program
            # into stages, compile it over the (dp, pp) mesh
            from ..framework.pipe import apply_pipeline
            pcfg = dict(s.pipeline_configs or {})
            apply_pipeline(program, stages,
                           int(pcfg.get("accumulate_steps") or 1),
                           **{k: pcfg[k] for k in _PIPE_OPTIONS
                              if pcfg.get(k) is not None})
            fleet._compiled_program = CompiledProgram(program).with_mesh(
                mesh, loss_name=loss_name, batch_axis="dp",
                build_strategy=self._build_strategy())
            return opt_ops, params_grads
        from ..framework.mesh_layout import SEQ_AXIS, TP_AXIS
        model = [a for a in (TP_AXIS, SEQ_AXIS) if mesh is not None and
                 a in mesh.axis_names]
        if model:
            # tensor / sequence parallelism: the batch splits over the data
            # axes, every fed [B, S, ...] array's dim 1 over sp
            fleet._compiled_program = CompiledProgram(program).with_mesh(
                mesh, loss_name=loss_name,
                batch_axis=_batch_axes(mesh),
                seq_axis=SEQ_AXIS if SEQ_AXIS in model else None,
                feed_specs=_seq_feed_specs(program, mesh),
                build_strategy=self._build_strategy())
        elif mesh is not None and len(mesh.axis_names) > 1:
            # data x fsdp: both axes split the batch
            fleet._compiled_program = CompiledProgram(program).with_mesh(
                mesh, loss_name=loss_name, batch_axis=mesh.axis_names,
                build_strategy=self._build_strategy())
        elif fleet.worker_num() > 1:
            fleet._compiled_program = CompiledProgram(
                program).with_data_parallel(
                loss_name=loss_name, build_strategy=self._build_strategy(),
                axis_name=_dp_axis(s))
        else:
            fleet._compiled_program = None
        return opt_ops, params_grads


def plan_hash(plan) -> str:
    """sha256 of a Plan's JSON (keys sorted): equal on every rank that
    planned the same program with the same figures."""
    import hashlib
    import json
    return hashlib.sha256(json.dumps(plan.as_dict(), sort_keys=True)
                          .encode()).hexdigest()


def _same_plan_everywhere(plan):
    """Every rank plans for itself: gather each rank's :func:`plan_hash`
    and raise ``InvalidArgumentError`` if any two differ (the ranks would
    build different programs and hang in their collectives).  Returns the
    hashes, rank by rank."""
    import torch.distributed as dist
    mine = plan_hash(plan)
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return [mine]
    hashes = [None] * dist.get_world_size()
    dist.all_gather_object(hashes, mine)
    if len(set(hashes)) != 1:
        raise InvalidArgumentError(
            f"auto_shard: the ranks planned differently (plan hashes "
            f"{hashes}); every rank must see the same program, feeds, "
            f"budget and figures")
    return hashes


def distributed_optimizer(optimizer, strategy: Optional[DistributedStrategy]
                          = None):
    """ref: fleet_base.py distributed_optimizer entry point."""
    return CollectiveOptimizer(optimizer, strategy)


fleet.distributed_optimizer = distributed_optimizer
fleet.DistributedStrategy = DistributedStrategy


# -- paddle.distributed API surface ---------------------------------------

def init_parallel_env():
    fleet._ensure_init()
    return fleet


def get_world_size() -> int:
    """Ranks in the process group (1 outside one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0

