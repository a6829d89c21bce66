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
and mixed precision (``amp``: the inner optimizer wrapped by
``contrib.mixed_precision.decorate`` from ``amp_configs``).  A
strategy flag whose path is not ported (recompute, gradient_merge,
localsgd, lamb, sharding / sharded_update, tensor_parallel, pipeline,
auto_shard, overlap_grad_sync, use_dgc, hierarchical all-reduce, an
explicit mesh) raises :class:`UnimplementedError` naming it; none is
ignored."""

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
    ``bf16_allreduce``, ``quant_allreduce`` / ``quant_configs``, ``amp``
    / ``amp_configs`` and ``build_strategy``; any other flag set raises
    at ``minimize``."""

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


#: strategy flags whose paths are not ported, with what each needs
_UNPORTED = (
    ("recompute", "recompute checkpoints in the executor"),
    ("gradient_merge", "GradientMergeOptimizer"),
    ("localsgd", "LocalSGDOptimizer and local_sgd_sync"),
    ("use_dgc", "DGCMomentumOptimizer"),
    ("sharding", "the ZeRO-1 sharded update"),
    ("sharded_update", "the ZeRO-1 sharded update"),
    ("tensor_parallel", "tensor parallelism"),
    ("pipeline", "pipeline parallelism"),
    ("auto_shard", "the auto-shard planner"),
    ("overlap_grad_sync", "backward hooks in the executor"),
    ("use_hierarchical_allreduce", "hierarchical all-reduce"),
)


def _refuse_unported(s):
    for name, needs in _UNPORTED:
        if getattr(s, name, False):
            raise UnimplementedError(
                f"DistributedStrategy.{name}=True: its path ({needs}) is "
                f"not ported yet")
    if getattr(s, "nccl_comm_num", 1) != 1:
        raise UnimplementedError(
            f"DistributedStrategy.nccl_comm_num={s.nccl_comm_num}: one "
            f"communicator per process group is what is ported")
    if getattr(s, "mesh", None) is not None:
        raise UnimplementedError(
            "DistributedStrategy.mesh: meshes (ZeRO, tensor and pipeline "
            "parallelism) are not ported yet; data parallelism is one "
            "process per rank")


# ---------------------------------------------------------------------------
# Fleet singleton (ref: fleet_base.py Fleet)
# ---------------------------------------------------------------------------


class _Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._origin_program = None
        self._compiled_program = None

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
                dist.init_process_group(
                    backend, init_method=rm.init_method(),
                    world_size=world, rank=rm.worker_index(),
                    timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
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

    def barrier_worker(self):
        """Block until every worker reaches this point (a no-op for one
        worker)."""
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


fleet = _Fleet()


# ---------------------------------------------------------------------------
# CollectiveOptimizer (ref: collective/__init__.py:393)
# ---------------------------------------------------------------------------


class CollectiveOptimizer:
    def __init__(self, optimizer, strategy: Optional[DistributedStrategy]):
        self._inner = optimizer
        self._strategy = strategy or DistributedStrategy()

    @staticmethod
    def _validate(s):
        """Reject strategy combinations with contradictory step semantics
        (the reference's StrategyCompiler drops invalid meta-optimizers
        silently, ref: fleet/base/strategy_compiler.py; here an explicit
        error beats a silently changed recipe).  Only the ported flags'
        combinations are checked: ``_refuse_unported`` runs next, and the
        checks of the other flags' combinations come with their paths,
        but for LAMB's two, which come first and raise as the JAX
        package's do although DGC and ZeRO are refused by name."""
        if s.lamb and s.use_dgc:
            raise ValueError(
                "DistributedStrategy: lamb and use_dgc both replace the "
                "base optimizer (LambOptimizer vs DGCMomentumOptimizer)")
        sharded = getattr(s, "sharded_update", False) or \
            getattr(s, "sharding", False)
        if sharded and s.lamb:
            raise ValueError(
                "DistributedStrategy: lamb trust ratios need full-tensor "
                "norms and cannot run on ZeRO shards — disable one")
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
        if getattr(s, "bf16_allreduce", False):
            build.allreduce_compress_dtype = "bfloat16"
        if getattr(s, "quant_allreduce", False):
            spec = self._quant_spec()
            if spec is not None:
                build.allreduce_quant_spec = spec.to_attr()
            else:                      # bfloat16 tier -> the cast path
                build.allreduce_compress_dtype = "bfloat16"
        return build

    def _wrapped(self):
        """The inner optimizer, swapped and wrapped by the strategy's
        meta-optimizers as the JAX package does it: ``lamb`` replaces it
        by a ``LambOptimizer`` of its learning rate and
        ``lamb_configs["lamb_weight_decay"]`` (its other settings are not
        carried over, as there), then ``decorate`` for ``amp``."""
        from .. import optimizer as opt_mod
        s = self._strategy
        optimizer = self._inner
        if s.lamb and not isinstance(optimizer, opt_mod.LambOptimizer):
            optimizer = opt_mod.LambOptimizer(
                learning_rate=optimizer._learning_rate,
                lamb_weight_decay=s.lamb_configs.get("lamb_weight_decay",
                                                     0.01))
        if s.amp:
            from ..contrib.mixed_precision import decorate
            optimizer = decorate(
                optimizer,
                init_loss_scaling=s.amp_configs.get("init_loss_scaling",
                                                    2.0 ** 15),
                use_dynamic_loss_scaling=s.amp_configs.get(
                    "use_dynamic_loss_scaling", True),
                use_pure_bf16=s.amp_configs.get("use_pure_bf16", True))
        return optimizer

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """The (wrapped) inner optimizer's backward and update ops, then —
        with more than one worker — the data-parallel compile over the
        process group (``fleet.main_program``): the gradient sync goes
        right after the ``backward`` op, ahead of an AMP program's
        ``check_finite_and_unscale``, so every rank sees the same
        overflow verdict."""
        fleet._ensure_init()
        s = self._strategy
        fleet._strategy = s
        self._validate(s)
        _refuse_unported(s)
        opt_ops, params_grads = self._wrapped().minimize(
            loss, startup_program, parameter_list, no_grad_set)
        program = loss.block.program
        fleet._origin_program = program
        if fleet.worker_num() > 1:
            from ..framework.compiler import CompiledProgram
            fleet._compiled_program = CompiledProgram(
                program).with_data_parallel(
                loss_name=loss.name, build_strategy=self._build_strategy())
        else:
            fleet._compiled_program = None
        return opt_ops, params_grads


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

