"""CompiledProgram — the port of paddle_tpu/framework/compiler.py (ref:
python/paddle/fluid/compiler.py:87 CompiledProgram, :160
with_data_parallel).

On one GPU ``with_data_parallel`` inserts no gradient sync (there is
nothing to sync) and records the build strategy's passes;
``fuse_elewise_add_act_ops`` defers ``fuse_elemwise_add_act`` to the
first run, where the fetch list is known, so a fetched intermediate is
never fused away.  The passes run on a clone of the program per fetch
list (:meth:`CompiledProgram._variant_for`, an LRU of 8 clones), and the
executor runs the clone against the same scope.

More than one place, and ``with_mesh``, need the multi-GPU slice
(``torch.distributed`` gradient sync): they raise rather than train
quietly on one device.  The JAX package's static checks of a variant
(``verify_programs``, ``hbm_budget_gb``, ``aot_cache_dir``) belong to
modules the port does not have yet, and it has none of those flags."""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch

from .core import Program
from .errors import UnimplementedError
from .passes import apply_pass

_MULTI_GPU = ("the multi-GPU slice of the port (torch.distributed gradient "
              "sync) is not ported yet")


class BuildStrategy:
    """ref: details/build_strategy.h — the JAX package's fields.  On one
    place only ``fuse_elewise_add_act_ops`` changes the program; the
    gradient-sync fields take effect with the multi-GPU slice."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = False
        self.fuse_grad_size_in_MB = 32
        self.allreduce_compress_dtype = None
        self.allreduce_quant_spec = None
        self.overlap_grad_sync = False
        self.overlap_bucket_size_in_MB = 4
        self.overlap_min_buckets = 4
        # off by default like the reference (build_strategy.h)
        self.fuse_elewise_add_act_ops = False
        self.enable_inplace = True
        self.memory_optimize = True
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """ref: details/execution_strategy.h — kept for API parity; the port
    runs the ops of a step in program order on one stream."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


def _place_count(places) -> int:
    if places is not None:
        return len(places)
    return max(1, torch.cuda.device_count())


class CompiledProgram:
    #: retained pass-variant clones (one per fetch list)
    _VARIANT_CAP = 8

    def __init__(self, program: Program):
        self._program = program
        self._loss_name = None
        self._pending_passes = []
        self._pass_variants: "OrderedDict[tuple, Program]" = OrderedDict()

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy=None, share_vars_from=None,
                           places=None, mesh=None, axis_name: str = "dp"):
        """Data parallelism over ``places`` (default: every visible GPU).
        One place runs the program as it is, with the build strategy's
        passes; more than one raises until the multi-GPU slice."""
        n = _place_count(places)
        if mesh is not None or n > 1:
            raise UnimplementedError(
                f"CompiledProgram.with_data_parallel over "
                f"{'a mesh' if mesh is not None else f'{n} places'}: "
                f"{_MULTI_GPU}")
        self._loss_name = loss_name
        strategy = build_strategy or BuildStrategy()
        if strategy.fuse_elewise_add_act_ops:
            # ref: build_strategy.cc:51 runs fuse_elewise_add_act_pass in
            # the training pipeline
            self._pending_passes.append("fuse_elemwise_add_act")
        return self

    def with_mesh(self, mesh, loss_name: Optional[str] = None, **_):
        raise UnimplementedError(f"CompiledProgram.with_mesh: {_MULTI_GPU}")

    def _variant_for(self, fetch_names) -> Program:
        """The pass-rewritten clone of the program for this fetch list
        (the program itself when no pass is pending).  Fetched
        intermediates survive the passes, and the run order of fetch
        lists does not matter.  A true LRU: a hit moves the variant to
        the back, and the least recently used of more than
        ``_VARIANT_CAP`` is dropped."""
        if not self._pending_passes:
            return self._program
        key = tuple(fetch_names)
        hit = self._pass_variants.get(key)
        if hit is not None:
            self._pass_variants.move_to_end(key)
            return hit
        clone = self._program.clone()
        for name in self._pending_passes:
            apply_pass(clone, name, fetch_names=list(fetch_names))
        if len(self._pass_variants) >= self._VARIANT_CAP:
            self._pass_variants.popitem(last=False)
        self._pass_variants[key] = clone
        return clone

    # pass-through conveniences so CompiledProgram quacks like Program
    def __getattr__(self, item):
        return getattr(self._program, item)
