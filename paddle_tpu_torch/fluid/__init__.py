"""fluid-compatible namespace for the port (ref: python/paddle/fluid):
``import paddle_tpu_torch.fluid as fluid`` gives the static-graph surface
the serving and training slices cover — Program, Executor
(``CUDAPlace(0)`` by default), CompiledProgram and BuildStrategy, the
BERT layers and LR schedules, ParamAttr, initializers, io,
append_backward, the optimizers, regularizers and gradient clips, and
``device_guard`` (a pipeline stage annotation for
``parallel.PipelineOptimizer``)."""

from ..framework.core import (Program, Variable, Parameter,  # noqa: F401
                              default_main_program, default_startup_program,
                              program_guard, device_guard, CPUPlace,
                              CUDAPlace,
                              is_compiled_with_cuda)
from ..framework.executor import (Executor, Scope, global_scope,  # noqa: F401
                                  scope_guard, PreparedStep, FetchHandle)
from ..framework.compiler import (CompiledProgram, BuildStrategy,  # noqa: F401
                                  ExecutionStrategy)
from ..framework.layer_helper import ParamAttr  # noqa: F401
from ..framework import initializer  # noqa: F401
from ..framework import unique_name  # noqa: F401
from .. import layers        # noqa: F401
from .. import io            # noqa: F401
from ..flags import get_flags, set_flags  # noqa: F401
from ..framework import core  # noqa: F401
from ..framework.backward import append_backward, gradients  # noqa: F401
from ..framework.executor import sync_prepared_state  # noqa: F401
from .. import optimizer     # noqa: F401
from .. import regularizer   # noqa: F401
from .. import clip          # noqa: F401

name_scope = unique_name.name_scope


def cuda_places(device_ids=None):
    import torch
    ids = device_ids if device_ids is not None else \
        range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in ids]


def cpu_places(device_count=1):
    return [CPUPlace() for _ in range(device_count)]
