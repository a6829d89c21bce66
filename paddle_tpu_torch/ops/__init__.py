"""Op implementations in PyTorch — the port of paddle_tpu/ops/.  Importing
this package registers every op impl and the kernel-route table; it
builds and loads no kernel (ops/cuda/ does that at first launch)."""

from . import registry      # noqa: F401
from . import math_ops      # noqa: F401
from . import tensor_ops    # noqa: F401
from . import nn_ops        # noqa: F401
from . import attention_ops  # noqa: F401
from . import cache_ops     # noqa: F401
from . import sampling_ops  # noqa: F401
from . import fused_ops     # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import collective_ops  # noqa: F401
from . import tp_ops        # noqa: F401
from . import moe_ops       # noqa: F401
from . import controlflow_ops  # noqa: F401
from . import pipeline_op   # noqa: F401
from . import op_specs      # noqa: F401
