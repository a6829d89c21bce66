"""Distributed training for the port (ref: python/paddle/distributed):
``fleet`` (the singleton; the module is ``distributed.fleet``) and the
paddle.distributed helpers.  The launcher is run as a module, ``python
-m paddle_tpu_torch.distributed.launch``, and is not imported here."""

from . import fleet as _fleet_module  # noqa: F401
from .fleet import (fleet, init_parallel_env, get_world_size,  # noqa: F401
                    get_rank)
