"""Contributed modules — the port of paddle_tpu/contrib/ (ref:
python/paddle/fluid/contrib).  Mixed precision only; ``slim`` and
``layers`` are not ported yet."""

from . import mixed_precision  # noqa: F401
