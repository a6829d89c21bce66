"""Model builders — the port of paddle_tpu/models/ (BERT so far)."""

from . import bert  # noqa: F401
