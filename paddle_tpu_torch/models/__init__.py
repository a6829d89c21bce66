"""Model builders — the port of paddle_tpu/models/ (BERT and its causal
decoder so far)."""

from . import bert  # noqa: F401
from .decoder import BertDecoder, DecoderPrograms  # noqa: F401

__all__ = ["BertDecoder", "DecoderPrograms"]
