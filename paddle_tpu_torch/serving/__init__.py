"""Serving tier — the port of paddle_tpu/serving/: the padded
micro-batching engine (engine.py) and the paged-KV decode engine
(decode.py).

    from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    pred = create_paddle_predictor(AnalysisConfig(model_dir))   # on the GPU
    engine = ServingEngine(pred, ServingConfig(
        max_batch_size=8, seq_buckets=(128, 256, 512),
        seq_feeds=("src_ids", "pos_ids", "sent_ids", "input_mask"),
        seq_fetches=(pred.get_output_names()[0],)))
    outputs = engine.submit(feed).result()
    engine.shutdown()

    from paddle_tpu_torch.models import BertDecoder
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    engine = DecodeEngine(BertDecoder(cfg, seed=2024), DecodeConfig(
        block_size=16, max_seq_len=512, prefill_seq_buckets=(64, 128, 256,
        512), chain_lengths=(1, 8)))                       # on the GPU
    result = engine.generate({"src_ids": prompt}).result()  # tokens
    engine.shutdown()
"""

from .decode import DecodeConfig, DecodeEngine, GenerationResult, \
    blocks_needed
from .engine import ServingConfig, ServingEngine, pad_request

__all__ = ["ServingConfig", "ServingEngine", "pad_request", "DecodeConfig",
           "DecodeEngine", "GenerationResult", "blocks_needed"]
