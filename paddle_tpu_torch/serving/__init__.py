"""Serving tier — the port of paddle_tpu/serving/ (the padded
micro-batching engine; see engine.py).

    from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    pred = create_paddle_predictor(AnalysisConfig(model_dir))   # on the GPU
    engine = ServingEngine(pred, ServingConfig(
        max_batch_size=8, seq_buckets=(128, 256, 512),
        seq_feeds=("src_ids", "pos_ids", "sent_ids", "input_mask"),
        seq_fetches=(pred.get_output_names()[0],)))
    outputs = engine.submit(feed).result()
    engine.shutdown()
"""

from .engine import ServingConfig, ServingEngine, pad_request

__all__ = ["ServingConfig", "ServingEngine", "pad_request"]
