"""Observability — the port of paddle_tpu/observability, so far only the
static FLOP count and the device peak the auto-shard planner prices its
compute term with (:mod:`.flops`)."""
