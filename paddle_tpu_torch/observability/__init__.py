"""Run-level telemetry — the port of paddle_tpu/observability.  Each layer
imports alone:

* :mod:`.tracing` — spans with attributes on a shared, monotonically
  increasing ``step_id`` axis (the substrate ``profiler`` sits on);
* :mod:`.metrics` — labeled counters / gauges / histograms over the
  ``monitor`` registry, ``metrics_snapshot()``, the Prometheus text and a
  loopback scrape server;
* :mod:`.flops` — the static GEMM FLOPs a step, the GEMM dtype and the
  card's peak for it;
* :mod:`.recorder` — :class:`TelemetryRecorder`: an append-only JSONL
  stream per run with per-step wall time, measured MFU, goodput, loss
  finiteness, the guarded step's skips and loss scale, wire bytes and HBM
  headroom;
* :mod:`.flight` — the crash flight recorder: a ring of recent steps and
  spans dumped as a diagnostic bundle on uncaught executor / serving
  exceptions, a failed restore, a watchdog trip and a non-finite loss;
* :mod:`.watchdog` — the hang watchdog: progress beacons on the prepared
  step, the serving and decode workers and the checkpoint writer, and a
  monitor thread (``flag("step_deadline_s")``) that dumps every thread's
  stack and a flight bundle when one stalls past the deadline.
"""

from . import tracing, flight, metrics, flops, recorder, watchdog  # noqa: F401,E501
from .tracing import (Span, span, traced, next_step_id,          # noqa: F401
                      current_step_id, set_step_id, step_scope)
from .metrics import (counter, gauge, histogram,                 # noqa: F401
                      metrics_snapshot, prometheus_text, serve_metrics)
from .recorder import TelemetryRecorder, validate_jsonl          # noqa: F401

__all__ = ["tracing", "flight", "metrics", "flops", "recorder", "watchdog",
           "Span", "span", "traced", "next_step_id", "current_step_id",
           "set_step_id", "step_scope", "counter", "gauge", "histogram",
           "metrics_snapshot", "prometheus_text", "serve_metrics",
           "TelemetryRecorder", "validate_jsonl"]
