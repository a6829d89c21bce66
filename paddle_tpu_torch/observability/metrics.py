"""Labeled metrics registry and its JSON / Prometheus export — the port
of paddle_tpu/observability/metrics.py.

* :func:`counter` / :func:`gauge` / :func:`histogram` — get-or-create a
  labeled instrument; one registry entry per (name, label set);
* :func:`metrics_snapshot` — one JSON-able dict of everything: the
  ``monitor`` counters, every labeled instrument, and the live serving
  engines' stats (``profiler.serving_stats()``);
* :func:`prometheus_text` — the same data in the Prometheus text
  exposition format, byte for byte the JAX package's for the same
  registry calls (the schema and the default ``paddle_tpu`` prefix are
  kept, so one scrape configuration reads either package);
* :func:`serve_metrics` — a stdlib ThreadingHTTPServer exposing
  ``/metrics`` (Prometheus) and ``/metrics.json`` (snapshot) on the
  loopback address; port 0 binds an ephemeral port.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Dict, List, Sequence, Tuple

_REG_LOCK = threading.Lock()
_METRICS: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], "Metric"] = {}

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    kind = "untyped"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()

    def snapshot(self) -> Dict[str, Any]:
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self._value = 0.0

    def add(self, v: float = 1.0) -> float:
        with self._lock:
            self._value += v
            return self._value

    def get(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self):
        return {"value": self.get()}


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def add(self, v: float = 1.0) -> float:
        with self._lock:
            self._value += v
            return self._value

    def get(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self):
        return {"value": self.get()}


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, labels, buckets: Sequence[float] = None):
        super().__init__(name, labels)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)   # +inf tail
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float):
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self):
        with self._lock:
            cum, out = 0, []
            for b, c in zip(self.buckets, self._counts):
                cum += c
                out.append([b, cum])
            return {"buckets": out, "sum": self._sum,
                    "count": self._count}


def _get(cls, name: str, labels: Dict[str, Any], **kw) -> Metric:
    key = (name, _label_key(labels))
    with _REG_LOCK:
        m = _METRICS.get(key)
        if m is None:
            m = cls(name, key[1], **kw)
            _METRICS[key] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r}{dict(key[1])} already registered as "
                f"{m.kind}, not {cls.kind}")
        return m


def counter(name: str, **labels) -> Counter:
    return _get(Counter, name, labels)


def gauge(name: str, **labels) -> Gauge:
    return _get(Gauge, name, labels)


def histogram(name: str, buckets: Sequence[float] = None,
              **labels) -> Histogram:
    return _get(Histogram, name, labels, buckets=buckets)


def reset_metrics():
    with _REG_LOCK:
        _METRICS.clear()


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def metrics_snapshot(include_serving: bool = True) -> Dict[str, Any]:
    """One JSON-able snapshot: legacy monitor counters + every labeled
    instrument + the live serving stats."""
    from ..monitor import stats_snapshot
    with _REG_LOCK:
        items = list(_METRICS.values())
    out: Dict[str, Any] = {
        "schema": "paddle_tpu.metrics/1",
        "time": time.time(),
        "counters": stats_snapshot(),
        "metrics": [{"name": m.name, "kind": m.kind,
                     "labels": dict(m.labels), **m.snapshot()}
                    for m in items],
    }
    if include_serving:
        from ..profiler import serving_stats
        out["serving"] = serving_stats()
    return out


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _prom_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in sorted(labels.items()):
        v = str(v).replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n")
        parts.append(f'{_prom_name(str(k))}="{v}"')
    return "{" + ",".join(parts) + "}"


def _prom_num(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def prometheus_text(prefix: str = "paddle_tpu") -> str:
    """Prometheus text exposition (v0.0.4) of the full registry."""
    from ..monitor import stats_snapshot
    lines: List[str] = []
    typed: set = set()

    def head(name, kind):
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for name, value in sorted(stats_snapshot().items()):
        pname = f"{prefix}_{_prom_name(name)}"
        head(pname, "counter")
        lines.append(f"{pname} {_prom_num(value)}")
    with _REG_LOCK:
        items = list(_METRICS.values())
    for m in sorted(items, key=lambda m: (m.name, m.labels)):
        pname = f"{prefix}_{_prom_name(m.name)}"
        lbl = _prom_labels(dict(m.labels))
        if m.kind == "histogram":
            head(pname, "histogram")
            snap = m.snapshot()
            base = dict(m.labels)
            for b, cum in snap["buckets"]:
                lines.append(
                    f"{pname}_bucket"
                    f"{_prom_labels(dict(base, le=_prom_num(b)))} {cum}")
            lines.append(
                f"{pname}_bucket{_prom_labels(dict(base, le='+Inf'))} "
                f"{snap['count']}")
            lines.append(f"{pname}_sum{lbl} {_prom_num(snap['sum'])}")
            lines.append(f"{pname}_count{lbl} {snap['count']}")
        else:
            head(pname, m.kind)
            lines.append(f"{pname}{lbl} {_prom_num(m.snapshot()['value'])}")
    # serving tier: live engine stats as gauges labeled by engine index
    from ..profiler import serving_stats
    for i, stats in enumerate(serving_stats()):
        for k, v in stats.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            pname = f"{prefix}_serving_{_prom_name(k)}"
            head(pname, "gauge")
            lines.append(f"{pname}{_prom_labels({'engine': i})} "
                         f"{_prom_num(v)}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Stdlib scrape endpoint: ``/metrics`` (Prometheus text) and
    ``/metrics.json`` (snapshot).  Daemon-threaded; ``close()`` stops."""

    def __init__(self, port: int = 0, addr: str = "127.0.0.1"):
        import http.server

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(h):
                try:
                    if h.path.startswith("/metrics.json"):
                        body = json.dumps(metrics_snapshot()).encode()
                        ctype = "application/json"
                    elif h.path.startswith("/metrics"):
                        body = prometheus_text().encode()
                        ctype = "text/plain; version=0.0.4"
                    else:
                        h.send_error(404)
                        return
                except Exception as e:   # noqa: BLE001 — scrape must 500
                    h.send_error(500, str(e))
                    return
                h.send_response(200)
                h.send_header("Content-Type", ctype)
                h.send_header("Content-Length", str(len(body)))
                h.end_headers()
                h.wfile.write(body)

            def log_message(h, *a):      # silent — it's a scrape target
                pass

        self._httpd = http.server.ThreadingHTTPServer((addr, port), Handler)
        self.addr, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="paddle-tpu-metrics",
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.addr}:{self.port}/metrics"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def serve_metrics(port: int = 0, addr: str = "127.0.0.1") -> MetricsServer:
    return MetricsServer(port, addr)


__all__ = ["counter", "gauge", "histogram", "Counter", "Gauge",
           "Histogram", "metrics_snapshot", "prometheus_text",
           "serve_metrics", "MetricsServer", "reset_metrics",
           "DEFAULT_BUCKETS"]
