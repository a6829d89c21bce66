"""Throughput-oriented serving engine over the inference predictor — the
port of paddle_tpu/serving/engine.py (padded batching; ragged packing, the
persistent executable cache and the fleet come later, see ROADMAP.md).

* **dynamic micro-batching** — ``submit(feed) -> Future``; a worker
  thread coalesces compatible requests under ``max_batch_size`` /
  ``max_wait_ms`` and splits the fetched outputs back per request;
* **shape buckets** — the batch dim pads to ``batch_buckets`` and the
  sequence dim to ``seq_buckets``, so a mixed-shape stream runs at most
  ``len(batch_buckets) x len(seq_buckets)`` distinct shapes.  Padding is
  mask-aware: ``input_mask``-style feeds pad with zeros, so the additive
  attention bias gives padded positions no weight;
* **continuous batching** — while one micro-batch runs on the GPU, the
  worker assembles and dispatches the next behind it (up to
  ``max_inflight_batches``): results are read back through lazy
  ``FetchHandle``s, so host-side assembly overlaps device compute;
* **lifecycle** — ``warmup``, graceful ``drain``/``shutdown`` and a
  per-request ``timeout_ms`` swept across the whole queue every wakeup;
  the idle engine sleeps until notified;
* **stats** — QPS, p50/p99 latency, padding waste, batch histogram,
  also through ``profiler.serving_stats()`` and the metrics export;
* **observability** — each micro-batch is one step on the run-level step
  axis: a flight breadcrumb and the ``serving::pad`` / ``serving::run`` /
  ``serving::split`` spans pinned to its step id (``serving::wait`` spans
  the batching window), a watchdog beacon around its dispatch; the
  ``serving_worker`` drill seam at the top of each worker iteration; a
  flight bundle when a batch's dispatch or completion raises or the
  worker dies.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..framework.errors import (ExecutionTimeoutError, InvalidArgumentError,
                                UnavailableError, UnimplementedError)
from ..observability import flight as _flight
from ..observability import watchdog as _watchdog
from ..observability.tracing import next_step_id, step_scope
from ..profiler import RecordEvent, register_serving_engine
from ..testing import faultline as _faultline
from ..testing.faultline import _ARMED as _FL_ARMED


def _default_batch_buckets(max_batch_size: int) -> Tuple[int, ...]:
    """Power-of-2 ladder covering [1, max_batch_size]."""
    out = []
    b = 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return tuple(out)


class ServingConfig:
    """Engine knobs (the serving analog of AnalysisConfig).

    ``seq_feeds`` names the feeds carrying the sequence dim at axis 1
    (BERT's src_ids/pos_ids/sent_ids/input_mask); ``seq_fetches`` names
    fetches whose axis 1 is sliced back to the request's true length.
    With ``seq_buckets`` empty no sequence padding happens and only
    requests with identical non-batch dims coalesce.

    ``packing``, ``mask_feed`` and ``pack_max_segments`` are taken and
    checked as the JAX package checks them; ``packing=True`` then raises
    :class:`UnimplementedError`, since ragged packing is not ported."""

    def __init__(self, max_batch_size: int = 8,
                 max_wait_ms: float = 2.0,
                 batch_buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Sequence[int] = (),
                 seq_feeds: Sequence[str] = (),
                 seq_fetches: Sequence[str] = (),
                 pad_values: Optional[Dict[str, Any]] = None,
                 timeout_ms: Optional[float] = None,
                 packing: bool = False,
                 mask_feed: Optional[str] = None,
                 pack_max_segments: int = 4,
                 max_inflight_batches: int = 2):
        if max_batch_size < 1:
            raise InvalidArgumentError("max_batch_size must be >= 1")
        self.max_batch_size = int(max_batch_size)
        self.max_wait_ms = float(max_wait_ms)
        if batch_buckets is None:
            batch_buckets = _default_batch_buckets(self.max_batch_size)
        self.batch_buckets = tuple(sorted(int(b) for b in batch_buckets))
        if not self.batch_buckets or \
                self.batch_buckets[-1] < self.max_batch_size:
            raise InvalidArgumentError(
                f"batch_buckets {list(self.batch_buckets)} must cover "
                f"max_batch_size={self.max_batch_size}")
        self.seq_buckets = tuple(sorted(int(s) for s in seq_buckets))
        self.seq_feeds = tuple(seq_feeds)
        self.seq_fetches = tuple(seq_fetches)
        if self.seq_buckets and not self.seq_feeds:
            raise InvalidArgumentError(
                "seq_buckets configured but no seq_feeds named — the "
                "engine cannot tell which feeds carry the sequence dim")
        self.pad_values = dict(pad_values or {})
        self.timeout_ms = timeout_ms
        self.packing = bool(packing)
        self.mask_feed = mask_feed
        self.pack_max_segments = int(pack_max_segments)
        self.max_inflight_batches = max(1, int(max_inflight_batches))
        if self.packing:
            if not self.seq_buckets:
                raise InvalidArgumentError(
                    "packing=True requires seq_buckets — the packed token "
                    "axis needs a bucket ladder to pack into")
            if mask_feed is None or mask_feed not in self.seq_feeds:
                raise InvalidArgumentError(
                    f"packing=True requires mask_feed (one of seq_feeds "
                    f"{list(self.seq_feeds)}) — the feed whose trailing "
                    f"axis carries the one-hot segment channels")
            if self.pack_max_segments < 1:
                raise InvalidArgumentError("pack_max_segments must be >= 1")
            raise UnimplementedError(
                "ServingConfig(packing=True): ragged sequence packing (the "
                "serving engine's segment-channel packing) is not ported "
                "yet; serve with packing=False")

    @property
    def bucket_capacity(self) -> int:
        """Upper bound on distinct batch shapes a mixed stream can run."""
        return len(self.batch_buckets) * max(1, len(self.seq_buckets))


def _pad_axis(v, axis, size, value):
    widths = [(0, 0)] * v.ndim
    widths[axis] = (0, size - v.shape[axis])
    return np.pad(v, widths, constant_values=value)


def pad_request(feed: Dict[str, np.ndarray], seq_bucket: Optional[int],
                seq_feeds: Sequence[str],
                pad_values: Optional[Dict[str, Any]] = None,
                batch_bucket: Optional[int] = None
                ) -> Dict[str, np.ndarray]:
    """Pad a single request to its canonical bucket shape — the sequence
    dims (axis 1 of ``seq_feeds``) to ``seq_bucket`` and the batch dim to
    ``batch_bucket`` — exactly the normalization the engine applies, so a
    per-request baseline can reproduce the engine's shapes."""
    pad_values = pad_values or {}
    out = {}
    for name, v in feed.items():
        v = np.asarray(v)
        if seq_bucket is not None and name in seq_feeds and \
                v.shape[1] < seq_bucket:
            v = _pad_axis(v, 1, seq_bucket, pad_values.get(name, 0))
        if batch_bucket is not None and v.shape[0] < batch_bucket:
            v = _pad_axis(v, 0, batch_bucket, pad_values.get(name, 0))
        out[name] = v
    return out


def _plan_bins(row_lens: Sequence[int], capacity: int, max_segments: int,
               max_rows: int):
    """First-fit the per-row sequence lengths into packed rows of
    ``capacity`` tokens with at most ``max_segments`` segments each.
    Returns ``(placements, n_bins)`` — ``placements[i] = (row, offset)``
    for input row i — or None when it doesn't fit in ``max_rows``.  (The
    decode engine's prefill packing; the serving engine's own ragged
    packing is not ported yet.)"""
    bins: List[List[int]] = []     # [used_tokens, n_segments]
    placements = []
    for s in row_lens:
        idx = None
        for i, b in enumerate(bins):
            if b[0] + s <= capacity and b[1] < max_segments:
                idx = i
                break
        if idx is None:
            if len(bins) >= max_rows or s > capacity:
                return None
            bins.append([0, 0])
            idx = len(bins) - 1
        placements.append((idx, bins[idx][0]))
        bins[idx][0] += s
        bins[idx][1] += 1
    return placements, len(bins)


class _Request:
    __slots__ = ("feed", "rows", "seq", "group", "future", "deadline",
                 "t_submit")

    def __init__(self, feed, rows, seq, group, deadline):
        self.feed = feed
        self.rows = rows
        self.seq = seq
        self.group = group
        self.future: Future = Future()
        self.deadline = deadline
        self.t_submit = time.monotonic()


class _Batch:
    """One picked micro-batch, from selection through dispatch to
    completion."""

    __slots__ = ("picked", "bucket_b", "bucket_s", "rows_total", "handles",
                 "step_id")

    def __init__(self, picked, bucket_b, bucket_s, rows_total):
        self.picked = picked
        self.bucket_b = bucket_b
        self.bucket_s = bucket_s
        self.rows_total = rows_total
        self.handles = None
        self.step_id = None


class ServingEngine:
    """Dynamic micro-batcher over an :class:`AnalysisPredictor`.

    ``submit(feed)`` returns a ``concurrent.futures.Future`` resolving to
    the request's fetch list (one np.ndarray per model output); the
    future's ``bucket`` attribute names the (batch, seq) shape it ran at.
    A single worker thread owns the predictor, so submission is safe from
    any number of threads."""

    def __init__(self, predictor, config: Optional[ServingConfig] = None,
                 auto_start: bool = True):
        self.config = config or ServingConfig()
        self._predictor = predictor
        self._feed_names = list(predictor.get_input_names())
        self._fetch_names = list(predictor.get_output_names())
        cfg = self.config
        bad = [n for n in cfg.seq_feeds if n not in self._feed_names]
        if bad:
            raise InvalidArgumentError(
                f"seq_feeds {bad} are not model feeds {self._feed_names}")
        predictor.prepare()          # read-only-state device-resident mode
        self._queue: List[_Request] = []
        self._cond = threading.Condition()
        self._run_lock = threading.Lock()    # serializes warmup vs worker
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._accepting = True
        self._unhealthy: Optional[BaseException] = None
        self._active = 0             # picked batches not yet completed
        self._stats_lock = threading.Lock()
        self._submitted = 0
        self._completed = 0
        self._timed_out = 0
        self._cancelled = 0
        self._failed = 0
        self._batches = 0
        self._latencies_ms: List[float] = []
        self._real_tokens = 0
        self._padded_tokens = 0
        self._batch_hist: Dict[int, int] = {}
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None
        _watchdog.ensure_started()   # hang watchdog (step_deadline_s)
        register_serving_engine(self)
        if auto_start:
            self.start()

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker_loop,
                                            name="serving-engine-worker",
                                            daemon=True)
            self._thread.start()
        return self

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every already-submitted request has completed.
        The engine keeps accepting new work; returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._cond.notify_all()
            while self._queue or self._active:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> bool:
        """Stop the engine.  ``drain=True`` finishes everything queued
        first; ``drain=False`` fails pending requests with
        UnavailableError (batches already dispatched still complete).
        Further ``submit`` calls raise."""
        with self._cond:
            self._accepting = False
            if not drain:
                for req in self._queue:
                    req.future.set_exception(UnavailableError(
                        "serving engine shut down before the request ran"))
                with self._stats_lock:
                    self._cancelled += len(self._queue)
                self._queue.clear()
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            return not self._thread.is_alive()
        if drain:
            # never started: drain inline on the caller's thread
            self._worker_loop()
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- submission -------------------------------------------------------
    def submit(self, feed: Dict[str, Any]) -> Future:
        cfg = self.config
        missing = [n for n in self._feed_names if n not in feed]
        extra = [n for n in feed if n not in self._feed_names]
        if missing or extra:
            raise InvalidArgumentError(
                f"serving request feed mismatch: missing {missing}, "
                f"unexpected {extra}; the model declares "
                f"{self._feed_names}")
        arrs = {n: np.asarray(feed[n]) for n in self._feed_names}
        rows = None
        for n, v in arrs.items():
            if v.ndim < 1:
                raise InvalidArgumentError(
                    f"feed {n!r} is a scalar — serving feeds are "
                    f"batch-major [batch, ...] arrays")
            if rows is None:
                rows = int(v.shape[0])
            elif int(v.shape[0]) != rows:
                raise InvalidArgumentError(
                    f"feed {n!r} has batch dim {v.shape[0]} but other "
                    f"feeds have {rows} — one request must be uniformly "
                    f"batch-major")
        if rows == 0:
            raise InvalidArgumentError("empty request (batch dim 0)")
        if rows > cfg.max_batch_size:
            raise InvalidArgumentError(
                f"request batch {rows} exceeds max_batch_size="
                f"{cfg.max_batch_size} — split it client-side")
        seq = None
        if cfg.seq_buckets:
            lens = set()
            for n in cfg.seq_feeds:
                v = arrs[n]
                if v.ndim < 2:
                    raise InvalidArgumentError(
                        f"seq feed {n!r} must be at least 2-D "
                        f"[batch, seq, ...], got shape {list(v.shape)}")
                lens.add(int(v.shape[1]))
            if len(lens) != 1:
                raise InvalidArgumentError(
                    f"seq feeds disagree on sequence length: {sorted(lens)}")
            seq = lens.pop()
            if seq > cfg.seq_buckets[-1]:
                raise InvalidArgumentError(
                    f"request seq length {seq} exceeds the largest "
                    f"seq bucket {cfg.seq_buckets[-1]}")
        deadline = None
        if cfg.timeout_ms is not None:
            deadline = time.monotonic() + cfg.timeout_ms / 1e3
        req = _Request(arrs, rows, seq, self._group_key(arrs), deadline)
        with self._cond:
            if self._unhealthy is not None:
                raise UnavailableError(
                    f"serving engine is unhealthy — its worker died with "
                    f"{self._unhealthy!r}; restart the engine")
            if not self._accepting:
                raise UnavailableError("serving engine is shut down")
            self._queue.append(req)
            self._cond.notify_all()
        with self._stats_lock:
            self._submitted += 1
            if self._t_first_submit is None:
                self._t_first_submit = req.t_submit
        return req.future

    def _group_key(self, arrs):
        """Requests coalesce only within a group: same feeds/dtypes/ranks
        and same non-batch dims, the (bucketed-away) sequence axis
        wildcarded."""
        cfg = self.config
        items = []
        for n in self._feed_names:
            v = arrs[n]
            dims = list(v.shape[1:])
            if cfg.seq_buckets and n in cfg.seq_feeds:
                dims[0] = -1
            items.append((n, str(v.dtype), v.ndim, tuple(dims)))
        return tuple(items)

    # -- worker -----------------------------------------------------------
    def _worker_loop(self):
        """Worker thread entry.  An exception escaping the per-batch
        recovery fails every queued and in-flight future and marks the
        engine unhealthy, so no future is left pending and later
        ``submit`` calls raise at once."""
        inflight: List[_Batch] = []
        try:
            while True:
                if _FL_ARMED:
                    # drill seam: an uncaught worker exception, outside
                    # the per-batch recovery
                    _faultline.crossing("serving_worker")
                if len(inflight) >= self.config.max_inflight_batches:
                    self._complete(inflight.pop(0))
                    continue
                got = self._next_batch(block=not inflight)
                if got is None:                  # stop, queue drained
                    break
                if isinstance(got, _Batch):
                    _watchdog.begin("serving")
                    try:
                        batch = self._dispatch(got)
                    finally:
                        _watchdog.end("serving")
                    if batch is not None:
                        inflight.append(batch)
                elif inflight:
                    self._complete(inflight.pop(0))
            while inflight:
                self._complete(inflight.pop(0))
        except BaseException as e:   # noqa: BLE001 — worker last line
            self._worker_fatal(e, inflight)

    def _worker_fatal(self, exc: BaseException, inflight: List[_Batch]):
        _flight.dump("serving_worker_fatal", exc=exc,
                     extra={"pending": len(self._queue),
                            "inflight": len(inflight)})
        failed = 0
        with self._cond:
            self._unhealthy = exc
            self._accepting = False
            self._stop = True
            victims = [r for b in inflight for r in b.picked] + \
                list(self._queue)
            self._queue.clear()
            self._active = 0
            for req in victims:
                if not req.future.done():
                    req.future.set_exception(UnavailableError(
                        f"serving engine worker died: {exc!r}"))
                    failed += 1
            self._cond.notify_all()
        with self._stats_lock:
            self._failed += failed

    def _earliest_deadline(self):
        ds = [r.deadline for r in self._queue if r.deadline is not None]
        return min(ds) if ds else None

    def _next_batch(self, block: bool = True):
        """Select the next micro-batch.  Returns a :class:`_Batch`, ``[]``
        when there is nothing to pick right now (only with
        ``block=False``, the continuous-batching probe behind an
        in-flight batch), or None once stopped with an empty queue.
        Every wakeup sweeps request deadlines across the whole queue."""
        cfg = self.config
        expired: List[Tuple[_Request, float]] = []
        batch = None

        def sweep(now):
            for r in list(self._queue):
                if r.deadline is not None and now > r.deadline:
                    self._queue.remove(r)
                    expired.append((r, now))

        with self._cond:
            while True:
                sweep(time.monotonic())
                if self._stop and not self._queue:
                    batch = None
                    break
                if not self._queue:
                    if expired or not block:
                        batch = []
                        break
                    self._cond.wait()
                    continue
                first = self._queue[0]
                if block and not self._stop:
                    close_at = first.t_submit + cfg.max_wait_ms / 1e3
                    with RecordEvent("serving::wait"):
                        restart = self._wait_window(first, close_at, sweep)
                    if restart:
                        continue
                    sweep(time.monotonic())
                    if not self._queue:
                        continue
                    first = self._queue[0]
                batch = self._pick(first.group)
                if batch is None:
                    batch = []
                    break
                self._active += 1
                break
        for req, now in expired:
            req.future.set_exception(ExecutionTimeoutError(
                f"request spent "
                f"{(now - req.t_submit) * 1e3:.1f} ms queued > "
                f"timeout_ms={cfg.timeout_ms}"))
        if expired:
            with self._stats_lock:
                self._timed_out += len(expired)
            with self._cond:
                self._cond.notify_all()      # drain() watches the queue
        return batch

    def _wait_window(self, first, close_at, sweep) -> bool:
        """Hold the batching window open (queue lock held) until the
        head's group fills a batch, the window closes or a deadline
        falls due; True when the head expired meanwhile."""
        cfg = self.config
        while not self._stop:
            now = time.monotonic()
            sweep(now)
            if first not in self._queue:
                return True          # head expired: new head
            avail = sum(r.rows for r in self._queue
                        if r.group == first.group)
            if avail >= cfg.max_batch_size:
                return False
            until = close_at
            dl = self._earliest_deadline()
            if dl is not None and dl < until:
                until = dl
            remaining = until - now
            if remaining <= 0:
                return False
            self._cond.wait(remaining)
        return False

    def _pick(self, group) -> Optional[_Batch]:
        """Select queued requests of ``group`` into one batch (queue lock
        held).  The scan continues past a request that would overflow, so
        a later smaller request is not blocked behind a big one."""
        cfg = self.config
        picked: List[_Request] = []
        rows = 0
        for req in list(self._queue):
            if req.group != group:
                continue
            if rows + req.rows > cfg.max_batch_size:
                continue
            self._queue.remove(req)
            picked.append(req)
            rows += req.rows
        if not picked:
            return None
        bucket_b = next(b for b in cfg.batch_buckets if b >= rows)
        bucket_s = None
        if cfg.seq_buckets:
            seq_max = max(r.seq for r in picked)
            bucket_s = next(s for s in cfg.seq_buckets if s >= seq_max)
        return _Batch(picked, bucket_b, bucket_s, rows)

    # -- dispatch / completion (pipelined) --------------------------------
    def _fail_batch(self, batch: _Batch, exc: BaseException):
        for req in batch.picked:
            if not req.future.done():
                req.future.set_exception(exc)
        with self._stats_lock:
            self._failed += len(batch.picked)

    def _dispatch(self, batch: _Batch) -> Optional[_Batch]:
        """Assemble + dispatch one batch; the GPU works on it while the
        worker loops back for the next one."""
        batch.step_id = next_step_id()
        _flight.note_step(batch.step_id, "serving_batch",
                          (batch.bucket_b, batch.bucket_s))
        try:
            with step_scope(batch.step_id):
                with RecordEvent("serving::pad",
                                 requests=len(batch.picked)):
                    feed = self._assemble(batch.picked, batch.rows_total,
                                          batch.bucket_b, batch.bucket_s)
                with RecordEvent("serving::run",
                                 bucket=f"{batch.bucket_b}x"
                                        f"{batch.bucket_s}"), \
                        self._run_lock:
                    batch.handles = self._predictor.run_feed_async(feed)
        except Exception as e:   # noqa: BLE001 — routed to the futures
            _flight.dump("serving_dispatch_exception", exc=e,
                         extra={"step": batch.step_id,
                                "bucket": (batch.bucket_b, batch.bucket_s),
                                "requests": len(batch.picked)})
            self._fail_batch(batch, e)
            with self._cond:
                self._active -= 1
                self._cond.notify_all()
            return None
        return batch

    def _complete(self, batch: _Batch):
        """Materialize one in-flight batch's results and route them back
        per request."""
        try:
            with step_scope(batch.step_id), RecordEvent("serving::split"):
                outs = [h.numpy() for h in batch.handles]
                self._split_padded(batch, outs)
        except Exception as e:   # noqa: BLE001 — routed to the futures
            _flight.dump("serving_complete_exception", exc=e,
                         extra={"step": batch.step_id,
                                "bucket": (batch.bucket_b, batch.bucket_s),
                                "requests": len(batch.picked)})
            self._fail_batch(batch, e)
        else:
            done = time.monotonic()
            with self._stats_lock:
                self._completed += len(batch.picked)
                self._batches += 1
                self._batch_hist[batch.rows_total] = \
                    self._batch_hist.get(batch.rows_total, 0) + 1
                for req in batch.picked:
                    self._latencies_ms.append((done - req.t_submit) * 1e3)
                    self._real_tokens += req.rows * (req.seq or 1)
                self._padded_tokens += batch.bucket_b * (batch.bucket_s or 1)
                self._t_last_done = done
                if len(self._latencies_ms) > 100000:
                    del self._latencies_ms[:50000]
        finally:
            with self._cond:
                self._active -= 1
                self._cond.notify_all()

    def _split_padded(self, batch: _Batch, outs):
        cfg = self.config
        off = 0
        for req in batch.picked:
            res = []
            for name, o in zip(self._fetch_names, outs):
                piece = o[off:off + req.rows]
                if batch.bucket_s is not None and \
                        name in cfg.seq_fetches and piece.ndim >= 2:
                    piece = piece[:, :req.seq]
                res.append(np.ascontiguousarray(piece))
            off += req.rows
            # the canonical shape this request ran at: a lone run of
            # pad_request(feed, *bucket) reproduces it
            req.future.bucket = (batch.bucket_b, batch.bucket_s)
            req.future.set_result(res)

    def _assemble(self, picked, rows_total, bucket_b, bucket_s):
        cfg = self.config
        feed = {}
        for n in self._feed_names:
            parts = []
            for req in picked:
                v = req.feed[n]
                if bucket_s is not None and n in cfg.seq_feeds and \
                        v.shape[1] < bucket_s:
                    v = _pad_axis(v, 1, bucket_s, cfg.pad_values.get(n, 0))
                parts.append(v)
            stack = parts[0] if len(parts) == 1 else \
                np.concatenate(parts, axis=0)
            if rows_total < bucket_b:
                # filler rows carry the pad value; their outputs are
                # dropped at split time
                stack = _pad_axis(stack, 0, bucket_b,
                                  cfg.pad_values.get(n, 0))
            feed[n] = stack
        return feed

    # -- warmup -----------------------------------------------------------
    def _combo_feed(self, ex: Dict[str, np.ndarray], bb: int,
                    sb: Optional[int]) -> Dict[str, np.ndarray]:
        """The canonical feed for one (batch bucket, seq bucket) combo."""
        cfg = self.config
        feed = {}
        for n in self._feed_names:
            v = ex[n][:1]
            if sb is not None and n in cfg.seq_feeds:
                v = v[:, :sb]
                if v.shape[1] < sb:
                    v = _pad_axis(v, 1, sb, cfg.pad_values.get(n, 0))
            feed[n] = np.concatenate([v] * bb, axis=0) if bb > 1 else v
        return feed

    def warmup(self, example_feed: Dict[str, Any],
               combos: Optional[Sequence[Tuple[int, Optional[int]]]] = None
               ) -> int:
        """Run every configured (batch bucket x seq bucket) combo once from
        one example request, so the first live requests find the CUDA
        kernels built and loaded and the allocator warm.  Returns the
        combo count."""
        ex = {n: np.asarray(v) for n, v in example_feed.items()}
        missing = [n for n in self._feed_names if n not in ex]
        if missing:
            raise InvalidArgumentError(
                f"warmup example missing feeds {missing}")
        cfg = self.config
        if combos is None:
            combos = [(bb, sb) for bb in cfg.batch_buckets
                      for sb in (cfg.seq_buckets or (None,))]
        for bb, sb in combos:
            with self._run_lock:
                self._predictor.run_feed(self._combo_feed(ex, bb, sb))
        return len(combos)

    # -- observability ----------------------------------------------------
    @staticmethod
    def _pct(sorted_lat, q):
        if not sorted_lat:
            return 0.0
        idx = min(len(sorted_lat) - 1, int(q * len(sorted_lat)))
        return sorted_lat[idx]

    def stats(self) -> Dict[str, Any]:
        """Snapshot of the serving counters."""
        with self._stats_lock:
            lat = sorted(self._latencies_ms)
            elapsed = None
            if self._t_first_submit is not None and \
                    self._t_last_done is not None:
                elapsed = max(self._t_last_done - self._t_first_submit,
                              1e-9)
            out = {
                "submitted": self._submitted,
                "completed": self._completed,
                "timed_out": self._timed_out,
                "cancelled": self._cancelled,
                "failed": self._failed,
                "batches": self._batches,
                "qps": (self._completed / elapsed) if elapsed else 0.0,
                "p50_ms": self._pct(lat, 0.50),
                "p99_ms": self._pct(lat, 0.99),
                "mean_ms": (sum(lat) / len(lat)) if lat else 0.0,
                "padding_waste": (1.0 - self._real_tokens /
                                  self._padded_tokens)
                if self._padded_tokens else 0.0,
                "batch_size_hist": dict(self._batch_hist),
            }
        out["compile_count"] = self._predictor.compiled_executables
        with self._cond:
            out["pending"] = len(self._queue)
            out["inflight"] = self._active
            out["unhealthy"] = self._unhealthy is not None
        return out


__all__ = ["ServingConfig", "ServingEngine", "pad_request"]
