"""Autoregressive decode engine — the port of paddle_tpu/serving/decode.py:
paged KV-cache, continuous token-level batching, prefill / decode split
programs, device-chained decode, sampling, cross-request prefix caching
and chunked prefill.

* **paged/block KV-cache** — one preallocated pool of fixed-size blocks
  per layer per K/V (``[num_blocks, block_size, hidden]`` persistables);
  sequences own int32 block tables, attention reads through the table
  (``fused_attention``'s cache variant, on the ``cached_flash_attention``
  route: the flash forward kernel on the gathered context, decode steps
  included), and ``cache_write`` appends through host-computed flat slot
  ids, in place on the pools.  Admission prices :func:`blocks_needed` per
  request before it queues;
* **continuous batching at token granularity** — the worker runs a
  scheduling round per chain: finished sequences retire and free their
  blocks at once, waiting prefills slot in the same round, and the chain
  batches every live sequence into the next batch bucket.  Prefill packs
  several prompts into a row as segments (one-hot mask channels make the
  attention bias block-diagonal; causal masking composes per segment);
* **prefill / decode split programs** — a bucketed prefill (batch x seq
  buckets: writes cache blocks, emits each segment's first token) and one
  chained decode program per chain length, each a prepared step that owns
  the shared scope state in turn (``_acquire``);
* **device-chained decode** — the ``decode_chain`` marker op
  (``executor.lower_decode_chain``): next-token feedback, cache writes,
  block-table walking and per-row EOS / length masks stay on the device,
  and the host fetches one packed ``[chain, B]`` token matrix per chain.
  The scheduler takes the short chain when admittable work is waiting,
  else the smallest chain covering the longest remaining budget.
  Sampling rows (``DecodeConfig(sampling=True)``) draw on the device with
  per-request keys (ops/sampling_ops.py), deterministic under a seed;
* **cross-request prefix caching** — completed prefills promote their full
  prompt blocks into a content-hash index over the same pool; a new
  request charges admission only for its non-shared suffix, reuses the
  hit blocks by reference and prefills only the suffix; refcount-0 index
  blocks are evictable LRU-first, never a block a live sequence holds;
* **chunked prefill** — suffix (and, with ``chunk_tokens`` set, long)
  prompts prefill in fixed-width chunks through a cache-reading program
  (absolute positions feed the per-query causal bound, ``QPos``), one
  chunk per scheduling round, so a long prompt interleaves with live
  decode chains.  Only the final chunk syncs to the host;
* **bit-parity contract** — every sequence matches its unbatched greedy
  reference (:meth:`DecodeEngine.greedy_reference`, the full-prefix loop
  on an isolated weight snapshot) token for token, however it was
  co-batched, delayed or placed into reused blocks: masked cache reads
  contribute exact zeros (cache_ops.ctx_len_bias).

Each prefill batch, chunk and chain is one step on the run-level step
axis: a flight breadcrumb, a ``decode::prefill`` / ``decode::chunk`` /
``decode::chain`` span pinned to its step id, and a watchdog beacon;
each scheduling round sets the ``decode::*`` gauges (cache blocks in use,
live sequences, prefix-cache hits / misses / bytes saved) and crosses the
``serving_decode`` drill seam; a worker that dies dumps a flight bundle.

Left out: the persistent AOT cache (a warm restart has nothing
compiled to load: the kernels are built once per checkout) and
``verify_decode`` (the static tier).  ``DecodeConfig(hbm_budget_gb=...)``
sizes the pool through ``memory_analysis.plan_cache_pool`` (the static
estimate of a probe decode program at the largest batch bucket), as the
JAX engine does.  ``stats()`` has no ``compile_count``: nothing is compiled
per shape.  :meth:`DecodeEngine.set_params` carries weights in by name
(numpy arrays, e.g. the JAX package's engine's).
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..framework.core import CUDAPlace
from ..framework.errors import InvalidArgumentError, UnavailableError
from ..framework.executor import Executor, Scope
from ..flags import flag
from ..io import convert_params
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..observability import watchdog as _watchdog
from ..observability.tracing import next_step_id, step_scope
from ..profiler import RecordEvent
from ..testing import faultline as _faultline
from ..testing.faultline import _ARMED as _FL_ARMED
from ..ops.tensor_ops import torch_dtype
from .engine import _plan_bins


def blocks_needed(prompt_len: int, max_new_tokens: int,
                  block_size: int) -> int:
    """Cache blocks one sequence needs END-TO-END (prompt + every token
    it may generate) — the admission unit.  Reserved in full at admit
    time, so a mid-generation sequence can never stall on an empty
    pool."""
    total = int(prompt_len) + int(max_new_tokens)
    return -(-total // int(block_size))


def _pow2_buckets(n: int) -> Tuple[int, ...]:
    out, b = [], 1
    while b < n:
        out.append(b)
        b *= 2
    out.append(int(n))
    return tuple(out)


class DecodeConfig:
    """Decode-engine knobs.

    ``pool_blocks=None`` sizes the pool at full occupancy
    (``max_batch_size * max_blocks_per_seq``), or, with ``hbm_budget_gb``
    (or ``flag("hbm_budget_gb")``) set, at what the budget affords after
    the weights and the working set (``memory_analysis.plan_cache_pool``
    on a probe decode program, at engine start).  ``prefix_reserve_blocks``
    (>= 0) is headroom a budgeted pool keeps for the prefix cache: the
    engine refuses to start when fewer than one sequence's blocks plus
    the reserve fit."""

    def __init__(self, block_size: int = 8,
                 max_seq_len: int = 64,
                 max_batch_size: int = 8,
                 batch_buckets: Optional[Sequence[int]] = None,
                 prefill_seq_buckets: Sequence[int] = (16, 32, 64),
                 prefill_batch_buckets: Optional[Sequence[int]] = None,
                 pack_max_segments: int = 4,
                 pool_blocks: Optional[int] = None,
                 max_new_tokens: int = 16,
                 eos_token_id: Optional[int] = None,
                 hbm_budget_gb: Optional[float] = None,
                 chain_lengths: Sequence[int] = (1, 4),
                 prefix_cache: bool = True,
                 chunk_tokens: Optional[int] = None,
                 sampling: bool = False,
                 prefix_reserve_blocks: int = 0):
        if block_size < 1:
            raise InvalidArgumentError("block_size must be >= 1")
        if max_batch_size < 1:
            raise InvalidArgumentError("max_batch_size must be >= 1")
        self.block_size = int(block_size)
        self.max_seq_len = int(max_seq_len)
        self.max_batch_size = int(max_batch_size)
        self.batch_buckets = tuple(sorted(
            int(b) for b in (batch_buckets or
                             _pow2_buckets(self.max_batch_size))))
        if self.batch_buckets[-1] < self.max_batch_size:
            raise InvalidArgumentError(
                f"batch_buckets {list(self.batch_buckets)} must cover "
                f"max_batch_size={self.max_batch_size}")
        self.prefill_seq_buckets = tuple(sorted(
            int(s) for s in prefill_seq_buckets))
        if not self.prefill_seq_buckets:
            raise InvalidArgumentError(
                "prefill_seq_buckets must name at least one bucket")
        self.prefill_batch_buckets = tuple(sorted(
            int(b) for b in (prefill_batch_buckets or
                             _pow2_buckets(self.max_batch_size))))
        self.pack_max_segments = int(pack_max_segments)
        if self.pack_max_segments < 1:
            raise InvalidArgumentError("pack_max_segments must be >= 1")
        self.pool_blocks = pool_blocks
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.chain_lengths = tuple(sorted(
            {int(v) for v in chain_lengths}))
        if not self.chain_lengths or self.chain_lengths[0] < 1:
            raise InvalidArgumentError(
                f"chain_lengths {list(chain_lengths)} must name at "
                f"least one length >= 1")
        self.prefix_cache = bool(prefix_cache)
        self.chunk_tokens = int(chunk_tokens) if chunk_tokens else None
        if self.chunk_tokens is not None and self.chunk_tokens < 1:
            raise InvalidArgumentError("chunk_tokens must be >= 1")
        self.sampling = bool(sampling)
        self.hbm_budget_gb = hbm_budget_gb
        self.prefix_reserve_blocks = int(prefix_reserve_blocks)
        if self.prefix_reserve_blocks < 0:
            raise InvalidArgumentError(
                "prefix_reserve_blocks must be >= 0")

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_seq_len // self.block_size)

    @property
    def chunk_width(self) -> int:
        """Token width of one prefill chunk (the chunked-prefill
        program's fixed [1, C] shape)."""
        return int(self.chunk_tokens or self.prefill_seq_buckets[-1])


class GenerationResult:
    """What a generation future resolves to."""

    __slots__ = ("tokens", "prompt_len", "finish_reason", "steps")

    def __init__(self, tokens, prompt_len, finish_reason, steps):
        self.tokens = np.asarray(tokens, dtype=np.int64)
        self.prompt_len = int(prompt_len)
        self.finish_reason = finish_reason      # "length" | "eos"
        self.steps = int(steps)                 # decode steps it rode

    def __repr__(self):
        return (f"GenerationResult(tokens={self.tokens.tolist()}, "
                f"prompt_len={self.prompt_len}, "
                f"finish_reason={self.finish_reason!r})")


class _Seq:
    __slots__ = ("prompt", "max_new", "eos", "future", "on_token",
                 "block_ids", "pos", "out_tokens", "done", "reason",
                 "t_submit", "steps", "_gather_idx", "waited_rounds",
                 "temperature", "top_k", "top_p", "seed", "hit_blocks",
                 "_chunk_off")

    def __init__(self, prompt, max_new, eos, on_token,
                 temperature=0.0, top_k=0, top_p=0.0, seed=0):
        self.prompt = prompt
        self.max_new = max_new
        self.eos = eos
        self.future: Future = Future()
        self.on_token = on_token
        self.block_ids: List[int] = []
        self.pos = 0                   # tokens currently in cache
        self.out_tokens: List[int] = []
        self.done = False
        self.reason = "length"
        self.t_submit = time.monotonic()
        self.steps = 0
        self._gather_idx = 0
        self.waited_rounds = 0
        self.temperature = float(temperature)   # <= 0 means greedy
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.hit_blocks = 0            # leading blocks shared by ref
        self._chunk_off = 0            # prompt tokens already in cache


class _PrefixIndex:
    """Cross-request KV prefix cache: a content-hash index over FULL
    blocks of the engine's one pool.

    A key is ``sha256(layout_key + prompt[:(j+1)*block_size])`` — the
    model/layout identity plus the EXACT token prefix the block closes,
    so two requests share block ``j`` iff every token up to and
    including that block matches and the bytes in the pool mean the
    same thing (same parameters, same block geometry).  Entries are
    refcounted: a probe hit or a promotion holds one reference per
    user, retirement releases it, and only refcount-0 entries are
    evictable (LRU-first — a hit refreshes recency).  An indexed block
    at refcount 0 is *effectively free*: admission counts it as
    available and :meth:`evict_one` hands it out, which is what lets
    suffix-priced admission admit where full-span pricing would wait
    forever."""

    def __init__(self, layout_key: str, block_size: int,
                 block_bytes: int):
        from collections import OrderedDict
        self._layout = layout_key.encode("utf-8")
        self._bs = int(block_size)
        self.block_bytes = int(block_bytes)
        self._entries: "OrderedDict[bytes, list]" = OrderedDict()
        self._by_block: Dict[int, bytes] = {}
        self.hits = 0
        self.misses = 0
        self.bytes_saved = 0
        self.evictions = 0

    def _key(self, prompt: np.ndarray, j: int) -> bytes:
        import hashlib
        data = self._layout + \
            np.ascontiguousarray(prompt[:(j + 1) * self._bs],
                                 dtype=np.int64).tobytes()
        return hashlib.sha256(data).digest()

    def shareable_blocks(self, prompt_len: int) -> int:
        """FULL blocks of the prompt a hit may cover — the last prompt
        token is always recomputed (prefill must emit the first
        generated token), so the shareable span stops one token short."""
        return (int(prompt_len) - 1) // self._bs

    def probe(self, prompt: np.ndarray, prompt_len: int) -> List[int]:
        """Consecutive hit blocks from block 0, each ACQUIRED (one ref
        held by the caller until release/retire)."""
        out: List[int] = []
        for j in range(self.shareable_blocks(prompt_len)):
            key = self._key(prompt, j)
            ent = self._entries.get(key)
            if ent is None:
                break
            ent[1] += 1
            self._entries.move_to_end(key)
            out.append(ent[0])
        return out

    def promote(self, prompt: np.ndarray, j: int, block_id: int) -> bool:
        """Index one freshly-prefilled full block (the promoting
        sequence holds the initial reference).  A racing identical
        prompt already holds the key — its twin's block stays private."""
        key = self._key(prompt, j)
        if key in self._entries:
            return False
        self._entries[key] = [int(block_id), 1]
        self._by_block[int(block_id)] = key
        return True

    def contains_block(self, block_id: int) -> bool:
        return int(block_id) in self._by_block

    def release_block(self, block_id: int):
        self._entries[self._by_block[int(block_id)]][1] -= 1

    def release(self, block_ids: Sequence[int]):
        for bid in block_ids:
            self.release_block(bid)

    def evictable(self) -> int:
        return sum(1 for ent in self._entries.values() if ent[1] == 0)

    def evict_one(self) -> Optional[int]:
        """Pop the least-recently-used refcount-0 entry and hand its
        block back; an entry anybody still references is untouchable."""
        victim = None
        for key, ent in self._entries.items():
            if ent[1] == 0:
                victim = key
                break
        if victim is None:
            return None
        bid = self._entries.pop(victim)[0]
        del self._by_block[bid]
        self.evictions += 1
        return bid

    def __len__(self):
        return len(self._entries)


class DecodeEngine:
    """Continuous-batching generation over a paged KV-cache.

    ::

        model = BertDecoder(cfg)
        engine = DecodeEngine(model, DecodeConfig(
            block_size=8, max_seq_len=64, max_batch_size=8,
            prefill_seq_buckets=(16, 32)))
        engine.warmup()                       # run every feed shape once
        fut = engine.generate({"src_ids": prompt}, max_new_tokens=16)
        result = fut.result()                 # GenerationResult
        engine.shutdown()

    One worker thread owns the device: each scheduling round retires
    finished sequences (freeing their blocks), admits waiting prefills
    that fit the pool, and runs one decode chain over every live
    sequence.  ``place=None`` runs on ``CUDAPlace(0)`` and raises without
    a GPU, as ``Executor()`` does; tests pass ``CPUPlace()``."""

    def __init__(self, model, config: Optional[DecodeConfig] = None,
                 place=None, auto_start: bool = True):
        self.config = cfg = config or DecodeConfig()
        self.model = model
        mcfg = model.cfg
        if cfg.max_seq_len > mcfg.max_position_embeddings:
            raise InvalidArgumentError(
                f"max_seq_len={cfg.max_seq_len} exceeds the model's "
                f"max_position_embeddings={mcfg.max_position_embeddings}")
        self._mbps = cfg.max_blocks_per_seq

        # -- pool sizing (the static estimate is the admission model) --
        budget = cfg.hbm_budget_gb
        if budget is None:
            budget = float(flag("hbm_budget_gb") or 0.0)
        self.pool_plan: Dict[str, Any] = {}
        pool_blocks = cfg.pool_blocks
        if pool_blocks is None:
            pool_blocks = self._plan_pool(budget) if budget else \
                cfg.max_batch_size * self._mbps
        if pool_blocks < 1:
            raise InvalidArgumentError(
                f"pool_blocks={pool_blocks} — the paged cache needs at "
                f"least one block")
        # a pool smaller than one max-length sequence is legal (requests
        # that cannot fit are rejected per request at generate())
        self.pool_blocks = int(pool_blocks)

        # -- programs + state ------------------------------------------
        need_chunk = cfg.prefix_cache or cfg.chunk_tokens
        self._programs = model.build(
            self.pool_blocks, cfg.block_size, self._mbps,
            cfg.pack_max_segments, chain_lengths=cfg.chain_lengths,
            with_sampling=cfg.sampling,
            chunk_tokens=cfg.chunk_width if need_chunk else None)
        self._exe = Executor(place if place is not None else CUDAPlace(0))
        self._scope = Scope()
        self._exe.run(self._programs.startup, scope=self._scope)
        for name in self._programs.cache_vars:
            v = self._programs.decode.global_block().var(name)
            self._scope.set_var(name, torch.zeros(
                tuple(v.shape), dtype=torch_dtype(v.dtype),
                device=self._exe.device))

        # isolated weight snapshot for the reference loop: copies, so the
        # live path (which writes the pools in place) can never touch it
        self._ref_scope = Scope()
        for name in self._scope.var_names():
            v = self._scope.find_var(name)
            if name in self._programs.cache_vars or \
                    not isinstance(v, torch.Tensor):
                continue
            self._ref_scope.set_var(name, v.clone())

        fetches = list(self._programs.fetch_names)
        self._prefill = self._exe.prepare(
            self._programs.prefill,
            feed_names=self._programs.prefill_feeds,
            fetch_list=fetches, scope=self._scope, donate_state=True)
        # all decode stepping runs through the chained programs (a
        # chain of length 1 is the single step); progs.decode also
        # declares the pools' shapes
        self._chains = {
            length: self._exe.prepare(
                prog, feed_names=self._programs.chain_feeds,
                fetch_list=list(self._programs.chain_fetch_names),
                scope=self._scope, donate_state=True)
            for length, prog in self._programs.chains.items()}
        self._chain_lengths = tuple(sorted(self._chains))
        self._chunk = None
        if self._programs.chunk is not None:
            self._chunk = self._exe.prepare(
                self._programs.chunk,
                feed_names=self._programs.chunk_feeds,
                fetch_list=fetches, scope=self._scope,
                donate_state=True)
        self._score = None              # reference path, prepared lazily
        self._owner = None              # which prepared step holds state

        # -- cross-request prefix cache --------------------------------
        self._prefix_index: Optional[_PrefixIndex] = None
        if cfg.prefix_cache:
            layout = getattr(model, "cache_layout_key", None)
            layout_key = layout(cfg.block_size) if layout is not None \
                else f"{getattr(model, 'name', 'model')}" \
                     f"/bs={cfg.block_size}"
            self._prefix_index = _PrefixIndex(
                layout_key, cfg.block_size,
                model.cache_block_bytes(cfg.block_size))

        # -- scheduling state ------------------------------------------
        self._free: List[int] = list(range(self.pool_blocks - 1, -1, -1))
        self._pending: List[_Seq] = []
        self._active: List[_Seq] = []
        self._chunking: List[_Seq] = []
        self._cond = threading.Condition()
        self._run_lock = threading.Lock()   # device rounds vs warmup
        self._ref_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._accepting = True
        self._unhealthy: Optional[BaseException] = None

        self._stats_lock = threading.Lock()
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._rejected = 0
        self._tokens_out = 0
        self._decode_steps = 0
        self._prefill_batches = 0
        self._decode_batch_hist: Dict[int, int] = {}
        self._peak_blocks = 0
        self._block_reuses = 0          # a freed block handed out again
        self._retired_blocks: set = set()
        self._admission_waits = 0
        self._host_syncs = 0            # one per device->host token fetch
        self._chains_run = 0
        self._chain_tokens = 0
        self._chain_hist: Dict[int, int] = {}
        self._chunk_steps = 0
        self._interleaved_rounds = 0    # rounds mixing chunks + chains
        self._prefill_tokens = 0        # prompt tokens actually computed
        self._t_first = None
        self._t_last = None
        _watchdog.ensure_started()
        if auto_start:
            self.start()

    def param_names(self) -> List[str]:
        """The model's parameters: what the startup program initialises
        (the cache pools are state, not parameters)."""
        return [v.name for v in self._programs.startup.list_vars()
                if v.persistable]

    def set_params(self, arrays: Dict[str, Any]):
        """Carry weights in by name — numpy arrays (another engine's
        parameters: the JAX package's, a checkpoint's) converted by
        ``io.convert_params`` onto the engine's device — into both the
        live scope and the :meth:`greedy_reference` snapshot.  The cache
        pools are not touched.  Call it before the engine serves
        (``auto_start=False``, then :meth:`start`)."""
        names = set(self.param_names())
        unknown = sorted(n for n in arrays if n not in names)
        if unknown:
            raise InvalidArgumentError(
                f"set_params: {unknown} are not parameters of this "
                f"engine's programs")
        if self._thread is not None:
            raise InvalidArgumentError(
                "set_params: the engine is already serving; build it with "
                "auto_start=False and call start() after set_params")
        dtypes = {n: self._programs.startup.global_block().var(n).dtype
                  for n in arrays}
        tensors = convert_params(arrays, self._exe.device, dtypes)
        for name, t in tensors.items():
            self._scope.set_var(name, t)
            self._ref_scope.set_var(name, t.clone())

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker_loop,
                                            name="decode-engine-worker",
                                            daemon=True)
            self._thread.start()
        return self

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until every submitted generation resolved (or failed).
        Never hangs on an unhealthy engine — the fatal path resolves
        every future before marking unhealthy."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._cond.notify_all()
            while self._pending or self._active or self._chunking:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> bool:
        with self._cond:
            self._accepting = False
            if not drain:
                for seq in self._pending:
                    seq.future.set_exception(UnavailableError(
                        "decode engine shut down before the request ran"))
                self._pending.clear()
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            return not self._thread.is_alive()
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- submission -------------------------------------------------------
    @staticmethod
    def _normalize_prompt(feed) -> np.ndarray:
        if isinstance(feed, dict):
            if "src_ids" not in feed:
                raise InvalidArgumentError(
                    "generate() feed must carry 'src_ids' (the prompt "
                    "token ids)")
            arr = np.asarray(feed["src_ids"])
        else:
            arr = np.asarray(feed)
        if arr.ndim == 2:
            if arr.shape[0] != 1:
                raise InvalidArgumentError(
                    f"generate() takes ONE sequence per call; got a "
                    f"batch of {arr.shape[0]} — submit them separately, "
                    f"the engine co-batches at token granularity")
            arr = arr[0]
        if arr.ndim != 1 or arr.size == 0:
            raise InvalidArgumentError(
                f"prompt must be a non-empty 1-D (or [1, S]) int array, "
                f"got shape {list(arr.shape)}")
        return arr.astype(np.int64)

    def generate(self, feed, max_new_tokens: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 on_token=None, temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 seed: Optional[int] = None) -> Future:
        """Submit one prompt; returns a Future of
        :class:`GenerationResult`.  ``on_token(token_id)`` (optional)
        streams tokens from the worker thread as they decode.

        ``temperature``/``top_k``/``top_p``/``seed`` select the
        on-device sampling policy (requires
        ``DecodeConfig(sampling=True)``); default/``temperature<=0``
        rows stay greedy and keep the bit-parity contract.  A fixed
        seed draws the same tokens no matter how the request is
        co-batched or chain-scheduled.

        Admission prices :func:`blocks_needed` HERE — a request that can
        never fit the pool (or the model's length budget) is rejected
        immediately, before it queues."""
        cfg = self.config
        if not cfg.sampling and any(
                v is not None for v in (temperature, top_k, top_p, seed)):
            raise InvalidArgumentError(
                "sampling parameters need DecodeConfig(sampling=True) — "
                "this engine's chain programs were built greedy-only")
        prompt = self._normalize_prompt(feed)
        plen = int(prompt.size)
        max_new = cfg.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if max_new < 1:
            raise InvalidArgumentError("max_new_tokens must be >= 1")
        eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
        if plen + max_new > cfg.max_seq_len:
            with self._stats_lock:
                self._rejected += 1
            raise InvalidArgumentError(
                f"prompt ({plen} tokens) + max_new_tokens ({max_new}) "
                f"exceeds max_seq_len={cfg.max_seq_len}")
        if plen > cfg.prefill_seq_buckets[-1] and not cfg.chunk_tokens:
            with self._stats_lock:
                self._rejected += 1
            raise InvalidArgumentError(
                f"prompt length {plen} exceeds the largest prefill "
                f"bucket {cfg.prefill_seq_buckets[-1]} — set "
                f"DecodeConfig(chunk_tokens=...) to prefill long "
                f"prompts in chunks")
        need = blocks_needed(plen, max_new, cfg.block_size)
        if need > self.pool_blocks:
            with self._stats_lock:
                self._rejected += 1
            raise InvalidArgumentError(
                f"admission rejected: the request needs {need} cache "
                f"blocks (prompt {plen} + up to {max_new} new tokens at "
                f"block_size={cfg.block_size}) but the pool holds "
                f"{self.pool_blocks}; shrink the "
                f"request or grow the pool")
        seq = _Seq(prompt, max_new, eos, on_token,
                   temperature=temperature or 0.0, top_k=top_k or 0,
                   top_p=top_p or 0.0, seed=seed or 0)
        with self._cond:
            if self._unhealthy is not None:
                raise UnavailableError(
                    f"decode engine is unhealthy — its worker died with "
                    f"{self._unhealthy!r}; restart the engine")
            if not self._accepting:
                raise UnavailableError("decode engine is shut down")
            self._pending.append(seq)
            self._cond.notify_all()
        with self._stats_lock:
            self._submitted += 1
            if self._t_first is None:
                self._t_first = seq.t_submit
        return seq.future

    # -- worker -----------------------------------------------------------
    def _worker_loop(self):
        try:
            self._loop_inner()
        except BaseException as e:    # noqa: BLE001 — worker last line
            self._worker_fatal(e)

    def _loop_inner(self):
        while True:
            with self._cond:
                while not self._stop and not self._pending \
                        and not self._active and not self._chunking:
                    self._cond.wait()
                if self._stop and not self._pending \
                        and not self._active and not self._chunking:
                    return
            if _FL_ARMED:
                # drill seam: an uncaught decode-worker exception,
                # outside any per-step recovery
                _faultline.crossing("serving_decode")
            with self._run_lock:
                admitted = self._admit()
                if admitted:
                    self._run_prefill(admitted)
                    self._retire()
                if self._chunking:
                    if self._active:
                        with self._stats_lock:
                            self._interleaved_rounds += 1
                    self._chunk_round()
                    self._retire()
                if self._active:
                    self._chain_step()
                    self._retire()
            self._update_gauges()

    def _worker_fatal(self, exc: BaseException):
        """Terminal worker failure: a flight bundle, then every generation
        future fails, every cache block frees, the engine goes
        unhealthy."""
        _flight.dump("decode_worker_fatal", exc=exc,
                     extra={"pending": len(self._pending),
                            "active": len(self._active),
                            "chunking": len(self._chunking)})
        failed = 0
        with self._cond:
            self._unhealthy = exc
            self._accepting = False
            self._stop = True
            victims = list(self._active) + list(self._chunking) \
                + list(self._pending)
            for seq in self._active + self._chunking:
                self._release_blocks(seq)
            self._active = []
            self._chunking = []
            self._pending = []
            for seq in victims:
                if not seq.future.done():
                    seq.future.set_exception(UnavailableError(
                        f"decode engine worker died: {exc!r} — "
                        f"generation failed"))
                    failed += 1
            self._cond.notify_all()
        with self._stats_lock:
            self._failed += failed

    # -- scheduling -------------------------------------------------------
    def _availability(self) -> int:
        """Blocks admission may hand out NOW: the free list plus every
        refcount-0 indexed block (evictable = effectively free)."""
        n = len(self._free)
        if self._prefix_index is not None:
            n += self._prefix_index.evictable()
        return n

    def _take_blocks(self, n: int) -> List[int]:
        """Allocate ``n`` blocks: free list first, then LRU eviction of
        refcount-0 index entries (availability was checked by the
        caller, so eviction cannot come up short)."""
        out: List[int] = []
        for _ in range(n):
            if self._free:
                bid = self._free.pop()
            else:
                bid = self._prefix_index.evict_one()
                if bid is None:
                    raise UnavailableError(
                        "cache pool accounting violated: admission "
                        "priced blocks that are not available")
            if bid in self._retired_blocks:
                with self._stats_lock:
                    self._block_reuses += 1
            out.append(bid)
        return out

    def _release_blocks(self, seq: _Seq):
        """Return a sequence's blocks: indexed blocks drop one reference
        (staying cached, evictable once nobody references them), the
        rest go back to the free list."""
        idx = self._prefix_index
        for bid in reversed(seq.block_ids):
            if idx is not None and idx.contains_block(bid):
                idx.release_block(bid)
            else:
                self._free.append(bid)
        seq.block_ids = []

    def _admit(self) -> List[_Seq]:
        """Pull pending prefills that fit THIS round: decode-slot
        capacity, prefill row/segment capacity, and — the paged-cache
        admission — enough blocks for the sequence's NON-SHARED span
        (prefix-cache hits ride existing blocks by reference and charge
        nothing; full-span pricing would keep a hit-heavy request
        waiting on blocks it never needs).  Continue-scan (head-of-line
        fix): a large request waiting on blocks does not starve smaller
        later ones.  Requests with a prefix hit or an over-bucket
        prompt go to the chunked-prefill queue; the rest return for the
        packed prefill batch."""
        cfg = self.config
        idx = self._prefix_index
        admitted: List[_Seq] = []
        row_lens: List[int] = []
        bucket_s = None
        taken = 0
        with self._cond:
            slots_left = (cfg.max_batch_size - len(self._active)
                          - len(self._chunking))
            for seq in list(self._pending):
                if taken >= slots_left:
                    break
                plen = int(seq.prompt.size)
                need_total = blocks_needed(plen, seq.max_new,
                                           cfg.block_size)
                # probe acquires refs on the hit blocks so a concurrent
                # eviction (for an earlier admit this round) can't free
                # them out from under the pricing below
                hits = idx.probe(seq.prompt, plen) \
                    if idx is not None else []
                need = need_total - len(hits)
                if need > self._availability():
                    if hits:
                        idx.release(hits)
                    seq.waited_rounds += 1
                    with self._stats_lock:
                        self._admission_waits += 1
                    continue
                chunked = bool(hits) or \
                    plen > cfg.prefill_seq_buckets[-1]
                if not chunked:
                    need_s = bucket_s
                    if need_s is None or plen > need_s:
                        need_s = next(s for s in cfg.prefill_seq_buckets
                                      if s >= plen)
                    trial = row_lens + [plen]
                    if _plan_bins(trial, need_s, cfg.pack_max_segments,
                                  cfg.prefill_batch_buckets[-1]) is None:
                        continue
                    row_lens = trial
                    bucket_s = need_s
                self._pending.remove(seq)
                # hit blocks by reference + the suffix span allocated
                # fresh; handing a previously-used block to a new
                # sequence is the reuse case the parity contract covers
                seq.block_ids = list(hits) + self._take_blocks(need)
                seq.hit_blocks = len(hits)
                seq._chunk_off = len(hits) * cfg.block_size
                taken += 1
                if idx is not None:
                    probed = idx.shareable_blocks(plen)
                    idx.hits += len(hits)
                    idx.misses += probed - len(hits)
                    idx.bytes_saved += len(hits) * idx.block_bytes
                with self._stats_lock:
                    self._prefill_tokens += plen - seq._chunk_off
                if chunked:
                    self._chunking.append(seq)
                else:
                    admitted.append(seq)
        return admitted

    def _slot(self, seq: _Seq, p: int) -> int:
        bs = self.config.block_size
        return seq.block_ids[p // bs] * bs + p % bs

    # -- prefill ----------------------------------------------------------
    def _prefill_feed(self, admitted: List[_Seq]):
        cfg = self.config
        K = cfg.pack_max_segments
        plens = [int(s.prompt.size) for s in admitted]
        bucket_s = next(s for s in cfg.prefill_seq_buckets
                        if s >= max(plens))
        plan = _plan_bins(plens, bucket_s, K,
                          cfg.prefill_batch_buckets[-1])
        placements, n_rows = plan
        bucket_b = next(b for b in cfg.prefill_batch_buckets
                        if b >= n_rows)
        src = np.zeros((bucket_b, bucket_s), np.int64)
        pos = np.zeros((bucket_b, bucket_s), np.int64)
        mask = np.zeros((bucket_b, bucket_s, K), np.float32)
        slots = np.full((bucket_b, bucket_s), -1, np.int32)
        last_pos = np.zeros((bucket_b, K), np.int64)
        chan = [0] * bucket_b
        for seq, (row, off) in zip(admitted, placements):
            plen = int(seq.prompt.size)
            ch = chan[row]
            chan[row] += 1
            src[row, off:off + plen] = seq.prompt
            pos[row, off:off + plen] = np.arange(plen)
            mask[row, off:off + plen, ch] = 1.0
            slots[row, off:off + plen] = [self._slot(seq, p)
                                          for p in range(plen)]
            last_pos[row, ch] = off + plen - 1
            seq._gather_idx = row * K + ch
        return ({"src_ids": src, "pos_ids": pos, "input_mask": mask,
                 "slot_ids": slots, "last_pos": last_pos},
                (bucket_b, bucket_s))

    def _acquire(self, prepared):
        """Owner handoff between the prefill and decode prepared steps:
        both donate the shared scope state (weights pass through
        aliased; the cache pools update in place), so the outgoing
        owner's device-resident state flows back through the scope
        (``PreparedStep.sync_scope``, tensors by reference, no copy)
        before the other side pulls it."""
        if self._owner is not None and self._owner is not prepared:
            self._owner.sync_scope()
        self._owner = prepared

    @contextlib.contextmanager
    def _unit(self, kind: str, info, span: str, **attrs):
        """One unit of device work (a prefill batch, a chunk, a chain):
        its own step id, flight breadcrumb, watchdog beacon and span."""
        sid = next_step_id()
        _flight.note_step(sid, kind, info)
        _watchdog.begin("decode")
        try:
            with step_scope(sid), RecordEvent(span, attrs or None):
                yield
        finally:
            _watchdog.end("decode")

    def _run_prefill(self, admitted: List[_Seq]):
        feed, bucket = self._prefill_feed(admitted)
        with self._unit("decode_prefill", bucket, "decode::prefill",
                        requests=len(admitted),
                        bucket=f"{bucket[0]}x{bucket[1]}"):
            self._acquire(self._prefill)
            tokens = self._prefill.run(feed)[1].numpy()
        now = time.monotonic()
        for seq in admitted:
            tok = int(tokens[seq._gather_idx])
            seq.pos = int(seq.prompt.size)
            self._emit(seq, tok)
            self._promote(seq)
        self._active.extend(admitted)
        with self._stats_lock:
            self._prefill_batches += 1
            self._host_syncs += 1
            self._t_last = now

    def _promote(self, seq: _Seq):
        """Index every freshly-written FULL prompt block for
        cross-request reuse.  Only blocks holding nothing but prompt
        tokens qualify ((j+1)*bs <= prompt_len) — generation writes
        start past them, so a promoted block's bytes never change."""
        idx = self._prefix_index
        if idx is None:
            return
        bs = self.config.block_size
        plen = int(seq.prompt.size)
        for j in range(seq.hit_blocks, plen // bs):
            idx.promote(seq.prompt, j, seq.block_ids[j])

    # -- chunked prefill --------------------------------------------------
    def _chunk_round(self):
        """One chunk per chunk-queued sequence per scheduling round —
        long prompts make progress WITHOUT monopolising the device
        between decode chains (the anti-head-of-line interleave)."""
        for seq in list(self._chunking):
            self._chunk_step(seq)

    def _chunk_step(self, seq: _Seq):
        cfg = self.config
        width = cfg.chunk_width
        plen = int(seq.prompt.size)
        start = seq._chunk_off
        end = min(plen, start + width)
        n = end - start
        final = end >= plen
        src = np.zeros((1, width), np.int64)
        src[0, :n] = seq.prompt[start:end]
        pos = np.zeros((1, width), np.int64)
        pos[0, :n] = np.arange(start, end)
        slots = np.full((1, width), -1, np.int32)
        slots[0, :n] = [self._slot(seq, p) for p in range(start, end)]
        table = np.zeros((1, self._mbps), np.int32)
        table[0, :len(seq.block_ids)] = seq.block_ids
        ctx = np.array([end], np.int32)
        last = np.full((1, 1), n - 1 if final else 0, np.int64)
        feed = {"src_ids": src, "pos_ids": pos, "slot_ids": slots,
                "block_table": table, "ctx_len": ctx, "last_pos": last}
        with self._unit("decode_chunk", (start, end), "decode::chunk",
                        tokens=n, final=final):
            self._acquire(self._chunk)
            handles = self._chunk.run(feed)
            # only the final chunk's first generated token crosses to the
            # host; intermediate chunks stay asynchronous
            tok = int(handles[1].numpy()[0]) if final else None
        seq._chunk_off = end
        with self._stats_lock:
            self._chunk_steps += 1
            if final:
                self._host_syncs += 1
            self._t_last = time.monotonic()
        if final:
            seq.pos = plen
            self._emit(seq, tok)
            self._promote(seq)
            self._chunking.remove(seq)
            self._active.append(seq)

    # -- pool sizing --------------------------------------------------------
    def _plan_pool(self, budget_gb: float) -> int:
        """Static pool sizing: a probe decode program (one sequence's
        blocks) priced at the largest batch bucket's pad feeds, the blocks
        the budget affords after it (``plan_cache_pool``) — nothing runs
        and nothing is allocated."""
        from ..framework.memory_analysis import plan_cache_pool
        cfg = self.config
        probe = self.model.build(self._mbps, cfg.block_size, self._mbps,
                                 cfg.pack_max_segments)
        feed = self._decode_feed_arrays(cfg.batch_buckets[-1], [])
        plan = plan_cache_pool(
            probe.decode, feed_shapes=feed,
            fetch_names=probe.fetch_names,
            cache_vars=probe.cache_vars,
            block_bytes=self.model.cache_block_bytes(cfg.block_size),
            budget_gb=budget_gb, min_blocks=self._mbps,
            reserve_blocks=cfg.prefix_reserve_blocks)
        self.pool_plan = {
            "blocks": plan["blocks"],
            "block_bytes": plan["block_bytes"],
            "fixed_bytes": plan["fixed_bytes"],
            "budget_bytes": plan["budget_bytes"],
            "reserve_blocks": plan.get("reserve_blocks", 0),
        }
        return plan["blocks"]

    # -- decode step ------------------------------------------------------
    def _decode_feed_arrays(self, bucket_b: int, live: List[_Seq]):
        """Decode-step feeds of ``live`` in the first rows of a
        ``bucket_b`` batch; the rest are pad rows (slot -1, ctx_len 0)."""
        tok = np.zeros((bucket_b,), np.int64)
        pos = np.zeros((bucket_b,), np.int64)
        slots = np.full((bucket_b, 1), -1, np.int32)
        table = np.zeros((bucket_b, self._mbps), np.int32)
        ctx = np.zeros((bucket_b,), np.int32)
        for i, seq in enumerate(live):
            tok[i] = seq.out_tokens[-1]
            pos[i] = seq.pos
            slots[i, 0] = self._slot(seq, seq.pos)
            table[i, :len(seq.block_ids)] = seq.block_ids
            ctx[i] = seq.pos + 1
        return {"token_ids": tok, "pos_ids": pos, "slot_ids": slots,
                "block_table": table, "ctx_len": ctx}

    def _chain_feed_arrays(self, bucket_b: int, live: List[_Seq]):
        """Chain feeds = decode-step feeds + the per-row chain-control
        vectors (remaining token budget, EOS id, sampling policy).
        Slot/ctx-len entries are placeholders — the device chain
        recomputes them per iteration from the block table."""
        cfg = self.config
        feed = self._decode_feed_arrays(bucket_b, live)
        left = np.zeros((bucket_b,), np.int32)
        eos = np.full((bucket_b,), -1, np.int64)
        for i, seq in enumerate(live):
            left[i] = seq.max_new - len(seq.out_tokens)
            if seq.eos is not None:
                eos[i] = int(seq.eos)
        feed["steps_left"] = left
        feed["eos_ids"] = eos
        if cfg.sampling:
            temp = np.zeros((bucket_b,), np.float32)
            top_k = np.zeros((bucket_b,), np.int32)
            top_p = np.zeros((bucket_b,), np.float32)
            seeds = np.zeros((bucket_b,), np.int32)
            for i, seq in enumerate(live):
                temp[i] = seq.temperature
                top_k[i] = seq.top_k
                top_p[i] = seq.top_p
                seeds[i] = seq.seed
            feed.update({"temperature": temp, "top_k": top_k,
                         "top_p": top_p, "seeds": seeds})
        return feed

    def _pick_chain(self) -> int:
        """Chain-length scheduling: the SHORT chain when admittable
        work is waiting (a pending request that fits blocks + slots, or
        a prompt mid-chunk) so it isn't parked behind a long device
        loop; otherwise the smallest chain covering the longest
        remaining budget — no wasted chain iterations, no extra
        syncs."""
        cfg = self.config
        lengths = self._chain_lengths
        if len(lengths) == 1:
            return lengths[0]
        if self._chunking:
            return lengths[0]
        with self._cond:
            slots_left = (cfg.max_batch_size - len(self._active)
                          - len(self._chunking))
            if slots_left > 0:
                avail = self._availability()
                for seq in self._pending:
                    # full-span pricing here (ignores prefix hits) —
                    # conservative: at worst we chain short once more
                    need = blocks_needed(int(seq.prompt.size),
                                         seq.max_new, cfg.block_size)
                    if need <= avail:
                        return lengths[0]
        remaining = max(seq.max_new - len(seq.out_tokens)
                        for seq in self._active)
        for length in lengths:
            if length >= remaining:
                return length
        return lengths[-1]

    def _chain_step(self):
        """Run ONE device chain over every live sequence: L decode
        steps, one host sync.  -1 entries in the fetched [L, B] matrix
        mark rows that finished mid-chain (the device froze them)."""
        cfg = self.config
        live = self._active
        length = self._pick_chain()
        bucket_b = next(b for b in cfg.batch_buckets if b >= len(live))
        feed = self._chain_feed_arrays(bucket_b, live)
        with self._unit("decode_chain", (length, bucket_b, len(live)),
                        "decode::chain", live=len(live), bucket=bucket_b,
                        chain=length):
            prepared = self._chains[length]
            self._acquire(prepared)
            tokens = prepared.run(feed)[0].numpy()  # [length, bucket_b]
        now = time.monotonic()
        emitted = 0
        for s in range(length):
            for i, seq in enumerate(live):
                tok = int(tokens[s, i])
                if tok < 0:
                    continue
                seq.pos += 1
                seq.steps += 1
                self._emit(seq, tok)
                emitted += 1
        with self._stats_lock:
            self._decode_steps += length
            self._chains_run += 1
            self._host_syncs += 1
            self._chain_tokens += emitted
            self._chain_hist[length] = \
                self._chain_hist.get(length, 0) + 1
            self._decode_batch_hist[len(live)] = \
                self._decode_batch_hist.get(len(live), 0) + 1
            self._t_last = now

    def _emit(self, seq: _Seq, tok: int):
        seq.out_tokens.append(tok)
        with self._stats_lock:
            self._tokens_out += 1
        if seq.on_token is not None:
            try:
                seq.on_token(tok)
            except Exception:      # noqa: BLE001 — user callback
                pass
        if seq.eos is not None and tok == seq.eos:
            seq.done = True
            seq.reason = "eos"
        elif len(seq.out_tokens) >= seq.max_new:
            seq.done = True

    def _retire(self):
        with self._stats_lock:
            in_use = sum(len(s.block_ids)
                         for s in self._active + self._chunking)
            self._peak_blocks = max(self._peak_blocks, in_use)
        finished = [s for s in self._active if s.done]
        if not finished:
            return
        with self._cond:
            self._active = [s for s in self._active if not s.done]
            for seq in finished:
                self._retired_blocks.update(seq.block_ids)
                self._release_blocks(seq)
            self._cond.notify_all()
        for seq in finished:
            seq.future.set_result(GenerationResult(
                seq.out_tokens, int(seq.prompt.size), seq.reason,
                seq.steps))
        with self._stats_lock:
            self._completed += len(finished)

    def _update_gauges(self):
        """The ``decode::*`` gauges on the metrics registry: cache blocks
        in use, live sequences, and the prefix cache's hits, misses and
        bytes saved."""
        _metrics.gauge("decode::cache_blocks_used").set(
            self._blocks_in_use())
        _metrics.gauge("decode::active_seqs").set(
            len(self._active) + len(self._chunking))
        idx = self._prefix_index
        if idx is not None:
            _metrics.gauge("decode::prefix_cache_hits").set(idx.hits)
            _metrics.gauge("decode::prefix_cache_misses").set(idx.misses)
            _metrics.gauge("decode::prefix_cache_bytes_saved").set(
                idx.bytes_saved)

    def _blocks_in_use(self) -> int:
        """Pool blocks some live sequence actually holds: refcount-0
        index entries are cached CONTENT, not usage — they are
        reclaimable on demand, so they count as free."""
        evictable = self._prefix_index.evictable() \
            if self._prefix_index is not None else 0
        return self.pool_blocks - len(self._free) - evictable

    # -- warmup -----------------------------------------------------------
    def warmup(self) -> int:
        """Run every feed shape once from canonical feeds: every prefill
        (batch x seq) bucket, every chain length at every decode batch
        bucket, and the chunk program (the kernels build at their first
        launch).  All warmup writes carry slot -1 / ctx_len 0, so the
        cache pools stay bitwise untouched.  Returns the combo count."""
        cfg = self.config
        K = cfg.pack_max_segments
        n = 0
        with self._run_lock:
            for sb in cfg.prefill_seq_buckets:
                for bb in cfg.prefill_batch_buckets:
                    feed = {
                        "src_ids": np.zeros((bb, sb), np.int64),
                        "pos_ids": np.zeros((bb, sb), np.int64),
                        "input_mask": np.zeros((bb, sb, K), np.float32),
                        "slot_ids": np.full((bb, sb), -1, np.int32),
                        "last_pos": np.zeros((bb, K), np.int64),
                    }
                    self._acquire(self._prefill)
                    self._prefill.run(feed)
                    n += 1
            for length in self._chain_lengths:
                for bb in cfg.batch_buckets:
                    self._acquire(self._chains[length])
                    self._chains[length].run(self._chain_feed_arrays(
                        bb, []))
                    n += 1
            if self._chunk is not None:
                width = cfg.chunk_width
                self._acquire(self._chunk)
                self._chunk.run({
                    "src_ids": np.zeros((1, width), np.int64),
                    "pos_ids": np.zeros((1, width), np.int64),
                    "slot_ids": np.full((1, width), -1, np.int32),
                    "block_table": np.zeros((1, self._mbps), np.int32),
                    "ctx_len": np.zeros((1,), np.int32),
                    "last_pos": np.zeros((1, 1), np.int64),
                })
                n += 1
            if self._exe.device.type == "cuda":
                torch.cuda.synchronize(self._exe.device)
        return n

    # -- reference loop ---------------------------------------------------
    def _score_buckets(self) -> Tuple[int, ...]:
        cfg = self.config
        out = set(cfg.prefill_seq_buckets)
        out.add(cfg.max_seq_len)
        return tuple(sorted(out))

    def greedy_reference(self, feed, max_new_tokens: Optional[int] = None,
                         eos_token_id: Optional[int] = None
                         ) -> GenerationResult:
        """The unbatched greedy loop — the parity oracle AND the honest
        baseline: re-scores the FULL prefix through the cache-free
        scoring program for every emitted token (prefix padded to the
        seq-bucket ladder, so its feed shapes stay few), exactly
        the reference AnalysisPredictor serving shape.  Runs on an
        isolated snapshot of the engine's weights, so live traffic
        cannot perturb it and it cannot perturb the cache.  Every
        engine-generated sequence must match this token-for-token."""
        cfg = self.config
        prompt = self._normalize_prompt(feed)
        max_new = cfg.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
        if int(prompt.size) + max_new > cfg.max_seq_len:
            raise InvalidArgumentError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                f"exceeds max_seq_len={cfg.max_seq_len}")
        with self._ref_lock:
            if self._score is None:
                self._score = self._exe.prepare(
                    self._programs.score,
                    feed_names=self._programs.score_feeds,
                    fetch_list=list(self._programs.fetch_names),
                    scope=self._ref_scope, donate_state=False)
            seq = list(int(t) for t in prompt)
            out_tokens: List[int] = []
            reason = "length"
            buckets = self._score_buckets()
            for _ in range(max_new):
                cur = len(seq)
                sb = next(b for b in buckets if b >= cur)
                src = np.zeros((1, sb), np.int64)
                src[0, :cur] = seq
                pos = np.zeros((1, sb), np.int64)
                pos[0, :cur] = np.arange(cur)
                mask = np.zeros((1, sb, 1), np.float32)
                mask[0, :cur, 0] = 1.0
                last = np.full((1, 1), cur - 1, np.int64)
                handles = self._score.run({
                    "src_ids": src, "pos_ids": pos, "input_mask": mask,
                    "last_pos": last})
                tok = int(handles[1].numpy()[0])
                out_tokens.append(tok)
                seq.append(tok)
                if eos is not None and tok == eos:
                    reason = "eos"
                    break
        return GenerationResult(out_tokens, int(prompt.size), reason,
                                len(out_tokens))

    # -- observability ---------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            elapsed = None
            if self._t_first is not None and self._t_last is not None:
                elapsed = max(self._t_last - self._t_first, 1e-9)
            out = {
                "submitted": self._submitted,
                "completed": self._completed,
                "failed": self._failed,
                "rejected": self._rejected,
                "tokens_out": self._tokens_out,
                "tokens_per_s": (self._tokens_out / elapsed)
                if elapsed else 0.0,
                "decode_steps": self._decode_steps,
                "prefill_batches": self._prefill_batches,
                "decode_batch_hist": dict(self._decode_batch_hist),
                "admission_waits": self._admission_waits,
                "block_reuses": self._block_reuses,
                "pool_blocks": self.pool_blocks,
                "peak_blocks_used": self._peak_blocks,
                "peak_occupancy": self._peak_blocks /
                max(1, self.pool_blocks),
                "host_syncs": self._host_syncs,
                "chains_run": self._chains_run,
                "chain_tokens": self._chain_tokens,
                "chain_hist": dict(self._chain_hist),
                "chunk_steps": self._chunk_steps,
                "interleaved_rounds": self._interleaved_rounds,
                "prefill_tokens": self._prefill_tokens,
            }
        out["cache_blocks_used"] = self._blocks_in_use()
        idx = self._prefix_index
        out["prefix_hits"] = idx.hits if idx is not None else 0
        out["prefix_misses"] = idx.misses if idx is not None else 0
        out["prefix_bytes_saved"] = idx.bytes_saved \
            if idx is not None else 0
        out["prefix_evictions"] = idx.evictions if idx is not None else 0
        out["prefix_indexed_blocks"] = len(idx) if idx is not None else 0
        with self._cond:
            out["pending"] = len(self._pending)
            out["active"] = len(self._active) + len(self._chunking)
            out["unhealthy"] = self._unhealthy is not None
        return out


__all__ = ["DecodeConfig", "DecodeEngine", "GenerationResult",
           "blocks_needed"]
