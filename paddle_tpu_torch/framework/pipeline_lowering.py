"""The executor's microbatched and pipelined lowerings of a training block
— the port of the JAX package's ``_lower_microbatched`` and
``_lower_pipelined_schedule`` (paddle_tpu/framework/executor.py).

:func:`lower_microbatched` (``pipe_microbatches`` > 1 on a run without
the pipe axis): the feeds split on dim 0 into M microbatches, each run
through the whole forward and differentiated with the loss seeded
``loss_scale / M``; the gradients summed in microbatch order — the
arithmetic of ``GradientMergeOptimizer`` over the same microbatch
stream, bit for bit at M = 2.  It is also the pipe = 1 run of a
pipelined program: the stage cuts are identity ops.

:func:`lower_pipelined` (a program ``framework.pipe.apply_pipeline``
cut into V virtual stages, run over its pipe axis): one process a pipe
rank.  Each rank walks the static tables of ``pipe.simulate_schedule``
and runs only its own units:

* at each tick it first receives what the tables file as arriving there
  — a virtual stage's input boundary from rank − 1, the cotangent of its
  output boundary from rank + 1 (point-to-point receives on the pipe
  group) — then runs its unit: F (the stage forward without autograd;
  the boundary it produces is sent to rank + 1 unwaited), B (the stage
  forward again from the saved input under autograd,
  ``torch.autograd.grad`` of (output boundary, loss seeded 1/M on the
  last virtual stage) under the received cotangent; the input's
  cotangent is sent to rank − 1) or, in the zero-bubble family, B taking
  only the activation gradient and W only the parameter gradient, each
  recomputing the stage.  An idle tick runs nothing.
* a send waits for nothing: every receive at tick t matches a send of
  tick t − 1, so no rank blocks on a later one.  The wrap link (rank
  S − 1 to rank 0) carries only the interleaved family's chunk hop.
* each (microbatch, virtual stage) unit draws its random numbers
  (dropout masks, the flash kernels' seeds) from a generator started at
  the run stream's state when its F unit ran; the run stream moves on
  from where that generator ended, and the B / W units start from the
  saved state again, so a recompute draws the F unit's masks.
* saved stage inputs and cotangents are dropped at their last unit: the
  in-flight state is what the simulator's ring slots bound.
* after the walk: the loss, held only on the last virtual stage's rank,
  is summed over the pipe group and divided by M; pipe-sharded
  parameters (``pipe_sharded_params``), all-gathered once before the
  walk, get their gradients reduce-scattered once after it; the others'
  stage-partial gradients are summed by the pipe-axis all-reduce the
  rewrite put at the head of the tail, then the tail runs.

:func:`last_pipeline_report` gives the census of the last pipelined run:
the JAX keys (``census_idle_slots`` is the sum over the pipe ranks of
the idle ticks each actually skipped) and the port's own (the launches
those idle ticks made, the units this rank ran, the hops, the peak
in-flight state)."""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from .core import grad_var_name
from .errors import InvalidArgumentError

_LAST_PIPE_REPORT: Dict[str, Any] = {}


def last_pipeline_report() -> Dict[str, Any]:
    """The census of the most recent pipelined lowering on this rank."""
    return dict(_LAST_PIPE_REPORT)


def microbatch_feeds(feeds, M) -> List[Dict[str, torch.Tensor]]:
    """Every feed [B, ...] cut on dim 0 into M microbatches of B/M rows."""
    out = [{} for _ in range(M)]
    for n, v in feeds.items():
        if v.shape[0] % M:
            raise ValueError(
                f"pipeline microbatching: feed {n!r} batch {v.shape[0]} "
                f"not divisible by num_microbatches={M}")
        for m, part in enumerate(v.chunk(M, 0)):
            out[m][n] = part
    return out


def _check_pipe_fetches(env, fetch_names, what):
    missing = [n for n in fetch_names if n not in env]
    if missing:
        raise InvalidArgumentError(
            f"{what}: fetch target(s) {missing} are per-microbatch "
            f"forward intermediates — under the microbatched/pipelined "
            f"lowering only the loss, persistables and update-zone "
            f"values are fetchable")


def _split_env(env, param_names, feed_names):
    params = {n: env[n] for n in param_names}
    feeds = {n: env[n] for n in feed_names}
    base = {k: v for k, v in env.items()
            if k not in params and k not in feeds}
    return base, params, feeds


def _run_tail(ops, bw_idx, env, ctx, keep, what):
    from .executor import run_ops
    ctx.grad_sync = None
    with torch.no_grad():
        run_ops(ops[bw_idx + 1:], env, ctx)
    _check_pipe_fetches(env, keep, what)
    return env


def lower_microbatched(ops, env, ctx, bw_idx, keep=()):
    """M microbatches through the whole forward, gradients summed in
    microbatch order with each loss seeded ``loss_scale / M``; the
    fetched loss is the mean of the microbatches' losses."""
    from .executor import run_ops
    attrs = ops[bw_idx].attrs
    param_names = list(attrs["param_names"])
    loss_name = attrs["loss_name"]
    loss_scale = float(attrs.get("loss_scale", 1.0))
    M = int(attrs["pipe_microbatches"])
    feed_names = [n for n in attrs.get("pipe_feed_names", ()) if n in env]
    base, params, feeds = _split_env(env, param_names, feed_names)
    leaves = [params[n].detach().requires_grad_(True) for n in param_names]
    acc: List[Any] = [None] * len(leaves)
    losses = []
    for mb in microbatch_feeds(feeds, M):
        e = dict(base)
        e.update(zip(param_names, leaves))
        e.update(mb)
        with torch.enable_grad():
            run_ops(ops[:bw_idx], e, ctx)
            lvar = e[loss_name]
            total = lvar.sum() * loss_scale
            seed = torch.full((), 1.0 / M, dtype=total.dtype,
                              device=total.device)
            grads = torch.autograd.grad(total, leaves, seed,
                                        allow_unused=True)
        losses.append(lvar.detach())
        acc = [g if a is None else (a if g is None else a + g)
               for a, g in zip(acc, grads)]
    env[loss_name] = torch.stack(losses).mean(0)
    for n, leaf, g in zip(param_names, leaves, acc):
        env[grad_var_name(n)] = torch.zeros_like(leaf) if g is None \
            else g.detach()
    env[grad_var_name(loss_name)] = torch.ones_like(env[loss_name])
    return _run_tail(ops, bw_idx, env, ctx, keep, "microbatched lowering")


def _probe(bw, ops, bw_idx, base, full, mb0, names, loss_name):
    """{name: (shape, dtype, differentiable)} of the boundary tensors and
    the loss on one microbatch, from the forward on ``meta`` tensors with
    the parameters requiring grad; cached on the backward op by the
    microbatch's feed signature."""
    from .pipe import abstract_env
    key = tuple(sorted((n, tuple(v.shape), str(v.dtype))
                       for n, v in mb0.items()))
    cache = bw.__dict__.setdefault("_pipe_probe", {})
    hit = cache.get(key)
    if hit is not None:
        return hit
    env = dict(base)
    env.update({n: v.detach().requires_grad_(True) for n, v in full.items()})
    env.update(mb0)
    out = abstract_env(ops[:bw_idx], env)
    hit = {n: (tuple(out[n].shape), out[n].dtype, bool(out[n].requires_grad))
           for n in list(names) + [loss_name]}
    cache[key] = hit
    return hit


class _Hops:
    """Point-to-point traffic of one walk: sends (unwaited until the
    end), receives, their bytes and the host seconds spent in them."""

    def __init__(self, g, device):
        self.g, self.device = g, device
        self.pending = []
        self.sends = self.recvs = self.bytes = 0
        self.seconds = 0.0

    def send(self, tensors, peer):
        from ..ops.collective_ops import isend_to
        t0 = time.perf_counter()
        self.pending.append(isend_to(self.g, tensors, peer))
        self.seconds += time.perf_counter() - t0
        self.sends += 1
        self.bytes += sum(t.numel() * t.element_size() for t in tensors)

    def recv(self, likes, peer):
        from ..ops.collective_ops import recv_from
        t0 = time.perf_counter()
        out = recv_from(self.g, likes, peer, self.device)
        self.seconds += time.perf_counter() - t0
        self.recvs += 1
        return out

    def drain(self):
        from ..ops.collective_ops import wait_sends
        t0 = time.perf_counter()
        wait_sends(self.pending)
        self.pending = []
        self.seconds += time.perf_counter() - t0


def lower_pipelined(ops, env, ctx, bw_idx, keep=()):
    """One pipe rank's walk of the stamped schedule (module docstring)."""
    from ..flags import flag
    from ..ops import cuda as kernels
    from ..ops.collective_ops import all_gather, all_reduce, reduce_scatter
    from ..ops.registry import LoweringContext
    from .executor import run_ops
    from .liveness import op_reads_recursive
    from .pipe import BOUNDARY_OP, KIND_B, KIND_F, KIND_IDLE, \
        simulate_schedule
    bw = ops[bw_idx]
    attrs = bw.attrs
    V = int(attrs["pipe_stages"])
    chunks = int(attrs.get("pipe_chunks") or 1)
    family = attrs.get("pipe_schedule") or "1f1b"
    S = V // max(chunks, 1)
    M = int(attrs["pipe_microbatches"])
    axis = attrs.get("pipe_axis") or "pp"
    boundaries = [list(b) for b in attrs["pipe_boundaries"]]
    param_names = list(attrs["param_names"])
    sharded = {n: int(d) for n, d in
               dict(attrs.get("pipe_sharded_params") or {}).items()}
    loss_name = attrs["loss_name"]
    loss_scale = float(attrs.get("loss_scale", 1.0))
    feed_names = [n for n in attrs.get("pipe_feed_names", ()) if n in env]
    g = ctx.dp.over(axis)
    if g.world != S:
        raise ValueError(
            f"pipelined program has {S} ranks ({V} virtual stages x "
            f"{chunks} chunks) but the {axis!r} axis has {g.world}")
    r = g.rank
    device = ctx.device

    segments: List[list] = [[] for _ in range(V)]
    for op in ops[:bw_idx]:
        if op.type != BOUNDARY_OP:
            segments[int(op.attrs.get("_pipe_stage", 0))].append(op)
    pset = set(param_names)
    seg_params = [sorted({n for op in seg for n in op_reads_recursive(op)}
                         & pset) for seg in segments]

    base, params, feeds = _split_env(env, param_names, feed_names)
    mbs = microbatch_feeds(feeds, M)
    full = dict(params)
    for n, dim in sharded.items():
        full[n] = all_gather(g, params[n], dim)
    union = sorted({n for b in boundaries for n in b})
    sig = _probe(bw, ops, bw_idx, base, full, mbs[0], union, loss_name)
    # the cotangent-carrying names of each virtual stage's output
    ct_names = [[n for n in boundaries[k] if sig[n][2]]
                for k in range(V - 1)] + [[]]

    sch = simulate_schedule(family, S, M, chunks=chunks)
    T = int(sch["ticks"])
    has_w = family == "zero_bubble"
    check = bool(flag("pipe_replay_check"))
    hops = _Hops(g, device)
    run_gen = ctx.generator
    saved_in: Dict[Any, Dict[str, torch.Tensor]] = {}
    saved_ct: Dict[Any, Dict[str, torch.Tensor]] = {}
    gen_state: Dict[Any, Any] = {}
    sent: Dict[Any, List[torch.Tensor]] = {}
    acc: Dict[str, Any] = {n: None for n in param_names}
    loss_sum = None
    units = {"F": 0, "B": 0, "W": 0}
    idle = idle_launches = 0
    peak_in = peak_ct = 0
    replay = [0, 0]             # checked, mismatched

    def unit_ctx(k, j, fresh):
        gen = None
        if run_gen is not None:
            if fresh:
                gen_state[(k, j)] = run_gen.get_state()
            gen = torch.Generator(device=run_gen.device)
            gen.set_state(gen_state[(k, j)])
        return LoweringContext(gen, device, ctx.is_test, ctx.donate_state,
                               ctx.dp)

    def stage_env(k, j, inputs):
        e = dict(base)
        e.update({n: full[n] for n in seg_params[k]})
        e.update(mbs[j])
        e.update(inputs)
        return e

    def forward_unit(k, j):
        nonlocal loss_sum
        sub = unit_ctx(k, j, True)
        e = stage_env(k, j, saved_in.get((k, j), {}))
        with torch.no_grad():
            run_ops(segments[k], e, sub)
        if run_gen is not None:
            run_gen.set_state(sub.generator.get_state())
        if k < V - 1:
            outs = [e[n].detach() for n in boundaries[k]]
            if check:
                sent[(k, j)] = [t.clone() for t in outs]
            hops.send(outs, (r + 1) % S)
        else:
            lv = e[loss_name].detach()
            loss_sum = lv if loss_sum is None else loss_sum + lv

    def backward_unit(k, j, weights, acts):
        sub = unit_ctx(k, j, False)
        leaves = {n: full[n].detach().requires_grad_(True)
                  for n in seg_params[k]} if weights else {}
        inputs, in_leaves = {}, {}
        for n in (boundaries[k - 1] if k > 0 else ()):
            t = saved_in[(k, j)][n].detach()
            if acts and sig[n][2]:
                t = t.requires_grad_(True)
                in_leaves[n] = t
            inputs[n] = t
        e = stage_env(k, j, inputs)
        e.update(leaves)
        with torch.enable_grad():
            run_ops(segments[k], e, sub)
            outs, cts = [], []
            for n in ct_names[k]:
                if e[n].requires_grad:
                    outs.append(e[n])
                    cts.append(saved_ct[(k, j)][n].to(e[n].dtype))
            if k == V - 1:
                total = e[loss_name].sum() * loss_scale
                outs.append(total)
                cts.append(torch.full((), 1.0 / M, dtype=total.dtype,
                                      device=total.device))
            wrt = list(leaves.values()) + list(in_leaves.values())
            grads = torch.autograd.grad(outs, wrt, cts, allow_unused=True) \
                if wrt and outs else [None] * len(wrt)
        if check and k < V - 1:
            replay[0] += 1
            replay[1] += sum(not torch.equal(e[n].detach(), t) for n, t in
                             zip(boundaries[k], sent[(k, j)]))
        for n, gr in zip(leaves, grads[:len(leaves)]):
            if gr is not None:
                acc[n] = gr if acc[n] is None else acc[n] + gr
        if acts and k > 0:
            got = dict(zip(in_leaves, grads[len(leaves):]))
            out = []
            for n in ct_names[k - 1]:
                gr = got.get(n)
                out.append(torch.zeros(sig[n][0], dtype=sig[n][1],
                                       device=device) if gr is None
                           else gr.detach())
            if out:
                hops.send(out, (r - 1) % S)

    def release(k, j):
        saved_in.pop((k, j), None)
        saved_ct.pop((k, j), None)
        gen_state.pop((k, j), None)
        sent.pop((k, j), None)

    t_walk = time.perf_counter()
    for t in range(T):
        c, j = sch["arr_c"][t][r], sch["arr_mb"][t][r]
        if j >= 0:
            k = c * S + r
            names = boundaries[k - 1]
            saved_in[(k, j)] = dict(zip(names, hops.recv(
                [sig[n][:2] for n in names], (r - 1) % S)))
        c, j = sch["ct_arr_c"][t][r], sch["ct_arr_mb"][t][r]
        if j >= 0:
            k = c * S + r
            names = ct_names[k]
            if names:
                saved_ct[(k, j)] = dict(zip(names, hops.recv(
                    [sig[n][:2] for n in names], (r + 1) % S)))
        peak_in = max(peak_in, len(saved_in))
        peak_ct = max(peak_ct, len(saved_ct))
        kind = sch["kind"][t][r]
        if kind == KIND_IDLE:
            before = sum(kernels.launch_counts().values())
            idle += 1
            idle_launches += sum(kernels.launch_counts().values()) - before
            continue
        k, j = sch["vstage"][t][r], sch["mb"][t][r]
        if kind == KIND_F:
            units["F"] += 1
            forward_unit(k, j)
        elif kind == KIND_B:
            units["B"] += 1
            backward_unit(k, j, weights=not has_w, acts=True)
            if not has_w:
                release(k, j)
        else:
            units["W"] += 1
            backward_unit(k, j, weights=True, acts=False)
            release(k, j)
    hops.drain()
    walk_s = time.perf_counter() - t_walk

    # the loss (only the last virtual stage's rank holds it), the idle
    # census and the idle launches in one sum over the pipe group
    lshape, ldtype = sig[loss_name][0], sig[loss_name][1]
    lsum = loss_sum if loss_sum is not None else \
        torch.zeros(lshape, dtype=ldtype, device=device)
    packed = torch.cat([lsum.reshape(-1).double(), torch.tensor(
        [idle, idle_launches], dtype=torch.float64, device=device)])
    packed = all_reduce(g, packed)
    nl = lsum.numel()
    loss = packed[:nl].to(ldtype).reshape(lshape) / M
    census_idle, all_idle_launches = (int(v) for v in
                                      packed[nl:].cpu().tolist())

    for n in param_names:
        a = acc[n] if acc[n] is not None else torch.zeros_like(full[n])
        if n in sharded:
            a = reduce_scatter(g, a, sharded[n])
        env[grad_var_name(n)] = a
    env[loss_name] = loss
    env[grad_var_name(loss_name)] = torch.ones_like(loss)

    global _LAST_PIPE_REPORT
    _LAST_PIPE_REPORT = {
        "family": family, "num_ranks": S, "chunks": chunks,
        "num_virtual_stages": V, "num_microbatches": M, "ticks": T,
        "census_idle_slots": census_idle,
        "sim_idle_slots": int(sch["idle_slots"]),
        "bubble_ticks": float(sch["bubble_ticks"]),
        "bubble_frac": float(sch["bubble_frac"]),
        "ring_slots": [int(sch["slots"]), int(sch["ct_slots"])],
        "sharded_params": dict(sharded),
        # the port's own: this rank's walk
        "rank": r, "rank_idle_ticks": idle,
        "idle_launches": all_idle_launches, "units": units,
        "ring_peak": [peak_in, peak_ct],
        "hops": {"sends": hops.sends, "recvs": hops.recvs,
                 "bytes_sent": hops.bytes, "seconds": hops.seconds},
        "walk_s": walk_s,
        "replay_checked": replay[0], "replay_mismatched": replay[1],
    }
    return _run_tail(ops, bw_idx, env, ctx, keep,
                     "scheduled pipeline lowering")
