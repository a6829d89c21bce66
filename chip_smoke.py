#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``).

    python3 chip_smoke.py            # from the repo root; needs one CUDA GPU

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. build the port's CUDA kernels from ``paddle_tpu_torch/ops/cuda/csrc``
   with nvcc (one process per source, in parallel);
2. hold each kernel against its plain PyTorch version on the GPU at the
   served shapes (BERT-base: rows 8x128 and 8x512, D = 768 / 3072; flash
   B = 8, H = 12, S = 128 and 512, D = 64 with padding, per-head, no bias
   and causal), float32 and bfloat16, and time kernel, plain version and
   one PyTorch library call (CUDA events, median of 25);
3. serve BERT-base at full width (12 layers, random weights from a seed)
   through save_inference_model → AnalysisPredictor (default passes) →
   ServingEngine: 16 bursts of 24 mixed-length requests, each burst
   drained before the next; check every result against a lone run of its
   padded request and against the plain path (kernel flags off), and
   prove the three served kernels launched with zero route fallbacks;
4. the unfused program (``switch_ir_optim(False)``): the LayerNorm kernel
   launches and the outputs match phase 3;
5. the attention pattern matmul → scale → add mask → softmax → dropout
   (test mode) → matmul, fused by ``multihead_matmul_fuse`` into a
   ``multihead_matmul`` op: the flash kernel launches and the output
   matches the plain path and the unfused program;
6. print the ``kernels`` JSON line, the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``.

Imports torch and the port only — nothing of JAX or the JAX package."""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

SEED = 2024
SEQ_FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask")
BURSTS, BURST_REQUESTS = 16, 24     # the served window: 384 requests

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,      # FP32 outside the tensor cores
              "bfloat16": 989e12}    # BF16 tensor cores

# stated tolerances: kernel vs its plain version on the same inputs
TOL_F32 = 2e-5            # LN, add-LN, bias-GELU, flash o (abs)
TOL_LSE = 1e-4            # flash lse (abs)
BF16_REL = 2.0 ** -6      # bf16: max|Δ| <= two bf16 ulps of max|plain|
TOL_LONE = 1e-5           # served result vs lone run of its padded request
TOL_PLAIN_PATH = 1e-4     # kernels on vs all kernel flags off, 12 layers
TOL_UNFUSED = 1e-4        # unfused program vs fused program, 12 layers

class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, samples=25, warmup=3):
    """Median device time of one call: each sample starts behind a short
    GPU sleep, so the host finishes enqueueing before the start event
    fires and the events see device time only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(torch, got, ref):
    return float((got.float() - ref.float()).abs().max())


def agree(torch, what, got, ref, dtype, tol):
    err = max_err(torch, got, ref)
    if dtype == "bfloat16":
        limit = BF16_REL * float(ref.float().abs().max())
    else:
        limit = tol
    log(f"  {what}: max|Δ| {err:.3e} (tolerance {limit:.3e})")
    check(err <= limit, f"{what}: kernel disagrees with its plain version "
                        f"({err:.3e} > {limit:.3e})")
    return err


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_checks(torch, results):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import fused_ops as K
    from paddle_tpu_torch.ops.cuda import flash_attention as FA

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) *
                scale).to(dtype)

    def record(name, shape, dtype, err, ms, plain_ms, lib_ms, nbytes,
               flops):
        b_ms, b_by = bound_ms(nbytes, flops, dtype)
        row = {"shape": shape, "dtype": dtype, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by}
        results.setdefault(name, []).append(row)
        log(f"  {name} {shape} {dtype}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms ({b_by})")

    for dtname, dt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        es = torch.finfo(dt).bits // 8
        # LayerNorm and residual add + LayerNorm, D = 768
        for rows in (8 * 128, 8 * 512):
            d = 768
            a, b = randn(rows, d, dtype=dt), randn(rows, d, dtype=dt)
            s = (1.0 + randn(d, scale=0.1)).to(dt)
            bb = randn(d, scale=0.1, dtype=dt)
            err = agree(torch, f"layer_norm [{rows},{d}] {dtname}",
                        K.layer_norm(a, s, bb), K.layer_norm_plain(a, s, bb),
                        dtname, TOL_F32)
            record("layer_norm_fwd", [rows, d], dtname, err,
                   time_ms(torch, lambda: K.layer_norm(a, s, bb)),
                   time_ms(torch, lambda: K.layer_norm_plain(a, s, bb)),
                   time_ms(torch, lambda: F.layer_norm(a, (d,), s, bb,
                                                       1e-5)),
                   (2 * rows * d + 2 * d) * es, 8 * rows * d)
            err = agree(torch, f"add_layer_norm [{rows},{d}] {dtname}",
                        K.add_layer_norm(a, b, s, bb),
                        K.add_layer_norm_plain(a, b, s, bb), dtname, TOL_F32)
            record("add_layer_norm_fwd", [rows, d], dtname, err,
                   time_ms(torch, lambda: K.add_layer_norm(a, b, s, bb)),
                   time_ms(torch,
                           lambda: K.add_layer_norm_plain(a, b, s, bb)),
                   time_ms(torch, lambda: F.layer_norm(a + b, (d,), s, bb,
                                                       1e-5)),
                   (3 * rows * d + 2 * d) * es, 9 * rows * d)
        # bias + GELU, D = 3072
        for rows in (8 * 128, 8 * 512):
            d = 3072
            xx, bb = randn(rows, d, dtype=dt), randn(d, scale=0.1, dtype=dt)
            err = agree(torch, f"bias_gelu [{rows},{d}] {dtname}",
                        K.bias_gelu(xx, bb), K.bias_gelu_plain(xx, bb),
                        dtname, TOL_F32)
            # ~20 operations per element: the add, erff's polynomial, 4 muls
            record("bias_gelu_fwd", [rows, d], dtname, err,
                   time_ms(torch, lambda: K.bias_gelu(xx, bb)),
                   time_ms(torch, lambda: K.bias_gelu_plain(xx, bb)),
                   time_ms(torch, lambda: F.gelu(xx + bb)),
                   (2 * rows * d + d) * es, 20 * rows * d)
        # flash attention, B = 8, H = 12, D = 64
        bsz, heads, d = 8, 12, 64
        for seq in (128, 512):
            bh = bsz * heads
            q, k, v = (randn(bh, seq, d, dtype=dt) for _ in range(3))
            lens = torch.randint(seq // 4, seq + 1, (bsz,), generator=gen,
                                 device=dev)
            mask = (torch.arange(seq, device=dev)[None, :] <
                    lens[:, None]).float()                     # [B, S]
            shared = (mask[:, :, None] * mask[:, None, :]) * 1e4 - 1e4
            perhead = randn(bh, seq, seq)
            # BERT's bias masks the padded query rows too (every logit of
            # such a row carries -1e4); all rows are held to the tolerance
            for mode, bias, causal in (("padding-bias", shared, False),
                                       ("per-head-bias", perhead, False),
                                       ("no-bias", None, False),
                                       ("causal", None, True)):
                o, lse = FA.flash_fwd(q, k, v, bias, causal=causal)
                po, plse = FA.flash_fwd_plain(q, k, v, bias, causal=causal)
                what = f"flash {mode} S={seq} {dtname}"
                err = agree(torch, what + " o", o, po, dtname, TOL_F32)
                lerr = max_err(torch, lse, plse)
                log(f"  {what} lse: max|Δ| {lerr:.3e} (tolerance "
                    f"{TOL_LSE:.1e})")
                check(lerr <= TOL_LSE, f"{what}: lse disagrees ({lerr})")
                if mode not in ("padding-bias", "causal"):
                    continue          # time the served and causal cases
                q4, k4, v4 = (t.view(bsz, heads, seq, d) for t in (q, k, v))
                if causal:
                    def lib():
                        return F.scaled_dot_product_attention(
                            q4, k4, v4, is_causal=True)
                    pairs = seq * (seq + 1) // 2
                else:
                    m4 = bias.view(bsz, 1, seq, seq).to(dt)

                    def lib():
                        return F.scaled_dot_product_attention(
                            q4, k4, v4, attn_mask=m4)
                    pairs = seq * seq
                nbytes = 4 * bh * seq * d * es + bh * seq * 4 + \
                    (0 if bias is None else bias.numel() * 4)
                record("flash_attention_fwd",
                       [bsz, heads, seq, d, mode], dtname,
                       max(err, lerr),
                       time_ms(torch, lambda: FA.flash_fwd(
                           q, k, v, bias, causal=causal)),
                       time_ms(torch, lambda: FA.flash_fwd_plain(
                           q, k, v, bias, causal=causal)),
                       time_ms(torch, lib), nbytes,
                       4 * bh * pairs * d)


# ---------------------------------------------------------------------------
# phases 3 and 4: BERT-base served through the port
# ---------------------------------------------------------------------------


def make_requests(np, cfg, n):
    rng = np.random.RandomState(SEED)
    reqs = []
    for i in range(n):
        rows = 1 + (i % 2)
        seq = int(rng.randint(20, 501))
        ids = rng.randint(0, cfg.vocab_size, (rows, seq)).astype("int64")
        reqs.append({
            "src_ids": ids,
            "pos_ids": np.tile(np.arange(seq, dtype="int64"), (rows, 1)),
            "sent_ids": (np.arange(seq) >= seq // 2).astype(
                "int64")[None].repeat(rows, 0),
            "input_mask": np.ones((rows, seq, 1), dtype="float32"),
        })
    return reqs


def build_and_save(torch, model_dir):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.framework.core import Program, program_guard
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig.base()
    unique_name.reset()
    main, startup = Program(), Program()
    startup.random_seed = SEED
    with program_guard(main, startup):
        feeds, seq_out, pooled = bert.build_inference_network(cfg)
    scope = fluid.Scope()
    exe = fluid.Executor()                       # CUDAPlace(0)
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(model_dir, [v.name for v in feeds],
                                  [seq_out, pooled], exe, main, scope=scope)
    torch.cuda.synchronize()
    log(f"  BERT-base built on {exe.device} and saved in "
        f"{time.perf_counter() - t0:.1f} s ({cfg.num_hidden_layers} layers, "
        f"hidden {cfg.hidden_size}, heads {cfg.num_attention_heads}, FFN "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size})")
    return cfg


def max_abs(np, a, b):
    return float(np.abs(np.asarray(a, np.float64) -
                        np.asarray(b, np.float64)).max())


def serve_phase(torch, np, model_dir, cfg):
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.serving import (ServingConfig, ServingEngine,
                                          pad_request)

    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    check(pred.device.type == "cuda", f"predictor on {pred.device}")
    ops = [op.type for op in pred.program.global_block().ops]
    log(f"  served program: {len(ops)} ops, "
        f"{ops.count('fused_attention')} fused_attention, "
        f"{ops.count('fused_add_layernorm')} fused_add_layernorm, "
        f"{ops.count('fused_elemwise_activation')} "
        f"fused_elemwise_activation")
    seq_name = pred.get_output_names()[0]
    scfg = ServingConfig(max_batch_size=8, max_wait_ms=5.0,
                         batch_buckets=(1, 2, 4, 8),
                         seq_buckets=(128, 256, 512), seq_feeds=SEQ_FEEDS,
                         seq_fetches=(seq_name,))
    engine = ServingEngine(pred, scfg)
    reqs = make_requests(np, cfg, BURSTS * BURST_REQUESTS)
    futs, results, walls = [], [], []
    try:
        t0 = time.perf_counter()
        n_warm = engine.warmup(reqs[0])
        torch.cuda.synchronize()
        log(f"  warmup: {n_warm} bucket combos in "
            f"{time.perf_counter() - t0:.1f} s")
        # the main path: counts from zero, served, read right after.  Each
        # burst is submitted at once and drained before the next.
        kernels.reset_launch_counts()
        registry.reset_route_counts()
        for i in range(BURSTS):
            burst = reqs[i * BURST_REQUESTS:(i + 1) * BURST_REQUESTS]
            t0 = time.perf_counter()
            bfuts = [engine.submit(r) for r in burst]
            results += [f.result(timeout=600) for f in bfuts]
            walls.append(time.perf_counter() - t0)
            futs += bfuts
        launches = kernels.launch_counts()
        routes = registry.route_counts()
        stats = engine.stats()
    finally:
        engine.shutdown()
    wall = sum(walls)
    per_burst = sorted(BURST_REQUESTS / w for w in walls)
    log(f"  served {len(reqs)} requests in {BURSTS} bursts of "
        f"{BURST_REQUESTS} ({sum(r['src_ids'].shape[0] for r in reqs)} "
        f"rows, lengths {min(r['src_ids'].shape[1] for r in reqs)}-"
        f"{max(r['src_ids'].shape[1] for r in reqs)}) in {wall:.3f} s: "
        f"{len(reqs) / wall:.2f} requests/s (per burst: min "
        f"{per_burst[0]:.2f}, median {statistics.median(per_burst):.2f}, "
        f"max {per_burst[-1]:.2f}), p50 {stats['p50_ms']:.2f} ms, "
        f"p99 {stats['p99_ms']:.2f} ms, batches {stats['batches']}, "
        f"padding waste {stats['padding_waste']:.3f}")
    log(f"  launches on the served path: {launches}")
    fallbacks = {k: v for k, v in routes.items() if k[2] == "fallback"}
    log(f"  route hits: { {k[0]: v for k, v in routes.items() if k[2] == 'hit'} }")
    check(not fallbacks, f"route fallbacks on the served path: {fallbacks}")
    for name in ("flash_attention_fwd", "add_layer_norm_fwd",
                 "bias_gelu_fwd"):
        check(launches[name] > 0, f"{name} never launched on the served "
                                  f"path")

    # every result vs a lone run of its padded request, then vs the plain
    # path (all kernel flags off) on the same padded request
    lone_err = plain_err = 0.0
    canon, kernel_outs = [], []
    for r, f, res in zip(reqs, futs, results):
        bb, sb = f.bucket
        padded = pad_request(r, sb, SEQ_FEEDS, batch_bucket=bb)
        canon.append((padded, r["src_ids"].shape))
        lone = pred.run_feed(padded)
        kernel_outs.append(lone)
        rows, seq = r["src_ids"].shape
        lone_err = max(lone_err, max_abs(np, res[0], lone[0][:rows, :seq]),
                       max_abs(np, res[1], lone[1][:rows]))
    log(f"  served vs lone padded run: max|Δ| {lone_err:.3e} (tolerance "
        f"{TOL_LONE:.0e})")
    check(lone_err <= TOL_LONE, "served result differs from its lone run")
    flags.set_flags({"use_flash_attention": False,
                     "use_pallas_fused": False})
    try:
        kernels.reset_launch_counts()
        plain_outs = [pred.run_feed(p) for p, _ in canon]
        check(sum(kernels.launch_counts().values()) == 0,
              "the plain path launched a kernel")
    finally:
        flags.set_flags({"use_flash_attention": True,
                         "use_pallas_fused": True})
    for (p, (rows, seq)), ko, po in zip(canon, kernel_outs, plain_outs):
        plain_err = max(plain_err, max_abs(np, ko[0][:rows, :seq],
                                           po[0][:rows, :seq]),
                        max_abs(np, ko[1][:rows], po[1][:rows]))
        check(np.isfinite(ko[0]).all() and np.isfinite(ko[1]).all(),
              "non-finite served output")
    log(f"  kernels vs plain path (flags off): max|Δ| {plain_err:.3e} "
        f"(tolerance {TOL_PLAIN_PATH:.0e})")
    check(plain_err <= TOL_PLAIN_PATH, "kernel path disagrees with the "
                                       "plain path")
    serving = {"requests": len(reqs), "bursts": BURSTS, "wall_s": wall,
               "requests_per_s": len(reqs) / wall,
               "burst_requests_per_s": per_burst,
               "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
               "batches": stats["batches"],
               "padding_waste": stats["padding_waste"],
               "lone_max_abs": lone_err, "plain_path_max_abs": plain_err}
    return launches, serving, canon, kernel_outs


def unfused_phase(torch, np, model_dir, canon, fused_outs):
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    cfg = AnalysisConfig(model_dir)
    cfg.switch_ir_optim(False)
    pred = create_paddle_predictor(cfg)
    pred.prepare()
    ops = [op.type for op in pred.program.global_block().ops]
    log(f"  unfused program: {len(ops)} ops, {ops.count('layer_norm')} "
        f"layer_norm")
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    outs = [pred.run_feed(p) for p, _ in canon]
    launches = kernels.launch_counts()
    fallbacks = registry.route_counts("fallback")
    log(f"  launches on the unfused path: {launches}")
    check(launches["layer_norm_fwd"] > 0, "layer_norm_fwd never launched")
    check(not fallbacks, f"route fallbacks on the unfused path: "
                         f"{fallbacks}")
    err = 0.0
    for (p, (rows, seq)), uo, fo in zip(canon, outs, fused_outs):
        err = max(err, max_abs(np, uo[0][:rows, :seq], fo[0][:rows, :seq]),
                  max_abs(np, uo[1][:rows], fo[1][:rows]))
    log(f"  unfused vs fused: max|Δ| {err:.3e} (tolerance "
        f"{TOL_UNFUSED:.0e})")
    check(err <= TOL_UNFUSED, "unfused program disagrees with the fused")
    return launches, err


def mhm_phase(torch, np):
    """The attention pattern a user writes by hand, fused into one
    ``multihead_matmul`` op: the flash kernel runs it with the pattern's
    scale folded into q and the test-mode dropout's (1 - p) applied after
    (BERT-base heads: B = 8, H = 12, S = 128, D = 64, padding mask)."""
    from paddle_tpu_torch import flags, fluid
    from paddle_tpu_torch.framework.core import Program, program_guard
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    b, h, s, d = 8, 12, 128, 64
    main, startup = Program(), Program()
    with program_guard(main, startup):
        q, k, v = (fluid.layers.data(n, shape=[h, s, d])
                   for n in ("q", "k", "v"))
        mask = fluid.layers.data("mask", shape=[1, 1, s])
        scores = fluid.layers.matmul(q, k, transpose_y=True)
        scores = fluid.layers.scale(scores, scale=0.1)
        scores = fluid.layers.elementwise_add(scores, mask)
        probs = fluid.layers.dropout(fluid.layers.softmax(scores), 0.1,
                                     is_test=True)
        out = fluid.layers.matmul(probs, v)
    rng = np.random.RandomState(SEED)
    feed = {n: rng.randn(b, h, s, d).astype("float32")
            for n in ("q", "k", "v")}
    lens = rng.randint(s // 4, s + 1, b)
    feed["mask"] = np.where(np.arange(s)[None, :] < lens[:, None], 0.0,
                            -1e4).astype("float32").reshape(b, 1, 1, s)
    exe = fluid.Executor()                       # CUDAPlace(0)
    unfused, = exe.run(main, feed=feed, fetch_list=[out])
    apply_pass(main, "multihead_matmul_fuse", fetch_names=[out.name])
    ops = [op.type for op in main.global_block().ops]
    check(ops == ["multihead_matmul"], f"fused pattern: {ops}")
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    fused, = exe.run(main, feed=feed, fetch_list=[out])
    launches = kernels.launch_counts()["flash_attention_fwd"]
    fallbacks = registry.route_counts("fallback")
    flags.set_flags({"use_flash_attention": False})
    try:
        plain, = exe.run(main, feed=feed, fetch_list=[out])
    finally:
        flags.set_flags({"use_flash_attention": True})
    err_plain, err_unfused = max_abs(np, fused, plain), \
        max_abs(np, fused, unfused)
    log(f"  multihead_matmul [{b},{h},{s},{d}]: flash launches {launches}, "
        f"vs plain path max|Δ| {err_plain:.3e}, vs unfused program "
        f"{err_unfused:.3e} (tolerance {TOL_F32:.0e})")
    check(launches == 1, f"flash launched {launches} times")
    check(not fallbacks, f"route fallbacks: {fallbacks}")
    check(np.isfinite(fused).all(), "non-finite multihead_matmul output")
    check(max(err_plain, err_unfused) <= TOL_F32,
          "multihead_matmul disagrees with its plain path")
    return max(err_plain, err_unfused)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def nvidia_smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def kernels_line(per_kernel, served_launches, unfused_launches):
    """One entry per kernel, at the main-path shape (rows 8x128 / B = 8,
    S = 128, float32); the flash entry is the padding-bias case.  Sources
    and the TPU kernels replaced come from the port's route table."""
    from paddle_tpu_torch.ops.op_specs import kernel_facts
    facts = kernel_facts()
    out = []
    for name in ("flash_attention_fwd", "add_layer_norm_fwd",
                 "bias_gelu_fwd", "layer_norm_fwd"):
        rows = [r for r in per_kernel[name] if r["dtype"] == "float32"]
        main = rows[0]
        path = "unfused" if name == "layer_norm_fwd" else "served"
        launches = (unfused_launches if path == "unfused"
                    else served_launches)[name]
        out.append({
            "name": name, "route": "cuda", "source": facts[name][0],
            "replaces": facts[name][1], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "dtype": "float32", "path": path})
    return {"kernels": out}


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: missing dependency: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available — this script runs the "
              "port on a GPU only", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "paddle_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository (no "
              "paddle_tpu_torch package beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}")

    from paddle_tpu_torch.ops.cuda import build
    model_dir = os.path.join(build.BUILD_DIR, "smoke_bert_base")
    t_start = time.perf_counter()
    try:
        log("phase 1: build")
        rep = build.build()
        log(f"  built {rep['built'] or 'nothing (cached)'} in "
            f"{rep['seconds']:.1f} s")

        log("phase 2: kernels vs plain versions")
        per_kernel = {}
        kernel_checks(torch, per_kernel)

        log("phase 3: BERT-base served through the port")
        shutil.rmtree(model_dir, ignore_errors=True)
        cfg = build_and_save(torch, model_dir)
        served, serving, canon, fused_outs = serve_phase(torch, np,
                                                         model_dir, cfg)

        log("phase 4: unfused program (switch_ir_optim(False))")
        unfused, unfused_err = unfused_phase(torch, np, model_dir, canon,
                                             fused_outs)
        serving["unfused_max_abs"] = unfused_err

        log("phase 5: multihead_matmul program on the flash kernel")
        serving["multihead_matmul_max_abs"] = mhm_phase(torch, np)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)

    log(f"phase 6: report ({time.perf_counter() - t_start:.1f} s in all)")
    log("serving " + json.dumps(serving))
    log("kernel_rows " + json.dumps(per_kernel))
    print(json.dumps(kernels_line(per_kernel, served, unfused)))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
