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
6. the training kernels against their plain versions at BERT-base
   training shapes: flash forward with dropout 0.1 and its dq and dk/dv
   kernels (B = 32, S = 128 and B = 8, S = 512; padding bias and causal;
   float32 and bfloat16; one seed, so the masks are bit-identical),
   LayerNorm backward (R = 4096 and 640, D = 768) and Adam (the word
   embedding's 23,440,896 elements, 2,359,296, 768, 2, and all 158
   BERT-base parameters), timed like phase 2; and the fused-training
   kernels: add+LayerNorm backward (R = 4096 and 1000, plus 1003 for a
   ragged last row block, D = 768) and bias+GELU backward (R = 4096,
   D = 3072 and R = 640, D = 768, plus R = 1003), float32 and bfloat16;
7. train BERT-base at full width and depth (random weights from a seed,
   Adam 1e-4, dropout 0.1 as published) for 10 steps through
   ``Executor.prepare(donate_state=True)`` on a pretraining batch of
   32 x 128 tokens with 20 masked positions per sequence: the loss is
   finite and falls, no route falls back, and each step launches 12 flash
   forward, 12 dq, 12 dk/dv, 26 LayerNorm forward and backward and 158
   Adam kernels; one more step runs under ``torch.profiler`` for the
   device time by kernel and the device's busy share of a step; then,
   with dropout 0, 3 steps with every kernel on against every kernel
   flag off (the plain compositions) agree;
8. train BERT-base at full width and depth through the fused program and
   the published optimizer recipe: ``fuse_add_layernorm`` applied, then
   ``CompiledProgram(main).with_data_parallel(build_strategy=
   BuildStrategy(fuse_elewise_add_act_ops=True))`` prepared with
   ``donate_state=True``; AdamW with weight decay 0.01, gradients clipped
   to global norm 1.0, the LR warmed up linearly to 1e-4 and decayed
   linearly to 0 over 1,000,000 steps.  The warmup is cut from the
   published 10,000 steps to 3 so the loss moves within the 10 steps.
   Same batch and dropout as phase 7.  The loss is finite and falls, the
   LR read back each step is the schedule's closed form, no route falls
   back, and each step launches 25 add+LN forward and backward, 1 LN
   forward and backward, 13 bias+GELU forward and backward, 12 flash
   forward, dq and dk/dv and 158 Adam kernels; one more step runs under
   the profiler; then, with dropout 0, 3 steps with every kernel on
   against every kernel flag off agree;
9. the receive-stage kernels of the quantized gradient all-reduce against
   their plain versions: dequant-accumulate (#11) and
   dequant-accumulate-requantize (#12) on synthetic peer payloads at the
   shard shapes of BERT-base's buckets (n = 2 with SB = 45,783, the word
   embedding, and 13,844, a layer bucket; n = 4 and 8 with a ragged
   SB = 1,003), int8 at block 256, int4 at blocks 256 and 128, and a
   payload view that is not 16-byte aligned: #12's payload bit-identical
   and its scales within 2e-6, #11 within 1e-5; timed like phase 2;
10. data-parallel BERT-base: two ranks on the one card
   (``python -m paddle_tpu_torch.distributed.launch --nproc 2
   --selected_gpus 0,0 --backend gloo``; NCCL refuses two ranks of one
   communicator on one GPU, so gloo carries the wire bytes through the
   host while everything else runs on the card), each running this script
   as ``--dp-worker``: the phase-8 program and recipe through ``fleet``
   with ``quant_allreduce`` on the phase-8 global batch (16 rows per
   rank), 10 steps in the int8 tier and 3 in the int4 tier.  Each rank
   checks 13 ``c_fused_quant_allreduce_sum`` buckets, 13 launches of #12
   (int8) or #11 (int4) per step, the phase-8 kernels' launches per step,
   no route fallback, gloo and its device, a finite falling loss, and
   reports its step time, one profiled step's device-busy share and the
   wall time of its collectives (gloo staged through the host on a shared
   card: no measure of NVLink); the parent holds the ranks' parameters
   bit-identical after each leg, and 3 dropout-free int8 steps on two
   ranks against 3 single-GPU steps: the losses within the int8 tier's
   bound 5e-2, and Adam's first moments (linear in the reduced gradients)
   within four int8 quanta (4/127) as a relative norm;
11. print the ``kernels`` JSON line, the card's name and power limit, and
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
TOL_GRAD = 2e-4           # flash dq/dk/dv, of max(1, max|plain|)
TOL_LN_SUM = 2e-5         # LN dscale/dbias, of max(1, max|plain|)
TOL_ADAM = 1e-5           # Adam p, m, v (abs)
TOL_TRAIN_LOSS = 1e-4     # training loss, kernels on vs off (relative)
TOL_TRAIN_GRAD = 1e-4     # step-1 grads, kernels on vs off, of max|grad|

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS = 10, 32, 128, 20
LONG_BATCH, LONG_SEQ = 8, 512      # the longest BERT sequence
PLAIN_STEPS = 3
DROPOUT = 0.1
# launches per BERT-base training step: 12 layers; LayerNorm 1 + 2 per
# layer + the masked-LM head; one Adam op per parameter
TRAIN_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
                  "flash_attention_bwd_dkv": 12, "layer_norm_fwd": 26,
                  "layer_norm_bwd": 26, "adam": 158}
# the fused program: add+LN for the 24 residual adds and the embedding sum
# (word + pos) + sent, LN left for the masked-LM transform; bias+GELU for
# the 12 FFNs and the masked-LM transform (the pooled tanh runs unfused)
FUSED_LAUNCHES = dict(TRAIN_LAUNCHES, layer_norm_fwd=1, layer_norm_bwd=1,
                      add_layer_norm_fwd=25, add_layer_norm_bwd=25,
                      bias_gelu_fwd=13, bias_gelu_bwd=13)
# the recipe (Devlin et al. 2019, A.2; google-research/bert
# optimization.py): peak LR 1e-4, decay to 0 over 1M steps, AdamW 0.01,
# global-norm clip 1.0; the warmup is cut from 10,000 steps to 3
PEAK_LR, WARMUP_STEPS, DECAY_STEPS = 1e-4, 3, 1_000_000
WEIGHT_DECAY, CLIP_NORM = 0.01, 1.0
TOL_LR = 1e-6             # LR read back vs the closed form (relative)
EDGE_ROWS = 1003          # ragged last block of the backwards' row blocks
# the quantized all-reduce's receive stage (KERNEL_CENSUS_r15.json parity)
TOL_DQ_ACC = 1e-5         # #11 vs its plain version (abs)
TOL_DQ_ACC_BLOCK = 1e-6   # #11, each block of max|plain| of that block
TOL_DQ_SCALE = 2e-6       # #12's scales vs its plain version (abs)
# data parallelism on one card: two ranks, 13 gradient buckets of BERT-base
# at the default 32 MB cap, one #12 (int8) or #11 (int4) launch each
DP_RANKS, DP_BUCKETS, DP_INT4_STEPS = 2, 13, 3
DP_TIMEOUT_S = 420
TOL_DP_INT8 = 5e-2        # int8 tier vs full precision (test_grad_comm.py)
# Adam's first moments after the dropout-free legs, two ranks int8 vs one
# GPU, as a relative norm over every parameter: four int8 quanta (a
# quantum is 1/127 of its block's max).  The moments are linear in the
# reduced gradients, which the LR schedule and AdamW hide from the losses
TOL_DP_MOMENTS = 4 / 127

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


def agree(torch, what, got, ref, dtype, tol, relative=False):
    """Kernel vs plain: bf16 within two bf16 ulps of max|plain|; float32
    within ``tol``, of max(1, max|plain|) when ``relative``."""
    err = max_err(torch, got, ref)
    if dtype == "bfloat16":
        limit = BF16_REL * float(ref.float().abs().max())
    elif relative:
        limit = tol * max(1.0, float(ref.float().abs().max()))
    else:
        limit = tol
    log(f"  {what}: max|Δ| {err:.3e} (tolerance {limit:.3e})")
    check(err <= limit, f"{what}: kernel disagrees with its plain version "
                        f"({err:.3e} > {limit:.3e})")
    return err


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def recorder(results):
    """record(name, shape, dtype, err, ms, plain_ms, lib_ms, nbytes, flops,
    **extra) appends one timed row to ``results[name]``."""
    def record(name, shape, dtype, err, ms, plain_ms, lib_ms, nbytes,
               flops, **extra):
        b_ms, b_by = bound_ms(nbytes, flops, dtype)
        row = {"shape": shape, "dtype": dtype, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, **extra}
        results.setdefault(name, []).append(row)
        log(f"  {name} {shape} {dtype}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms ({b_by})"
            + "".join(f", {k} {v}" for k, v in extra.items()))
    return record


def randn_on(torch, gen, dev):
    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) *
                scale).to(dtype)
    return randn


def padding_bias(torch, gen, dev, bsz, seq):
    """BERT's head-shared bias (B, S, S): 0 where query and key are both
    inside the sequence, -1e4 elsewhere (padded query rows included)."""
    lens = torch.randint(seq // 4, seq + 1, (bsz,), generator=gen,
                         device=dev)
    mask = (torch.arange(seq, device=dev)[None, :] <
            lens[:, None]).float()                     # [B, S]
    return (mask[:, :, None] * mask[:, None, :]) * 1e4 - 1e4


def kernel_checks(torch, results):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import fused_ops as K
    from paddle_tpu_torch.ops.cuda import flash_attention as FA

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    randn = randn_on(torch, gen, dev)
    record = recorder(results)

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
            shared = padding_bias(torch, gen, dev, bsz, seq)
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
# phase 6: the training kernels against their plain versions
# ---------------------------------------------------------------------------


def bert_base_param_shapes(cfg):
    """The 158 parameter shapes of BERT-base pretraining (a program built
    for its declarations only; nothing runs)."""
    from paddle_tpu_torch.framework.core import Program, program_guard
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = Program(), Program()
    with program_guard(main, startup):
        bert.build_pretrain_network(cfg)
    return [tuple(p.shape) for p in main.all_parameters()]


def flash_training_checks(torch, results):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as FA

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    randn = randn_on(torch, gen, dev)
    record = recorder(results)
    seed = torch.tensor([SEED], dtype=torch.int32, device=dev)
    heads, d = 12, 64
    for dtname, dt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        es = torch.finfo(dt).bits // 8
        for bsz, seq in ((TRAIN_BATCH, TRAIN_SEQ), (LONG_BATCH, LONG_SEQ)):
            bh = bsz * heads
            q, k, v, do = (randn(bh, seq, d, dtype=dt) for _ in range(4))
            shared = padding_bias(torch, gen, dev, bsz, seq)
            for mode, bias, causal in (("padding-bias", shared, False),
                                       ("causal", None, True)):
                what = f"flash train {mode} B={bsz} S={seq} {dtname}"
                o, lse = FA.flash_fwd(q, k, v, bias, causal, DROPOUT, seed)
                po, plse = FA.flash_fwd_plain(q, k, v, bias, causal,
                                              DROPOUT, seed)
                err_o = agree(torch, what + " o (dropout 0.1)", o, po,
                              dtname, TOL_F32)
                # a padded row's lse is near -1e4, where a float32 ulp is
                # ~1e-3: held per row to TOL_LSE of max(1, |lse|)
                lerr = float(((lse - plse).abs() /
                              plse.abs().clamp_min(1.0)).max())
                log(f"  {what} lse: max|Δ|/max(1,|lse|) {lerr:.3e} "
                    f"(tolerance {TOL_LSE:.1e})")
                check(lerr <= TOL_LSE, f"{what}: lse disagrees ({lerr})")
                grads = FA.flash_bwd(q, k, v, bias, o, lse, do, causal,
                                     DROPOUT, seed)
                refs = FA.flash_bwd_plain(q, k, v, bias, o, lse, do, causal,
                                          DROPOUT, seed)
                errs = [agree(torch, f"{what} {n}", g, r, dtname, TOL_GRAD,
                              relative=True)
                        for n, g, r in zip(("dq", "dk", "dv"), grads, refs)]
                delta = (do.float() * o.float()).sum(dim=-1)
                pairs = seq * (seq + 1) // 2 if causal else seq * seq
                io_bytes = bh * seq * d * es
                extra = (0 if bias is None else bias.numel() * 4) + \
                    2 * bh * seq * 4                  # lse, delta
                q4, k4, v4, do4 = (t.view(bsz, heads, seq, d).detach()
                                   .requires_grad_(True) for t in
                                   (q, k, v, do))
                mask4 = None if bias is None else \
                    bias.view(bsz, 1, seq, seq).to(dt)
                lib_out = F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask4, is_causal=causal)
                lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                    lib_out, (q4, k4, v4), do4, retain_graph=True))
                plain_bwd = time_ms(torch, lambda: FA.flash_bwd_plain(
                    q, k, v, bias, o, lse, do, causal, DROPOUT, seed))
                shape = [bsz, heads, seq, d, mode, "dropout 0.1"]
                record("flash_attention_fwd_dropout", shape, dtname,
                       max(err_o, lerr),
                       time_ms(torch, lambda: FA.flash_fwd(
                           q, k, v, bias, causal, DROPOUT, seed)),
                       time_ms(torch, lambda: FA.flash_fwd_plain(
                           q, k, v, bias, causal, DROPOUT, seed)),
                       time_ms(torch, lambda: F.scaled_dot_product_attention(
                           q4, k4, v4, attn_mask=mask4, is_causal=causal,
                           dropout_p=DROPOUT)),
                       4 * io_bytes + extra - bh * seq * 4,
                       4 * bh * pairs * d)
                # the library's one backward call computes dq, dk and dv
                # together, and so does the plain version: both stand
                # beside each kernel, the library as an extra key
                record("flash_attention_bwd_dq", shape, dtname, errs[0],
                       time_ms(torch, lambda: FA.flash_bwd_dq(
                           q, k, v, bias, do, lse, delta, causal, DROPOUT,
                           seed)),
                       plain_bwd, None, 5 * io_bytes + extra,
                       6 * bh * pairs * d, library_dq_dk_dv_ms=lib_bwd)
                record("flash_attention_bwd_dkv", shape, dtname,
                       max(errs[1:]),
                       time_ms(torch, lambda: FA.flash_bwd_dkv(
                           q, k, v, bias, do, lse, delta, causal, DROPOUT,
                           seed)),
                       plain_bwd, None, 6 * io_bytes + extra,
                       8 * bh * pairs * d, library_dq_dk_dv_ms=lib_bwd)
                del lib_out


def ln_adam_training_checks(torch, results, cfg):
    from paddle_tpu_torch.ops.cuda import fused_ops as K
    from paddle_tpu_torch.ops.cuda import optimizer as O

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    randn = randn_on(torch, gen, dev)
    record = recorder(results)
    d = cfg.hidden_size
    for dtname, dt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        es = torch.finfo(dt).bits // 8
        # the encoder's rows (B*S) and the masked-LM head's (B*20)
        for rows in (TRAIN_BATCH * TRAIN_SEQ, TRAIN_BATCH * TRAIN_MASKS):
            x, dy = randn(rows, d, dtype=dt), randn(rows, d, dtype=dt)
            s = (1.0 + randn(d, scale=0.1)).to(dt)
            what = f"layer_norm_bwd [{rows},{d}] {dtname}"
            got = K.layer_norm_bwd(x, s, dy)
            ref = K.layer_norm_bwd_plain(x, s, dy)
            err = max(agree(torch, what + " dx", got[0], ref[0], dtname,
                            TOL_F32),
                      agree(torch, what + " dscale", got[1], ref[1], dtname,
                            TOL_LN_SUM, relative=True),
                      agree(torch, what + " dbias", got[2], ref[2], dtname,
                            TOL_LN_SUM, relative=True))
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                x, [d], s, s, 1e-5)
            record("layer_norm_bwd", [rows, d], dtname, err,
                   time_ms(torch, lambda: K.layer_norm_bwd(x, s, dy)),
                   time_ms(torch, lambda: K.layer_norm_bwd_plain(x, s, dy)),
                   time_ms(torch, lambda:
                           torch.ops.aten.native_layer_norm_backward(
                               dy, x, [d], mean, rstd, s, s,
                               [True, True, True])),
                   (3 * rows * d + 3 * d) * es, 16 * rows * d)

    def adam_state(n):
        return (randn(n), randn(n), randn(n, scale=0.1),
                randn(n, scale=0.01).abs())

    lr_t = torch.tensor([1e-4], device=dev)
    step = torch.tensor([1.0], device=dev)

    def library(ps, gs, ms, vs):
        torch._fused_adam_(ps, gs, ms, vs, [], [step] * len(ps), lr=1e-4,
                           beta1=0.9, beta2=0.999, weight_decay=0.0,
                           eps=1e-8, amsgrad=False, maximize=False)

    # the word embedding's launch, a 768 x 3072 FFN weight, an LN vector
    # and next_sent_fc.b_0
    adam_err = 0.0
    for n in (cfg.vocab_size * d, 4 * d * d, d, 2):
        state = adam_state(n)
        a = [t.clone() for t in state]
        b = [t.clone() for t in state]
        O.adam(a[0], a[1], a[2], a[3], lr_t)
        O.adam_plain(b[0], b[1], b[2], b[3], lr_t)
        err = max(agree(torch, f"adam n={n} {name}", a[i], b[i], "float32",
                        TOL_ADAM) for name, i in (("p", 0), ("m", 2),
                                                  ("v", 3)))
        record("adam", [n], "float32", err,
               time_ms(torch, lambda: O.adam(*a, lr_t)),
               time_ms(torch, lambda: O.adam_plain(*b, lr_t)),
               time_ms(torch, lambda: library([a[0]], [a[1]], [a[2]],
                                              [a[3]])),
               28 * n, 12 * n)
        adam_err = max(adam_err, err)
    # one step's 158 launches over every BERT-base parameter
    shapes = bert_base_param_shapes(cfg)
    check(len(shapes) == TRAIN_LAUNCHES["adam"],
          f"BERT-base has {len(shapes)} parameters")
    total = sum(math.prod(sh) for sh in shapes)
    tensors = [adam_state(math.prod(sh)) for sh in shapes]
    ps, gs, ms, vs = (list(t) for t in zip(*tensors))

    def kernel_all():
        for st in tensors:
            O.adam(*st, lr_t)

    def plain_all():
        for st in tensors:
            O.adam_plain(*st, lr_t)

    record("adam", [f"all {len(shapes)} BERT-base parameters", total],
           "float32", adam_err, time_ms(torch, kernel_all, samples=9),
           time_ms(torch, plain_all, samples=9),
           time_ms(torch, lambda: library(ps, gs, ms, vs), samples=9),
           28 * total, 12 * total)
    del tensors, ps, gs, ms, vs


def fused_training_checks(torch, results, cfg):
    """add+LN backward at the encoder's rows and bias+GELU backward at the
    FFN's and the masked-LM transform's, each also at EDGE_ROWS."""
    from paddle_tpu_torch.ops.cuda import fused_ops as K

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    randn = randn_on(torch, gen, dev)
    record = recorder(results)
    d = cfg.hidden_size
    for dtname, dt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        es = torch.finfo(dt).bits // 8
        for rows in (TRAIN_BATCH * TRAIN_SEQ, 1000, EDGE_ROWS):
            a, b, dy = (randn(rows, d, dtype=dt) for _ in range(3))
            s = (1.0 + randn(d, scale=0.1)).to(dt)
            what = f"add_layer_norm_bwd [{rows},{d}] {dtname}"
            got = K.add_layer_norm_bwd(a, b, s, dy)
            ref = K.add_layer_norm_bwd_plain(a, b, s, dy)
            err = max(agree(torch, what + " dx", got[0], ref[0], dtname,
                            TOL_F32),
                      agree(torch, what + " dscale", got[1], ref[1], dtname,
                            TOL_LN_SUM, relative=True),
                      agree(torch, what + " dbias", got[2], ref[2], dtname,
                            TOL_LN_SUM, relative=True))
            # the library backward of LN(u) with u = a + b made beforehand
            u = a + b
            _, mean, rstd = torch.ops.aten.native_layer_norm(
                u, [d], s, s, 1e-5)
            record("add_layer_norm_bwd", [rows, d], dtname, err,
                   time_ms(torch, lambda: K.add_layer_norm_bwd(a, b, s, dy)),
                   time_ms(torch,
                           lambda: K.add_layer_norm_bwd_plain(a, b, s, dy)),
                   time_ms(torch, lambda:
                           torch.ops.aten.native_layer_norm_backward(
                               dy, u, [d], mean, rstd, s, s,
                               [True, True, True])),
                   (4 * rows * d + 3 * d) * es, 17 * rows * d)
        for rows, width in ((TRAIN_BATCH * TRAIN_SEQ, cfg.intermediate_size),
                            (TRAIN_BATCH * TRAIN_MASKS, d),
                            (EDGE_ROWS, cfg.intermediate_size)):
            x, dy = randn(rows, width, dtype=dt), randn(rows, width, dtype=dt)
            bb = randn(width, scale=0.1, dtype=dt)
            what = f"bias_gelu_bwd [{rows},{width}] {dtname}"
            got = K.bias_gelu_bwd(x, bb, dy)
            ref = K.bias_gelu_bwd_plain(x, bb, dy)
            err = max(agree(torch, what + " dx", got[0], ref[0], dtname,
                            TOL_F32),
                      agree(torch, what + " db", got[1], ref[1], dtname,
                            TOL_LN_SUM, relative=True))
            u = x + bb

            def library():
                return torch.ops.aten.gelu_backward(dy, u).sum(0)
            # ~30 operations per element: erff and expf, the add, 6 muls
            record("bias_gelu_bwd", [rows, width], dtname, err,
                   time_ms(torch, lambda: K.bias_gelu_bwd(x, bb, dy)),
                   time_ms(torch, lambda: K.bias_gelu_bwd_plain(x, bb, dy)),
                   time_ms(torch, library),
                   (3 * rows * width + 2 * width) * es, 30 * rows * width,
                   library_is="gelu_backward(dy, x + b) and its .sum(0)")


def quant_peers(torch, gen, spec, n, sb, offset=0):
    """n peers' quantized shards of sb blocks, peer-major as all_to_all
    delivers them, from gradient-like data: each block's magnitude drawn
    log-uniform in [1e-3, 1], so none lies far below the tolerances; with
    ``offset`` the payload is a view ``offset`` bytes into a larger
    buffer, so its base is not 16-byte aligned."""
    from paddle_tpu_torch.ops.quantize_wire import quantize_blockwise
    dev = torch.device("cuda", 0)
    x = torch.randn(n * sb, spec.block_size, generator=gen, device=dev)
    x *= 10.0 ** (-3 * torch.rand(n * sb, 1, generator=gen, device=dev))
    q, s = quantize_blockwise(x.reshape(-1), spec)
    if offset:
        buf = torch.empty(q.numel() + offset, dtype=torch.int8, device=dev)
        buf[offset:].copy_(q.reshape(-1))
        q = buf[offset:].view(q.shape)
    return q, s


def quant_kernel_checks(torch, results):
    """#11 and #12 against their plain versions at the shard shapes of
    BERT-base's gradient buckets; the first row of each is its main-path
    shape (n = 2, the word-embedding bucket's 45,783 blocks: #12 in the
    int8 tier, #11 in the int4 tier)."""
    from paddle_tpu_torch.ops.cuda import quant_kernels as QK
    from paddle_tpu_torch.ops.quantize_wire import CompressionSpec
    gen = torch.Generator(device=torch.device("cuda", 0)).manual_seed(
        SEED + 4)
    record = recorder(results)
    # (wire dtype, block, peers, shard blocks, payload offset)
    cases = [("int4", 256, 2, 45783, 0), ("int8", 256, 2, 45783, 0),
             ("int8", 256, 2, 13844, 0), ("int4", 256, 2, 13844, 0),
             ("int4", 128, 2, 13844, 0), ("int8", 256, 4, 1003, 0),
             ("int8", 256, 8, 1003, 0), ("int4", 256, 8, 1003, 0),
             ("int4", 128, 4, 1003, 0), ("int8", 256, 2, 1003, 1),
             ("int4", 128, 2, 1003, 3)]
    for dtype, block, n, sb, offset in cases:
        spec = CompressionSpec(dtype, block)
        q, s = quant_peers(torch, gen, spec, n, sb, offset)
        shape = [n, sb, block, dtype] + (["unaligned"] if offset else [])
        what = f"n={n} SB={sb} {dtype} block {block}" + \
            (f" payload at +{offset} bytes" if offset else "")
        in_bytes = q.numel() + 4 * s.numel()
        elems = sb * block
        acc = QK.dequant_accumulate(q, s, spec, n)
        ref = QK.dequant_accumulate_plain(q, s, spec, n)
        err = agree(torch, f"dequant_accumulate {what}", acc, ref, "float32",
                    TOL_DQ_ACC)
        # and block by block, of the block's own max|plain|, so a block of
        # small values is held as tightly as a large one
        blocks_ref = ref.reshape(sb, block)
        block_err = float(((acc.reshape(sb, block) - blocks_ref).abs()
                           .amax(1) / blocks_ref.abs().amax(1)
                           .clamp_min(1e-30)).max())
        log(f"  dequant_accumulate {what}: worst block max|Δ| / max|plain| "
            f"{block_err:.3e} (tolerance {TOL_DQ_ACC_BLOCK:.0e})")
        check(block_err <= TOL_DQ_ACC_BLOCK,
              f"dequant_accumulate {what}: a block disagrees with its plain "
              f"version ({block_err:.3e} of its max)")
        record("dequant_accumulate", shape, "float32", err,
               time_ms(torch, lambda: QK.dequant_accumulate(q, s, spec, n)),
               time_ms(torch, lambda: QK.dequant_accumulate_plain(
                   q, s, spec, n)), None,
               in_bytes + 4 * elems, 2 * n * elems)
        if dtype != "int8":
            continue
        q2, s2 = QK.dequant_accumulate_requant(q, s, spec, n)
        p2, t2 = QK.dequant_accumulate_requant_plain(q, s, spec, n)
        differ = int((q2 != p2).sum())
        serr = max_err(torch, s2, t2)
        log(f"  dequant_accumulate_requant {what}: payload bytes that differ "
            f"{differ} (must be 0), scales max|Δ| {serr:.3e} (tolerance "
            f"{TOL_DQ_SCALE:.0e})")
        check(differ == 0, f"dequant_accumulate_requant {what}: payload not "
                           f"bit-identical to its plain version")
        check(serr <= TOL_DQ_SCALE, f"dequant_accumulate_requant {what}: "
                                    f"scales disagree ({serr:.3e})")
        # per element: n fused multiply-adds, then |x|, max, a division,
        # rint and the clip: ~6 more
        record("dequant_accumulate_requant", shape, "float32", serr,
               time_ms(torch, lambda: QK.dequant_accumulate_requant(
                   q, s, spec, n)),
               time_ms(torch, lambda: QK.dequant_accumulate_requant_plain(
                   q, s, spec, n)), None,
               in_bytes + elems + 4 * sb, (2 * n + 6) * elems,
               payload_bytes_differ=differ)


# ---------------------------------------------------------------------------
# phase 10: data-parallel BERT-base, two ranks on the one card
# ---------------------------------------------------------------------------


def build_dp_train(cfg, tier):
    """Phase 10's program as a rank writes it: phase 8's recipe and both
    fusion passes, through ``fleet`` with the ``tier`` quantized gradient
    all-reduce.  Returns (fleet.main_program, startup, loss, LR var)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = SEED
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        s = DistributedStrategy()
        s.quant_allreduce = True
        s.quant_configs = {"dtype": tier, "block_size": 256,
                           "stochastic_rounding": False}
        s.build_strategy = fluid.BuildStrategy()
        s.build_strategy.fuse_elewise_add_act_ops = True
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(PEAK_LR, DECAY_STEPS, 0.0,
                                          power=1.0),
            WARMUP_STEPS, 0.0, PEAK_LR)
        inner = fluid.optimizer.AdamW(
            lr, weight_decay=WEIGHT_DECAY,
            grad_clip=fluid.clip.GradientClipByGlobalNorm(CLIP_NORM))
        fleet.distributed_optimizer(inner, s).minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    return fleet.main_program, startup, total, inner.learning_rate_var


def params_digest(np, scope, program):
    """sha256 over every parameter's bytes, in name order."""
    import hashlib
    h = hashlib.sha256()
    for p in sorted(program.all_parameters(), key=lambda v: v.name):
        h.update(p.name.encode())
        h.update(np.ascontiguousarray(
            scope.find_var(p.name).detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def moment1_tensors(scope, program):
    """Adam's first moment of every parameter, by accumulator name."""
    return {v.name: scope.find_var(v.name) for v in program.list_vars()
            if v.persistable and "_moment1_" in v.name}


def timed_collectives(torch):
    """Wrap the gloo transfers of ops/collective_ops.py so one step can
    report their wall time (synchronised first, so the time is the
    transfer's and not the queued work's).  Returns (totals, undo)."""
    from paddle_tpu_torch.ops import collective_ops as C
    totals = {"ms": 0.0, "calls": 0}
    saved = {n: getattr(C, n) for n in ("all_to_all", "all_gather",
                                        "all_reduce")}

    def wrap(fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            totals["ms"] += (time.perf_counter() - t0) * 1e3
            totals["calls"] += 1
            return out
        return timed

    for n, fn in saved.items():
        setattr(C, n, wrap(fn))

    def undo():
        for n, fn in saved.items():
            setattr(C, n, fn)
    return totals, undo


def dp_leg(torch, np, cfg, tier, steps, measure, moments_path=None):
    """One leg on this rank: ``steps`` steps of the data-parallel program
    through prepare(donate_state=True) on the global batch, counts from
    zero before and read after; with ``measure`` one profiled step and
    one step with the collectives timed follow; with ``moments_path`` the
    Adam first moments are saved there for the parent."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    program, startup, total, lr_var = build_dp_train(cfg, tier)
    check(program._dp is not None and program._dp.world == DP_RANKS,
          f"fleet.main_program is not data-parallel over {DP_RANKS} ranks")
    buckets = sum(op.type == "c_fused_quant_allreduce_sum"
                  for op in program._program.global_block().ops)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    exe.run(startup, scope=scope)
    prepared = exe.prepare(program, fetch_list=[total, lr_var], scope=scope,
                           donate_state=True)

    def step():
        handle, lr = prepared.run(feed)
        return float(handle), float(lr)

    kernels.reset_launch_counts()
    registry.reset_route_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, _ = step()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = kernels.launch_counts()
    fallbacks = registry.route_counts("fallback")
    fluid.sync_prepared_state(scope)
    out = {"tier": tier, "buckets": buckets, "losses": losses,
           "step_s": step_s, "launches": launches,
           "fallbacks": {str(k): v for k, v in fallbacks.items()},
           "params_sha256": params_digest(np, scope, program._program)}
    if moments_path:
        torch.save({n: t.detach().cpu() for n, t in
                    moment1_tensors(scope, program._program).items()},
                   moments_path)
    if measure:
        steady = statistics.median(step_s[2:])
        out["step_ms_median_3_10"] = steady * 1e3
        out["profile"] = profile_step(torch, step, steady * 1e3)
        totals, undo = timed_collectives(torch)
        try:
            t0 = time.perf_counter()
            step()
            out["collectives_step_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            undo()
        out["collectives_ms"] = totals["ms"]
        out["collective_calls"] = totals["calls"]
    del prepared, scope
    return out


def dp_worker(out_dir):
    """One rank of phase 10 (started by the launcher with
    ``--dp-worker``): writes ``rank<r>.json`` to ``out_dir``; any failed
    check exits non-zero, which fails the launch and the phase."""
    import dataclasses
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
    from paddle_tpu_torch.models import bert
    torch.backends.cuda.matmul.allow_tf32 = False
    fleet.init(PaddleCloudRoleMaker())
    rank = fleet.worker_index()
    dev = torch.device("cuda", fleet.place.device_id)
    res = {"rank": rank, "world": fleet.worker_num(),
           "backend": fleet.backend, "place": repr(fleet.place),
           "device": torch.cuda.get_device_name(dev)}
    log(f"[rank {rank}] {res}")
    check(res["backend"] == "gloo", f"rank {rank} on {res['backend']}")
    base = bert.BertConfig.base()
    per_step = dict(FUSED_LAUNCHES)
    for tier, steps, kernel in (("int8", TRAIN_STEPS,
                                 "dequant_accumulate_requant"),
                                ("int4", DP_INT4_STEPS,
                                 "dequant_accumulate")):
        leg = dp_leg(torch, np, base, tier, steps, measure=tier == "int8")
        res[tier] = leg
        log(f"[rank {rank}] {tier}: {leg['buckets']} buckets, losses "
            f"{[round(x, 5) for x in leg['losses']]}, step times (s) "
            f"{[round(x, 4) for x in leg['step_s']]}, launches "
            f"{leg['launches']}")
        check(leg["buckets"] == DP_BUCKETS,
              f"{tier}: {leg['buckets']} quantized buckets, expected "
              f"{DP_BUCKETS}")
        check(not leg["fallbacks"], f"{tier}: route fallbacks "
                                    f"{leg['fallbacks']}")
        check(all(math.isfinite(x) for x in leg["losses"]),
              f"{tier}: non-finite loss {leg['losses']}")
        check(leg["losses"][-1] < leg["losses"][0],
              f"{tier}: the loss did not fall: {leg['losses']}")
        want = dict(per_step, **{kernel: DP_BUCKETS})
        for name, n in leg["launches"].items():
            check(n == want.get(name, 0) * steps,
                  f"{tier}: {name} launched {n} times in {steps} steps, "
                  f"expected {want.get(name, 0)} per step")
    cfg0 = dataclasses.replace(base, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    res["dropout0_int8"] = dp_leg(
        torch, np, cfg0, "int8", PLAIN_STEPS, measure=False,
        moments_path=os.path.join(out_dir, "moment1.pt") if rank == 0
        else None)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def single_gpu_run(torch, np, cfg):
    """PLAIN_STEPS steps of phase 8's program on one GPU on the global
    batch (the data-parallel run's reference): the losses and the Adam
    first moments after them."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    program, startup, total, _ = build_fused_train(cfg)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    prepared = exe.prepare(program, fetch_list=[total], scope=scope,
                           donate_state=True)
    losses = [float(prepared.run(feed)[0]) for _ in range(PLAIN_STEPS)]
    fluid.sync_prepared_state(scope)
    moments = {n: t.detach().clone() for n, t in
               moment1_tensors(scope, program._program).items()}
    del prepared, scope
    return losses, moments


def dp_phase(torch, np, repo, cfg):
    """Launch the two ranks, hold their results against each other and
    the dropout-free leg against one GPU: the losses at the int8 tier's
    bound, and the Adam first moments, which a wrong reduction moves."""
    import dataclasses
    from paddle_tpu_torch.ops.cuda import build
    out_dir = os.path.join(build.BUILD_DIR, "smoke_dp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(DP_RANKS), "--selected_gpus", "0,0",
           "--backend", "gloo", "--timeout", str(DP_TIMEOUT_S),
           os.path.join(repo, "chip_smoke.py"), "--dp-worker", out_dir]
    log("  " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=repo, timeout=DP_TIMEOUT_S + 60).returncode
    log(f"  the ranks ran {time.perf_counter() - t0:.1f} s, exit code {rc}")
    check(rc == 0, f"a data-parallel rank failed (launcher exit code {rc})")
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for leg in ("int8", "int4", "dropout0_int8"):
        digests = {r[leg]["params_sha256"] for r in ranks}
        log(f"  {leg}: parameter sha256 per rank "
            f"{[r[leg]['params_sha256'][:16] for r in ranks]}")
        check(len(digests) == 1, f"{leg}: the ranks' parameters differ")
        losses = {tuple(r[leg]["losses"]) for r in ranks}
        check(len(losses) == 1, f"{leg}: the ranks fetched other losses")
    for r in ranks:
        m = r["int8"]
        prof = m.get("profile") or {}
        log(f"  rank {r['rank']} ({r['place']}, {r['backend']}, "
            f"{r['device']}): int8 step median of steps 3-{TRAIN_STEPS} "
            f"{m['step_ms_median_3_10']:.2f} ms; device busy "
            + (f"{100 * prof['busy_share']:.1f} % of it"
               if prof else "not measured")
            + f"; collectives (gloo staged through the host, two ranks on "
            f"one card: no measure of NVLink) {m['collectives_ms']:.2f} ms "
            f"in {m['collective_calls']} calls of a "
            f"{m['collectives_step_ms']:.2f} ms step")
    cfg0 = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    single, single_m = single_gpu_run(torch, np, cfg0)
    dp = ranks[0]["dropout0_int8"]["losses"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(dp, single))
    log(f"  dropout 0, {PLAIN_STEPS} steps: two ranks int8 "
        f"{[round(x, 6) for x in dp]} vs one GPU "
        f"{[round(x, 6) for x in single]}: max relative gap {gap:.3e} "
        f"(tolerance {TOL_DP_INT8:.0e}, the int8 tier's bound)")
    check(gap <= TOL_DP_INT8, "two-rank int8 training strays from one GPU")
    dp_m = torch.load(os.path.join(out_dir, "moment1.pt"),
                      map_location=torch.device("cuda", 0))
    check(dp_m.keys() == single_m.keys() and len(single_m) > 0,
          "the two runs' Adam moments do not name the same parameters")
    num = den = 0.0
    worst, worst_name = 0.0, None
    for n, ref in single_m.items():
        d2 = float((dp_m[n].double() - ref.double()).pow(2).sum())
        r2 = float(ref.double().pow(2).sum())
        num, den = num + d2, den + r2
        rel = math.sqrt(d2 / r2) if r2 else math.sqrt(d2)
        if rel > worst:
            worst, worst_name = rel, n
    m_gap = math.sqrt(num / den)
    log(f"  dropout 0, {PLAIN_STEPS} steps: Adam first moments, two ranks "
        f"int8 vs one GPU, relative norm over {len(single_m)} parameters "
        f"{m_gap:.3e} (tolerance {TOL_DP_MOMENTS:.3e}, four int8 quanta); "
        f"worst parameter {worst_name} {worst:.3e}")
    check(m_gap <= TOL_DP_MOMENTS,
          "two-rank int8 gradients stray from one GPU's (Adam moments)")
    del dp_m, single_m
    return ranks, {"single_gpu_losses": single, "dp_int8_losses": dp,
                   "max_rel_gap": gap, "moment1_rel_gap": m_gap,
                   "moment1_worst": [worst_name, worst]}


# ---------------------------------------------------------------------------
# phase 7: BERT-base training through the port
# ---------------------------------------------------------------------------


def build_train(cfg):
    """Phase 7's program: pretraining + Adam(1e-4), run as it is.
    Returns (the program to run, startup, loss, LR var)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.framework.core import Program, program_guard
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = Program(), Program()
    startup.random_seed = main.random_seed = SEED
    with program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        opt = fluid.optimizer.Adam(PEAK_LR)
        opt.minimize(total)
    return main, startup, total, opt.learning_rate_var


def build_fused_train(cfg):
    """Phase 8's program, as a user writes it: the recipe, then both
    fusion passes (``fuse_elemwise_add_act`` through the build
    strategy).  Returns (the CompiledProgram, startup, loss, LR var)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.framework.core import Program, program_guard
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.framework.passes import apply_pass
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = Program(), Program()
    startup.random_seed = main.random_seed = SEED
    with program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(PEAK_LR, DECAY_STEPS, 0.0,
                                          power=1.0),
            WARMUP_STEPS, 0.0, PEAK_LR)
        opt = fluid.optimizer.AdamW(
            lr, weight_decay=WEIGHT_DECAY,
            grad_clip=fluid.clip.GradientClipByGlobalNorm(CLIP_NORM))
        opt.minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    bs = fluid.BuildStrategy()
    bs.fuse_elewise_add_act_ops = True
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=total.name, build_strategy=bs)
    return compiled, startup, total, opt.learning_rate_var


def scheduled_lr(step):
    """The recipe's LR for run ``step`` (0-based), in closed form."""
    if step < WARMUP_STEPS:
        return PEAK_LR * step / WARMUP_STEPS
    return PEAK_LR * (1.0 - min(step, DECAY_STEPS) / DECAY_STEPS)


# the port's kernels by their CUDA function names (csrc/*.cu)
PORT_KERNEL_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                     "flash_bwd_dkv_kernel", "ln_fwd_kernel", "ln_bwd_kernel",
                     "ln_bwd_colsum_kernel", "bias_gelu_fwd_kernel",
                     "bias_gelu_bwd_kernel", "bias_gelu_bwd_colsum_kernel",
                     "adam_kernel", "dq_acc_kernel", "dq_acc_requant_kernel")


def profile_step(torch, step, step_ms):
    """Device time of one training step by kernel, from torch.profiler:
    the port's kernels, the matrix products (cuBLAS / CUTLASS gemm) and
    everything else, and the device's busy share of ``step_ms`` (the
    median unprofiled step).  None when the profiler saw no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by_name:
        log("  device time by kernel: not measured (the profiler saw no "
            "device activity)")
        return None
    groups = {"port kernels": 0.0, "matrix products": 0.0, "other": 0.0}
    for name, (_, us) in by_name.items():
        low = name.lower()
        if any(k in name for k in PORT_KERNEL_NAMES):
            groups["port kernels"] += us / 1e3
        elif "gemm" in low or "cutlass" in low:
            groups["matrix products"] += us / 1e3
        else:
            groups["other"] += us / 1e3
    busy = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    log(f"  one profiled step: device busy {busy:.2f} ms of the "
        f"{step_ms:.2f} ms median step ({100 * busy / step_ms:.1f} %); "
        + ", ".join(f"{g} {ms:.2f} ms" for g, ms in groups.items()))
    for name, (n, us) in top:
        log(f"    {us / 1e3:8.3f} ms  {n:4d}x  {name[:110]}")
    return {"busy_ms": busy, "step_ms": step_ms,
            "busy_share": busy / step_ms, "groups_ms": groups,
            "top": [{"name": name[:200], "calls": n, "ms": us / 1e3}
                    for name, (n, us) in top]}


def train_phase(torch, np, cfg, build, expected, schedule=None):
    """TRAIN_STEPS steps of ``build(cfg)``'s program through
    prepare(donate_state=True), dropout as cfg says, each kernel launched
    exactly ``expected`` times per step and no other; the LR fetched each
    step equals ``schedule(step)`` when given.  Then one more step under
    the profiler."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops import registry
    program, startup, total, lr_var = build(cfg)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    scope = fluid.Scope()
    exe = fluid.Executor()                       # CUDAPlace(0)
    exe.run(startup, scope=scope)
    params = program.all_parameters()
    n_params = sum(math.prod(p.shape) for p in params)
    prepared = exe.prepare(program, fetch_list=[total, lr_var], scope=scope,
                           donate_state=True)
    ops = [op.type for op in prepared._program.global_block().ops]
    log(f"  program run: {len(ops)} ops, "
        + ", ".join(f"{ops.count(t)} {t}" for t in (
            "fused_add_layernorm", "layer_norm",
            "fused_elemwise_activation", "fused_attention", "adam",
            "adamw")))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step():
        handle, lr = prepared.run(feed)
        return float(handle), float(lr)          # waits for the step

    # the main path: counts from zero, TRAIN_STEPS steps, read right after
    kernels.reset_launch_counts()
    registry.reset_route_counts()
    losses, lrs, step_s = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, lr = step()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        lrs.append(lr)
    launches = kernels.launch_counts()
    routes = registry.route_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(step_s[2:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"  BERT-base pretraining ({n_params} parameters, {len(params)} "
        f"tensors), batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_MASKS} masks "
        f"per sequence, dropout {cfg.hidden_dropout_prob}/"
        f"{cfg.attention_probs_dropout_prob}")
    log(f"  losses: {[round(x, 5) for x in losses]}")
    log(f"  learning rates: {lrs}")
    log(f"  step times (s): {[round(x, 4) for x in step_s]}")
    log(f"  training step: median of steps 3-{TRAIN_STEPS} {steady * 1e3:.2f} "
        f"ms, {TRAIN_BATCH / steady:.2f} sequences/s, {tokens / steady:.1f} "
        f"tokens/s; peak device memory {peak_gib:.2f} GiB")
    log(f"  launches over {TRAIN_STEPS} steps: {launches}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    fallbacks = {k: v for k, v in routes.items() if k[2] == "fallback"}
    check(not fallbacks, f"route fallbacks on the training path: "
                         f"{fallbacks}")
    for name, n in launches.items():
        per_step = expected.get(name, 0)
        check(n == per_step * TRAIN_STEPS,
              f"{name}: {n} launches in {TRAIN_STEPS} steps, expected "
              f"{per_step} per step")
    if schedule is not None:
        lr_err = max(abs(lr - schedule(i)) / PEAK_LR
                     for i, lr in enumerate(lrs))
        log(f"  LR vs the closed-form schedule: max |Δ| / peak {lr_err:.3e} "
            f"(tolerance {TOL_LR:.0e})")
        check(lr_err <= TOL_LR, f"the LR does not follow the schedule: {lrs}")
    profile = profile_step(torch, step, steady * 1e3)
    del prepared, scope
    return launches, {"losses": losses, "lrs": lrs, "step_s": step_s,
                      "step_ms_median_3_10": steady * 1e3,
                      "sequences_per_s": TRAIN_BATCH / steady,
                      "tokens_per_s": tokens / steady,
                      "parameters": n_params, "peak_gib": peak_gib,
                      "profile": profile}


def train_plain_phase(torch, np, cfg, build, expected):
    """Dropout 0: PLAIN_STEPS steps of ``build``'s program through
    Executor.run with every kernel on (each launched ``expected`` times
    per step), and again with every kernel flag off, from the same
    startup; losses and step-1 grads agree."""
    import dataclasses
    from paddle_tpu_torch import flags, fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    cfg0 = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    program, startup, total, _ = build(cfg0)
    feed = bert.make_fake_batch(np.random.RandomState(SEED), cfg0,
                                TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKS)
    grad_names = [p.name + "@GRAD" for p in program.all_parameters()]

    def run(kernels_on):
        flags.set_flags({"use_flash_attention": kernels_on,
                         "use_pallas_fused": kernels_on})
        try:
            scope = fluid.Scope()
            exe = fluid.Executor()
            exe.run(startup, scope=scope)
            kernels.reset_launch_counts()
            losses, grads = [], None
            for i in range(PLAIN_STEPS):
                fetch = [total] + (grad_names if i == 0 else [])
                out = exe.run(program, feed=feed, fetch_list=fetch,
                              scope=scope)
                losses.append(float(out[0]))
                if i == 0:
                    grads = out[1:]
            return losses, grads, kernels.launch_counts()
        finally:
            flags.set_flags({"use_flash_attention": True,
                             "use_pallas_fused": True})

    k_losses, k_grads, k_launches = run(True)
    p_losses, p_grads, p_launches = run(False)
    check(sum(p_launches.values()) == 0, "the plain path launched a kernel")
    check(all(k_launches[n] == per_step * PLAIN_STEPS
              for n, per_step in expected.items()),
          f"the kernel path launched {k_launches}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
    grad_err, worst = 0.0, ""
    for n, a, b in zip(grad_names, k_grads, p_grads):
        e = max_abs(np, a, b) / max(float(np.abs(b).max()), 1e-30)
        if e > grad_err:
            grad_err, worst = e, n
    log(f"  dropout 0, {PLAIN_STEPS} steps: losses kernels "
        f"{[round(x, 6) for x in k_losses]} vs plain "
        f"{[round(x, 6) for x in p_losses]}: max relative Δ {loss_err:.3e} "
        f"(tolerance {TOL_TRAIN_LOSS:.0e}); step-1 grads: max |Δ| / "
        f"max|grad| {grad_err:.3e} at {worst} (tolerance "
        f"{TOL_TRAIN_GRAD:.0e})")
    check(loss_err <= TOL_TRAIN_LOSS, "training loss: kernels disagree with "
                                      "the plain path")
    check(grad_err <= TOL_TRAIN_GRAD, f"step-1 grad of {worst}: kernels "
                                      f"disagree with the plain path")
    return {"plain_losses": p_losses, "kernel_losses": k_losses,
            "loss_max_rel": loss_err, "grad_max_rel": grad_err,
            "grad_worst": worst}


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


# kernel -> (the path whose launches it reports, its row's name in the
# per-kernel results); the first float32 row is the main-path shape
KERNEL_PATHS = {
    "flash_attention_fwd": ("served", "flash_attention_fwd"),
    "add_layer_norm_fwd": ("served", "add_layer_norm_fwd"),
    "bias_gelu_fwd": ("served", "bias_gelu_fwd"),
    "layer_norm_fwd": ("unfused", "layer_norm_fwd"),
    "flash_attention_bwd_dq": ("train", "flash_attention_bwd_dq"),
    "flash_attention_bwd_dkv": ("train", "flash_attention_bwd_dkv"),
    "layer_norm_bwd": ("train", "layer_norm_bwd"),
    "adam": ("train", "adam"),
    "add_layer_norm_bwd": ("fused_train", "add_layer_norm_bwd"),
    "bias_gelu_bwd": ("fused_train", "bias_gelu_bwd"),
    "dequant_accumulate": ("dp_int4", "dequant_accumulate"),
    "dequant_accumulate_requant": ("dp_int8", "dequant_accumulate_requant"),
}


def kernels_line(per_kernel, launches_by_path):
    """One entry per kernel, at its main-path shape, float32: served rows
    8 x 128 (flash B = 8, S = 128, padding bias), training B = 32, S = 128
    (flash with dropout 0.1; LayerNorm and add+LN rows 4096; bias+GELU
    rows 4096 x 3072; Adam the word embedding's launch), and the
    quantized all-reduce's receive stage at the word-embedding bucket's
    shard (n = 2, SB = 45,783; #12 int8, #11 int4, launches from rank 0 of
    phase 10).  Sources and the TPU kernels replaced come from the port's
    route table; a kernel also launched on another path carries
    ``train_launches`` (phase 7) and ``fused_train_launches`` (phase 8),
    and flash forward its dropout variant's times."""
    from paddle_tpu_torch.ops.op_specs import kernel_facts
    facts = kernel_facts()
    out = []
    for name, (path, rows_name) in KERNEL_PATHS.items():
        rows = [r for r in per_kernel[rows_name] if r["dtype"] == "float32"]
        main = rows[0]
        entry = {
            "name": name, "route": "cuda", "source": facts[name][0],
            "replaces": facts[name][1],
            "launches": launches_by_path[path][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "dtype": "float32", "path": path}
        for other in ("train", "fused_train", "dp_int8", "dp_int4"):
            if path != other and launches_by_path[other].get(name):
                entry[other + "_launches"] = launches_by_path[other][name]
        if name == "flash_attention_fwd":
            drop = [r for r in per_kernel["flash_attention_fwd_dropout"]
                    if r["dtype"] == "float32"][0]
            entry["dropout"] = {k: drop[k] for k in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err")}
        out.append(entry)
    return {"kernels": out}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
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
    if argv[:1] == ["--dp-worker"]:
        try:
            return dp_worker(argv[1])
        except SmokeFailure as e:
            print(f"chip_smoke: rank FAILED: {e}", file=sys.stderr)
            return 1
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

        log("phase 6: training kernels vs plain versions")
        from paddle_tpu_torch.models import bert
        base = bert.BertConfig.base()
        flash_training_checks(torch, per_kernel)
        ln_adam_training_checks(torch, per_kernel, base)
        fused_training_checks(torch, per_kernel, base)

        log("phase 7: BERT-base trained through the port")
        trained, training = train_phase(torch, np, base, build_train,
                                        TRAIN_LAUNCHES)
        training.update(train_plain_phase(torch, np, base, build_train,
                                          TRAIN_LAUNCHES))

        log(f"phase 8: BERT-base trained through the fused program and the "
            f"published recipe (AdamW {WEIGHT_DECAY}, global-norm clip "
            f"{CLIP_NORM}, LR {PEAK_LR} decayed over {DECAY_STEPS} steps; "
            f"warmup cut from the published 10,000 steps to {WARMUP_STEPS} "
            f"so the loss moves within {TRAIN_STEPS} steps)")
        fused, fused_training = train_phase(
            torch, np, base, build_fused_train, FUSED_LAUNCHES,
            schedule=scheduled_lr)
        fused_training.update(train_plain_phase(
            torch, np, base, build_fused_train, FUSED_LAUNCHES))

        log("phase 9: quantized all-reduce receive-stage kernels vs plain "
            "versions")
        quant_kernel_checks(torch, per_kernel)

        log(f"phase 10: data-parallel BERT-base, {DP_RANKS} ranks on one "
            f"card over gloo, int8 tier {TRAIN_STEPS} steps, int4 tier "
            f"{DP_INT4_STEPS} steps")
        dp_ranks, dp_parity = dp_phase(torch, np, repo, base)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)

    log(f"phase 11: report ({time.perf_counter() - t_start:.1f} s in all)")
    log("serving " + json.dumps(serving))
    log("training " + json.dumps(training))
    log("fused_training " + json.dumps(fused_training))
    log("data_parallel " + json.dumps({"ranks": dp_ranks,
                                       "parity": dp_parity}))
    log("kernel_rows " + json.dumps(per_kernel))
    print(json.dumps(kernels_line(per_kernel, {
        "served": served, "unfused": unfused, "train": trained,
        "fused_train": fused, "dp_int8": dp_ranks[0]["int8"]["launches"],
        "dp_int4": dp_ranks[0]["int4"]["launches"]})))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
