#!/usr/bin/env python3
"""A/B timing of the port's attention, optimizer, LayerNorm forward and
quantized all-reduce receive-stage kernels on one CUDA card, across
checkouts of the repository.

    python3 tools/torch_kernel_ab.py ROOT [ROOT ...] [--out FILE]
                                     [--only fwd,bwd,amp,adam,ln_fwd,quant]

Each ROOT is a checkout holding ``paddle_tpu_torch``.  Each runs in its own
process, in the order given (to compare a parent P with a change C on one
card: P C C P), builds its flash-attention and Adam libraries and measures,
through the checkout's own wrappers and executor:

* the flash forward (``flash_fwd``, replaces ``_fwd_kernel``) at BERT-base's
  training shapes B32 H12 S128 and B8 H12 S512, D 64, float32 and bf16, at
  dropout 0.1 and 0, with the head-shared padding bias and causal, beside
  ``F.scaled_dot_product_attention`` at the same rate; and the served row,
  B8 H12 S128 float32 with the padding bias and no dropout.  Each case is
  held against the plain twin (o, and lse over max(1, |lse|)) and bit for
  bit across two launches;
* the backward pair (dk/dv, then dq; replaces ``_bwd_dkv_kernel`` and
  ``_bwd_dq_kernel``) at the same training shapes with the padding bias,
  float32 and bf16, dropout 0.1 and 0, against the twin (max |d| over
  max(1, max|plain|)) and bit for bit across two launches, beside the
  library's backward (``torch.autograd.grad`` through SDPA at the same
  rate), and ``delta = rowsum(dO * O)``, the two PyTorch ops the
  wrapper runs beside the pair;
* the same forward and backward pair at the bf16 program's shape
  (``amp``: B96 H12 S128 D64, the padding bias, dropout 0.1 and 0), in
  bf16 and, where the checkout's gate takes it, float16;
* the whole Adam update of a BERT-base step as the checkout's executor
  runs it (``framework.executor.run_ops`` over the 158 ``adam`` ops of
  ``Adam(1e-4)``, and over the 158 ``adamw`` ops of the published recipe:
  AdamW 0.01, global-norm clip, warmup and linear decay), in place as a
  prepared step runs it (``donate_state``): device time by kernel and the
  launches per update from ``torch.profiler`` (the port's Adam kernel
  apart from everything else: the step size, the beta powers and the
  decay passes), the span between two CUDA events, and the host's
  enqueue time; beside ``torch._fused_adam_`` and ``torch._fused_adamw_``
  called once over the same 158 tensors;
* the LayerNorm forwards (``ln_fwd``): ``layer_norm_fwd`` (replaces
  ``_ln_fwd_kernel``) and ``add_layer_norm_fwd`` (replaces
  ``_aln_fwd_kernel``) at D 768 and R 128, 512, 1024 and 4096 (the served
  B1, B4 and B8 x S128 and B8 x S512, and the training rows), float32 and
  bf16, each held against its plain twin and bit for bit across two
  launches, timed alone (L2 warm, and flushed before each sample) and as
  a chain of CHAIN launches back to back (per launch: what a launch
  costs behind another kernel), beside
  ``F.layer_norm`` (for the add: a + b then ``F.layer_norm``, and
  ``F.layer_norm`` alone on the sum made beforehand), its device time from
  the profiler and its bound (bytes over 3.35 TB/s);
* the quantized all-reduce's receive stage (``quant``): #12
  ``dequant_accumulate_requant`` (int8, replaces ``_dq_acc_requant_kernel``)
  and #11 ``dequant_accumulate`` (int4, replaces ``_dq_acc_kernel``) at
  n = 2 and block 256 at the shard shapes of a BERT-base step's buckets
  (``chip_smoke.STEP_BUCKET_SB``: SB 45,783, 14,618, 13,844, 16,217), each
  held against its plain twin (#12's payload bytes that differ, #11's max
  |d|) and bit for bit across two launches, timed alone (L2 warm, and
  flushed before each sample), by profiler device time, beside the twin
  and the bound; and the step's 13 launches in bucket order as one chain
  (events, and the sum of the profiled device times).

``--only`` keeps the named groups of measurements.  Kernel times are CUDA
events, median of 25 (the Adam update: of 9), with
the L2 cache warm from the previous sample, as ``chip_smoke.py`` times
them (``time_ms``, ``kernel_split_ms`` and the bounds' peaks are taken
from the ``chip_smoke.py`` beside this script).  Prints one line per
measurement and the card's name and power limit, and writes every number
as JSON to FILE (default ``paddle_tpu_torch/_build/kernel_ab.json``).  Imports torch
and the port only."""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_SHAPES = ((32, 128), (8, 512))    # (batch, sequence), 12 heads, D 64
SERVED_SHAPE = (8, 128)
AMP_SHAPE = (96, 128)                   # bench.py's bf16 pretraining batch
AMP_DTYPES = ("bfloat16", "float16")
HEADS, HEAD_DIM = 12, 64
RATES = (0.1, 0.0)
SEED = 2024
ADAM_SAMPLES = 9
QUANT_SHAPES = (45783, 14618, 13844, 16217)
LN_ROWS = (128, 512, 1024, 4096)
LN_D = 768
CHAIN = 16
FLUSH_BYTES = 64 << 20        # more than the H100's 50 MB L2


def profile_calls(torch, fn, calls=5):
    """{kernel name: (launches per call, device ms per call)} from one
    profiled run of ``calls`` calls of ``fn`` (a second when the first saw
    no device activity)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                m = re.search(r"(\w+)(<[^(]*>)?\(", e.name)
                name = m.group(1) if m else e.name[:60]
                n, ms = out.get(name, (0.0, 0.0))
                out[name] = (n + 1 / calls,
                             ms + e.time_range.elapsed_us() / 1e3 / calls)
        if out:
            break
    return out


def forward_rows(torch, FA, C, dev, gen, seed, cases=None):
    """The forward's rows at (dtype, batch, seq, mode, rate) ``cases``
    (default: the training shapes and the served row)."""
    import torch.nn.functional as F
    rows = []
    if cases is None:
        cases = [(dt, b, s, mode, rate)
                 for dt in ("float32", "bfloat16") for b, s in TRAIN_SHAPES
                 for mode in ("padding-bias", "causal") for rate in RATES]
        cases.append(("float32", SERVED_SHAPE[0], SERVED_SHAPE[1],
                      "padding-bias served", 0.0))
    for dtname, bsz, seq, mode, rate in cases:
        dt = getattr(torch, dtname)
        es = torch.finfo(dt).bits // 8
        bh, d = bsz * HEADS, HEAD_DIM
        q, k, v = (torch.randn(bh, seq, d, generator=gen, device=dev).to(dt)
                   for _ in range(3))
        causal = mode == "causal"
        bias = None if causal else C.padding_bias(torch, gen, dev, bsz, seq)
        o, lse = FA.flash_fwd(q, k, v, bias, causal, rate, seed)
        o2, lse2 = FA.flash_fwd(q, k, v, bias, causal, rate, seed)
        po, plse = FA.flash_fwd_plain(q, k, v, bias, causal, rate, seed)
        err_o = float((o.float() - po.float()).abs().max())
        top = float(po.float().abs().max())
        err_lse = float(((lse - plse).abs() / plse.abs().clamp_min(1.0))
                        .max())
        q4, k4, v4 = (t.view(bsz, HEADS, seq, d) for t in (q, k, v))
        mask4 = None if bias is None else bias.view(bsz, 1, seq, seq).to(dt)

        def lib():
            return F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask4, is_causal=causal, dropout_p=rate)
        pairs = seq * (seq + 1) // 2 if causal else seq * seq
        nbytes = 4 * bh * seq * d * es + bh * seq * 4 + \
            (0 if bias is None else bias.numel() * 4)
        flops = 4 * bh * pairs * d
        row = {"kernel": "fwd", "dtype": dtname, "batch": bsz,
               "heads": HEADS, "seq": seq, "d": d, "mode": mode,
               "dropout": rate, "err_o": err_o,
               "err_o_rel_bf16": err_o / max(top, 1e-30),
               "err_lse": err_lse,
               "bit_identical": bool(torch.equal(o, o2) and
                                     torch.equal(lse, lse2)),
               "ms": C.time_ms(torch, lambda: FA.flash_fwd(
                   q, k, v, bias, causal, rate, seed)),
               "library_ms": C.time_ms(torch, lib),
               "bound_bytes_ms": nbytes / C.HBM_BYTES_PER_S * 1e3}
        if dtname == "float32":
            row["bound_fma_ms"] = flops / C.PEAK_FLOPS["float32"] * 1e3
            row["bound_3xtf32_ms"] = 3 * flops / C.PEAK_FLOPS["tf32"] * 1e3
        else:
            row["bound_ops_ms"] = flops / C.PEAK_FLOPS["bfloat16"] * 1e3
        row["split_ms"] = {n: ms for n, (_, ms) in profile_calls(
            torch, lambda: FA.flash_fwd(q, k, v, bias, causal, rate,
                                        seed)).items()}
        rows.append(row)
    return rows


def pair_fns(FA, q, k, v, bias, do, lse, delta, rate, seed):
    """(dq, dk, dv) from one run of a checkout's backward pair: dk/dv,
    then dq from its score gradient where the checkout has
    ``flash_bwd_dq_ds``, else from the inputs."""
    args = (q, k, v, bias, do, lse, delta)
    seq = q.shape[1]
    if hasattr(FA, "flash_bwd_dq_ds"):
        def pair():
            dk, dv, ds = FA.flash_bwd_dkv(*args, False, rate, seed)
            return FA.flash_bwd_dq_ds(k, ds, seq), dk, dv
    else:
        def pair():
            return (FA.flash_bwd_dq(*args, False, rate, seed),) + tuple(
                FA.flash_bwd_dkv(*args, False, rate, seed))
    return pair


def backward_rows(torch, FA, C, dev, gen, seed,
                  dtypes=("float32", "bfloat16"), shapes=TRAIN_SHAPES):
    import torch.nn.functional as F
    rows = []
    for dtname in dtypes:
        dt = getattr(torch, dtname)
        for bsz, seq in shapes:
            bh, d = bsz * HEADS, HEAD_DIM
            q, k, v, do = (torch.randn(bh, seq, d, generator=gen,
                                       device=dev).to(dt) for _ in range(4))
            bias = C.padding_bias(torch, gen, dev, bsz, seq)
            for rate in RATES:
                o, lse = FA.flash_fwd(q, k, v, bias, False, rate, seed)
                delta = (do.float() * o.float()).sum(dim=-1)
                pair = pair_fns(FA, q, k, v, bias, do, lse, delta, rate,
                                seed)
                got, again = pair(), pair()
                ref = FA.flash_bwd_plain(q, k, v, bias, o, lse, do, False,
                                         rate, seed)
                errs = [float((g.float() - r.float()).abs().max() /
                              max(1.0, float(r.float().abs().max())))
                        for g, r in zip(got, ref)]
                q4, k4, v4, do4 = (t.view(bsz, HEADS, seq, d).detach()
                                   .requires_grad_(True)
                                   for t in (q, k, v, do))
                mask4 = bias.view(bsz, 1, seq, seq).to(dt)
                lib_out = F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask4, dropout_p=rate)

                def lib():
                    return torch.autograd.grad(lib_out, (q4, k4, v4), do4,
                                               retain_graph=True)
                def delta_fn():
                    return (do.float() * o.float()).sum(dim=-1)
                split = profile_calls(torch, pair)
                rows.append({
                    "kernel": "bwd_pair", "dtype": dtname, "batch": bsz,
                    "heads": HEADS, "seq": seq, "d": d,
                    "mode": "padding-bias", "dropout": rate,
                    "max_rel_err": errs,
                    "bit_identical": all(torch.equal(a, b)
                                         for a, b in zip(got, again)),
                    "pair_ms": C.time_ms(torch, pair),
                    "delta_ms": C.time_ms(torch, delta_fn),
                    "library_ms": C.time_ms(torch, lib),
                    "split_ms": {n: ms for n, (_, ms) in split.items()}})
                del lib_out
    return rows


def update_ops(C, cfg, adamw):
    """The 158 optimizer ops of BERT-base pretraining as ``chip_smoke.py``
    builds phase 7 (``Adam(1e-4)``) and phase 8 (the recipe: AdamW 0.01,
    global-norm clip, warmup and linear decay)."""
    program = C.build_fused_train(cfg)[0]._program if adamw else \
        C.build_train(cfg)[0]
    kind = "adamw" if adamw else "adam"
    return [op for op in program.global_block().ops if op.type == kind]


def adam_env(torch, ops, dev, gen):
    """Every input of ``ops`` as a device tensor: parameters, gradients
    and moments of the parameter's shape, one-element LR and powers."""
    env = {}
    for op in ops:
        shape = tuple(op.block._find_var_recursive(
            op.inputs["Param"][0]).shape)
        for slot, names in op.inputs.items():
            for n in names:
                if n in env:
                    continue
                if slot in ("Param", "Grad", "Moment1", "Moment2"):
                    t = torch.randn(shape, generator=gen, device=dev)
                    if slot == "Moment1":
                        t *= 0.1
                    elif slot == "Moment2":
                        t = (t * 0.01).abs()
                    elif slot == "Grad":
                        t *= 0.01
                else:
                    t = torch.tensor([{"Beta1Pow": 0.9, "Beta2Pow": 0.999}
                                      .get(slot, 1e-4)], device=dev)
                env[n] = t
    return env


def adam_rows(torch, C, dev, gen):
    from paddle_tpu_torch.framework.executor import run_ops
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.ops.registry import LoweringContext
    cfg = bert.BertConfig.base()
    rows = []
    for adamw in (False, True):
        ops = update_ops(C, cfg, adamw)
        env = adam_env(torch, ops, dev, gen)
        ctx = LoweringContext(None, dev, donate_state=True)

        def update():
            run_ops(ops, env, ctx)
        kernels.reset_launch_counts()
        update()
        torch.cuda.synchronize()
        port_launches = kernels.launch_counts()["adam"]
        host = []
        for _ in range(ADAM_SAMPLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            update()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        split = profile_calls(torch, update)
        kernel = {n: v for n, v in split.items() if "adam" in n.lower()}
        other = {n: v for n, v in split.items() if n not in kernel}
        names = [op.inputs[s][0] for op in ops
                 for s in ("Param", "Grad", "Moment1", "Moment2")]
        ps, gs, ms, vs = (names[i::4] for i in range(4))
        ps, gs, ms, vs = ([env[n] for n in lst] for lst in (ps, gs, ms, vs))
        steps = [torch.tensor([1.0], device=dev) for _ in ps]
        fused = torch._fused_adamw_ if adamw else torch._fused_adam_

        def library():
            fused(ps, gs, ms, vs, [], steps, lr=1e-4, beta1=0.9,
                  beta2=0.999, weight_decay=0.01 if adamw else 0.0,
                  eps=1e-8, amsgrad=False, maximize=False)
        lib_split = profile_calls(torch, library)
        numel = sum(p.numel() for p in ps)
        rows.append({
            "kernel": "adamw" if adamw else "adam", "ops": len(ops),
            "parameters": numel,
            "port_launch_count": port_launches,
            "launches": sum(n for n, _ in split.values()),
            "kernel_launches": sum(n for n, _ in kernel.values()),
            "kernel_ms": sum(ms for _, ms in kernel.values()),
            "other_launches": sum(n for n, _ in other.values()),
            "other_ms": sum(ms for _, ms in other.values()),
            "events_ms": C.time_ms(torch, update, samples=ADAM_SAMPLES),
            "host_enqueue_ms": statistics.median(host),
            "library_ms": C.time_ms(torch, library, samples=ADAM_SAMPLES),
            "library_device_ms": sum(ms for _, ms in lib_split.values()),
            "library_launches": sum(n for n, _ in lib_split.values()),
            "bound_ms": 28 * numel / C.HBM_BYTES_PER_S * 1e3,
            "split": {n: list(v) for n, v in split.items()}})
        del env, ps, gs, ms, vs
        torch.cuda.empty_cache()
    return rows


def ln_fwd_rows(torch, C, dev, gen):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import fused_ops as K
    rows = []
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for dtname in ("float32", "bfloat16"):
        dt = torch.float32 if dtname == "float32" else torch.bfloat16
        es = torch.finfo(dt).bits // 8
        for r in LN_ROWS:
            d = LN_D
            a, b = (torch.randn(r, d, generator=gen, device=dev).to(dt)
                    for _ in range(2))
            s = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
                 ).to(dt)
            bb = (0.1 * torch.randn(d, generator=gen, device=dev)).to(dt)
            u = a + b
            for name, kern, plain, lib in (
                    ("layer_norm_fwd", lambda: K.layer_norm_fwd(a, s, bb),
                     lambda: K.layer_norm_plain(a, s, bb),
                     lambda: F.layer_norm(a, (d,), s, bb, 1e-5)),
                    ("add_layer_norm_fwd",
                     lambda: K.add_layer_norm_fwd(a, b, s, bb),
                     lambda: K.add_layer_norm_plain(a, b, s, bb),
                     lambda: F.layer_norm(a + b, (d,), s, bb, 1e-5))):
                residual = name == "add_layer_norm_fwd"
                got, again = kern(), kern()

                def chain():
                    for _ in range(CHAIN):
                        kern()
                row = {"kernel": name, "dtype": dtname, "rows": r, "d": d,
                       "err": float((got.float() - plain().float()).abs()
                                    .max()),
                       "bit_identical": bool(torch.equal(got, again)),
                       "ms": C.time_ms(torch, kern),
                       "cold_ms": C.time_ms(torch, kern, flush=flush),
                       "chain_ms": C.time_ms(torch, chain) / CHAIN,
                       "device_ms": sum(ms for _, ms in profile_calls(
                           torch, kern).values()),
                       "plain_ms": C.time_ms(torch, plain),
                       "library_ms": C.time_ms(torch, lib),
                       "bound_ms": ((2 + residual) * r * d + 2 * d) * es /
                       C.HBM_BYTES_PER_S * 1e3}
                if residual:
                    row["library_layer_norm_alone_ms"] = C.time_ms(
                        torch, lambda: F.layer_norm(u, (d,), s, bb, 1e-5))
                rows.append(row)
    return rows


def quant_rows(torch, C, dev, gen):
    from paddle_tpu_torch.ops.cuda import quant_kernels as QK
    from paddle_tpu_torch.ops.quantize_wire import CompressionSpec
    rows = []
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for dtype, name in (("int8", "dequant_accumulate_requant"),
                        ("int4", "dequant_accumulate")):
        spec = CompressionSpec(dtype, 256)
        requant = dtype == "int8"
        fn = getattr(QK, name)
        plain = getattr(QK, name + "_plain")
        for sb in QUANT_SHAPES:
            q, s = C.quant_peers(torch, gen, spec, 2, sb)

            def kern():
                return fn(q, s, spec, 2)
            got, again, ref = kern(), kern(), plain(q, s, spec, 2)
            if requant:
                err = int((got[0] != ref[0]).sum())
                same = torch.equal(got[0], again[0]) and \
                    torch.equal(got[1], again[1])
            else:
                err = float((got - ref).abs().max())
                same = torch.equal(got, again)
            rows.append({
                "kernel": name, "dtype": dtype, "n": 2, "sb": sb,
                "block": 256, "err": err, "bit_identical": bool(same),
                "ms": C.time_ms(torch, kern),
                "cold_ms": C.time_ms(torch, kern, flush=flush),
                "device_ms": sum(ms for _, ms in profile_calls(
                    torch, kern).values()),
                "plain_ms": C.time_ms(torch, lambda: plain(q, s, spec, 2)),
                "bound_ms": C.quant_bytes(spec, 2, sb, requant) /
                C.HBM_BYTES_PER_S * 1e3})
            del q, s, got, again, ref
        inputs = [C.quant_peers(torch, gen, spec, 2, sb)
                  for sb in C.STEP_BUCKET_SB]

        def chain():
            for q, s in inputs:
                fn(q, s, spec, 2)
        split = profile_calls(torch, chain)
        rows.append({
            "kernel": name + " step", "dtype": dtype,
            "buckets": list(C.STEP_BUCKET_SB),
            "chain_ms": C.time_ms(torch, chain, samples=15),
            "chain_device_ms": sum(ms for _, ms in split.values()),
            "launches": sum(n for n, _ in split.values()),
            "bound_ms": sum(C.quant_bytes(spec, 2, sb, requant)
                            for sb in C.STEP_BUCKET_SB) /
            C.HBM_BYTES_PER_S * 1e3})
        del inputs
        torch.cuda.empty_cache()
    return rows


GROUPS = ("fwd", "bwd", "amp", "adam", "ln_fwd", "quant")
LIBRARIES = {"fwd": ("flash_attention",), "adam": ("adam",),
             "bwd": ("flash_attention", "flash_attention_bwd"),
             "amp": ("flash_attention", "flash_attention_bwd"),
             "ln_fwd": ("layer_norm",), "quant": ("quant_accumulate",)}


def worker(root, out, only=GROUPS):
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as C
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops.cuda import build
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    assert os.path.abspath(FA.__file__).startswith(os.path.abspath(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    rep = build.build(sorted({lib for g in only for lib in LIBRARIES[g]}),
                      verbose=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    seed = torch.tensor([SEED], dtype=torch.int32, device=dev)
    rows = []
    if "fwd" in only:
        rows += forward_rows(torch, FA, C, dev, gen, seed)
    if "bwd" in only:
        rows += backward_rows(torch, FA, C, dev, gen, seed)
    if "amp" in only:
        # the bf16 program's shape, in the 16-bit dtypes the checkout takes
        dts = [dt for dt in AMP_DTYPES
               if FA.supported(AMP_SHAPE[1], AMP_SHAPE[1], HEAD_DIM,
                               getattr(torch, dt))[0]]
        rows += forward_rows(torch, FA, C, dev, gen, seed, [
            (dt, AMP_SHAPE[0], AMP_SHAPE[1], "padding-bias", rate)
            for dt in dts for rate in RATES])
        rows += backward_rows(torch, FA, C, dev, gen, seed, dts, (AMP_SHAPE,))
    if "adam" in only:
        rows += adam_rows(torch, C, dev, gen)
    if "ln_fwd" in only:
        rows += ln_fwd_rows(torch, C, dev, gen)
    if "quant" in only:
        rows += quant_rows(torch, C, dev, gen)
    with open(out, "w") as f:
        json.dump({"root": root, "ptxas": rep["ptxas"],
                   "build_s": rep["seconds"], "rows": rows}, f)


def fmt(row):
    def f(x):
        return f"{x:.4f}"
    if row["kernel"] == "fwd":
        bounds = ", ".join(f"{k} {f(v)}" for k, v in row.items()
                           if k.startswith("bound"))
        return (f"  fwd {row['dtype']} B{row['batch']} S{row['seq']} "
                f"{row['mode']} dropout {row['dropout']}: {f(row['ms'])} ms,"
                f" SDPA {f(row['library_ms'])}; {bounds}; err o "
                f"{row['err_o']:.2e} lse {row['err_lse']:.2e}, "
                f"bit-identical {row['bit_identical']}; split "
                + ", ".join(f"{k} {f(v)}" for k, v in row["split_ms"].items()))
    if row["kernel"] == "bwd_pair":
        return (f"  bwd pair {row['dtype']} B{row['batch']} S{row['seq']} "
                f"dropout {row['dropout']}: {f(row['pair_ms'])} ms, delta "
                f"{f(row['delta_ms'])}, library "
                f"{f(row['library_ms'])}; split "
                + ", ".join(f"{k} {f(v)}" for k, v in row["split_ms"].items())
                + f"; max rel err {['%.2e' % e for e in row['max_rel_err']]}"
                f", bit-identical {row['bit_identical']}")
    if row["kernel"].endswith(" step"):
        return (f"  {row['kernel']} {row['dtype']} n2, 13 launches: chain "
                f"{f(row['chain_ms'])} ms, device {f(row['chain_device_ms'])}"
                f" ({row['launches']:.0f} launches); bound "
                f"{f(row['bound_ms'])}")
    if row["kernel"].startswith("dequant"):
        return (f"  {row['kernel']} {row['dtype']} n2 SB{row['sb']}: "
                f"{f(row['ms'])} ms, L2 flushed {f(row['cold_ms'])}, device "
                f"{f(row['device_ms'])}; plain {f(row['plain_ms'])}, bound "
                f"{f(row['bound_ms'])}; err {row['err']}, bit-identical "
                f"{row['bit_identical']}")
    if row["kernel"] in ("layer_norm_fwd", "add_layer_norm_fwd"):
        alone = row.get("library_layer_norm_alone_ms")
        return (f"  {row['kernel']} {row['dtype']} R{row['rows']} "
                f"D{row['d']}: {f(row['ms'])} ms, L2 flushed "
                f"{f(row['cold_ms'])}, chain {f(row['chain_ms'])}"
                f" per launch, device {f(row['device_ms'])}; plain "
                f"{f(row['plain_ms'])}, library {f(row['library_ms'])}"
                + ("" if alone is None else f" (F.layer_norm alone "
                   f"{f(alone)})")
                + f", bound {f(row['bound_ms'])}; err {row['err']:.2e}, "
                f"bit-identical {row['bit_identical']}")
    return (f"  {row['kernel']} x{row['ops']} ({row['parameters']} "
            f"parameters): {row['launches']:.0f} device launches "
            f"(LAUNCHES {row['port_launch_count']}); Adam kernel "
            f"{row['kernel_launches']:.0f} launches {f(row['kernel_ms'])} ms,"
            f" other {row['other_launches']:.0f} launches "
            f"{f(row['other_ms'])} ms; events {f(row['events_ms'])} ms; host "
            f"enqueue {f(row['host_enqueue_ms'])} ms; library one call "
            f"{f(row['library_ms'])} ms ({row['library_launches']:.0f} "
            f"launches, {f(row['library_device_ms'])} device ms); bound "
            f"{f(row['bound_ms'])} ms")


def main(argv):
    if argv[:1] == ["--worker"]:
        worker(argv[1], argv[2], argv[3].split(","))
        return 0
    out, only = "paddle_tpu_torch/_build/kernel_ab.json", ",".join(GROUPS)
    for flag in ("--out", "--only"):
        if flag in argv:
            i = argv.index(flag)
            if flag == "--out":
                out = argv[i + 1]
            else:
                only = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(__doc__)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    sys.path.insert(0, REPO)
    from chip_smoke import nvidia_smi_line
    card = nvidia_smi_line()
    runs = []
    for i, root in enumerate(argv):
        part = f"{out}.{i}"
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--worker", os.path.abspath(root), part, only])
        if rc != 0:
            print(f"worker for {root} failed (rc {rc})", file=sys.stderr)
            return 1
        with open(part) as f:
            run = json.load(f)
        os.remove(part)
        run["order"] = i
        runs.append(run)
        print(f"== run {i}: {root} (build {run['build_s']:.1f} s)")
        for row in run["rows"]:
            print(fmt(row))
    with open(out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card)
    bad = [r for run in runs for r in run["rows"]
           if "bit_identical" in r and (
               not r["bit_identical"] or
               math.isnan(r.get("err_o", r.get("err", max(
                   r.get("max_rel_err", [0]))))) or
               (r["kernel"] == "dequant_accumulate_requant" and r["err"]))]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
