#!/usr/bin/env python3
"""A/B timing of the port's flash-attention backward kernels on one CUDA
card: ``flash_bwd_dq`` (replaces ``_bwd_dq_kernel``) and ``flash_bwd_dkv``
(replaces ``_bwd_dkv_kernel``), across checkouts of the repository.

    python3 tools/torch_flash_bwd_ab.py ROOT [ROOT ...] [--out FILE]

Each ROOT is a checkout holding ``paddle_tpu_torch``.  Each runs in its own
process, in the order given (to compare a parent P with a change C on one
card: P C C P), builds its two flash libraries and, at BERT-base's
training shapes (B32 H12 S128 and B8 H12 S512, D = 64, the head-shared
padding bias), float32 and bfloat16, at dropout 0 and at dropout 0.1:

* checks dq, dk and dv against the plain twin (max |Δ| over
  max(1, max|plain|)) and bit for bit across two launches;
* times dq, dk/dv and the pair with CUDA events, median of 25, as
  ``chip_smoke.py`` does (the L2 cache warm from the previous sample) and
  again with the L2 flushed before each sample (a 64 MB write between
  samples, outside the events);
* times ``delta = rowsum(dO * O)``, the two PyTorch ops that run beside
  the kernels;
* times the library's backward, ``torch.autograd.grad`` through
  ``F.scaled_dot_product_attention`` with the same mask and the same
  dropout rate, both ways;
* records one profiled run of ten calls of the pair and of the library's
  backward: device time per call by kernel name, from ``torch.profiler``.

A checkout's kernels are reached through its own wrappers: where it has
``flash_bwd_dq_ds``, the pair is dk/dv (which returns the score gradient
``ds``) then dq from ds; otherwise each kernel recomputes the scores from
the inputs.  Timing and the profiler
split are ``chip_smoke.py``'s (``time_ms``, ``kernel_split_ms``), taken
from the checkout this script lies in.  Bounds, of the pair's function
whatever the design (five S^2 D products, 10 BH S^2 D flops; q, k, v, dO,
the bias, lse and delta read once, dq, dk and dv written once): bytes over
3.35 TB/s, operations over 67 TFLOP/s (float32 FMA) and over 495 / 3
TFLOP/s (TF32 tensor cores, three passes a 3xTF32 product) for float32,
989 TFLOP/s for bfloat16 (H100 SXM).  Prints one line per measurement and
the card's name and power limit, and writes every number as JSON to FILE
(default ``chiprun_out/flash_bwd_ab.json``).  Imports torch and the port
only."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((32, 128), (8, 512))      # (batch, sequence) at 12 heads, D 64
HEADS, HEAD_DIM = 12, 64
RATES = (0.0, 0.1)
FLUSH_BYTES = 64 << 20        # more than the H100's 50 MB L2
SEED = 2024
TF32_FLOPS = 495e12           # H100 SXM, dense TF32 tensor cores
FP32_FLOPS = 67e12            # float32 outside the tensor cores
BF16_FLOPS = 989e12


def pair_fns(FA, q, k, v, bias, do, lse, delta, rate, seed):
    """{"dq", "dkv", "pair"} callables over a checkout's wrappers, and a
    function returning (dq, dk, dv) from one run of the pair."""
    args = (q, k, v, bias, do, lse, delta)
    seq = q.shape[1]

    def dkv():
        return FA.flash_bwd_dkv(*args, False, rate, seed)
    if hasattr(FA, "flash_bwd_dq_ds"):
        ds0 = dkv()[2]

        def dq():
            return FA.flash_bwd_dq_ds(k, ds0, seq)

        def pair():
            dk, dv, ds = dkv()
            return FA.flash_bwd_dq_ds(k, ds, seq), dk, dv
    else:
        def dq():
            return FA.flash_bwd_dq(*args, False, rate, seed)

        def pair():
            return (dq(),) + tuple(dkv())
    return {"dq": dq, "dkv": dkv, "pair": pair}


def worker(root, out):
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, REPO)
    from chip_smoke import (HBM_BYTES_PER_S, kernel_split_ms, padding_bias,
                            time_ms)
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops.cuda import build
    from paddle_tpu_torch.ops.cuda import flash_attention as FA
    assert os.path.abspath(FA.__file__).startswith(os.path.abspath(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    rep = build.build(["flash_attention", "flash_attention_bwd"],
                      verbose=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    seed = torch.tensor([SEED], dtype=torch.int32, device=dev)
    rows_out = []
    for dtname, dt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        es = torch.finfo(dt).bits // 8
        for bsz, seq in SHAPES:
            bh, d = bsz * HEADS, HEAD_DIM
            q, k, v, do = ((torch.randn(bh, seq, d, generator=gen,
                                        device=dev)).to(dt)
                           for _ in range(4))
            bias = padding_bias(torch, gen, dev, bsz, seq)
            for rate in RATES:
                o, lse = FA.flash_fwd(q, k, v, bias, False, rate, seed)
                delta = (do.float() * o.float()).sum(dim=-1)
                fns = pair_fns(FA, q, k, v, bias, do, lse, delta, rate,
                               seed)
                got, again = fns["pair"](), fns["pair"]()
                ref = FA.flash_bwd_plain(q, k, v, bias, o, lse, do, False,
                                         rate, seed)
                errs = [float((g.float() - r.float()).abs().max() /
                              max(1.0, float(r.float().abs().max())))
                        for g, r in zip(got, ref)]
                same = all(torch.equal(a, b) for a, b in zip(got, again))
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
                flops = 10 * bh * seq * seq * d
                t_bytes = (7 * bh * seq * d * es + bias.numel() * 4 +
                           2 * bh * seq * 4) / HBM_BYTES_PER_S * 1e3
                row = {"dtype": dtname, "batch": bsz, "heads": HEADS,
                       "seq": seq, "d": d, "dropout": rate,
                       "max_rel_err": errs, "bit_identical": same}
                for name in ("dq", "dkv", "pair"):
                    row[f"{name}_ms"] = time_ms(torch, fns[name])
                    row[f"{name}_ms_cold_l2"] = time_ms(torch, fns[name],
                                                        flush=flush)
                row["delta_ms"] = time_ms(torch, delta_fn)
                row["library_ms"] = time_ms(torch, lib)
                row["library_ms_cold_l2"] = time_ms(torch, lib, flush=flush)
                if dtname == "float32":
                    row["pair_bound_fma_ms"] = max(
                        t_bytes, flops / FP32_FLOPS * 1e3)
                    row["pair_bound_3xtf32_ms"] = max(
                        t_bytes, 3 * flops / TF32_FLOPS * 1e3)
                else:
                    row["pair_bound_ms"] = max(t_bytes,
                                               flops / BF16_FLOPS * 1e3)
                row["split_ms"] = kernel_split_ms(torch, fns["pair"])
                row["library_split_ms"] = kernel_split_ms(torch, lib)
                rows_out.append(row)
                del lib_out
    with open(out, "w") as f:
        json.dump({"root": root,
                   "ptxas": rep["ptxas"].get("flash_attention_bwd", ""),
                   "build_s": rep["seconds"], "rows": rows_out}, f)


def fmt(row):
    def ms(key):
        return f"{row[key]:.4f}"
    bounds = {k: v for k, v in row.items() if "bound" in k}
    split = ", ".join(f"{k} {v:.4f}" for k, v in row["split_ms"].items())
    lib_split = ", ".join(f"{k[:40]} {v:.4f}"
                          for k, v in row["library_split_ms"].items())
    return (f"  {row['dtype']} B{row['batch']} S{row['seq']} dropout "
            f"{row['dropout']}: dq {ms('dq_ms')} (cold {ms('dq_ms_cold_l2')}),"
            f" dkv {ms('dkv_ms')} (cold {ms('dkv_ms_cold_l2')}), pair "
            f"{ms('pair_ms')} (cold {ms('pair_ms_cold_l2')}); delta "
            f"{ms('delta_ms')}; library {ms('library_ms')} (cold "
            f"{ms('library_ms_cold_l2')}); bounds "
            + ", ".join(f"{k} {v:.4f}" for k, v in bounds.items())
            + f"; split: {split}; library split: {lib_split}; max rel err "
            f"{['%.2e' % e for e in row['max_rel_err']]}, bit-identical "
            f"{row['bit_identical']}")


def main(argv):
    if argv[:1] == ["--worker"]:
        worker(argv[1], argv[2])
        return 0
    out = "chiprun_out/flash_bwd_ab.json"
    if "--out" in argv:
        i = argv.index("--out")
        out = argv[i + 1]
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
                              "--worker", os.path.abspath(root), part])
        if rc != 0:
            print(f"worker for {root} failed (rc {rc})", file=sys.stderr)
            return 1
        with open(part) as f:
            run = json.load(f)
        os.remove(part)
        run["order"] = i
        runs.append(run)
        print(f"== run {i}: {root} (build {run['build_s']:.1f} s)")
        print(run["ptxas"])
        for row in run["rows"]:
            print(fmt(row))
    with open(out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card)
    bad = [r for run in runs for r in run["rows"]
           if not r["bit_identical"] or math.isnan(max(r["max_rel_err"]))]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
