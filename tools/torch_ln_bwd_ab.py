#!/usr/bin/env python3
"""A/B timing of the port's LayerNorm backward kernels on one CUDA card:
``layer_norm_bwd`` (replaces ``_ln_bwd_kernel``) and ``add_layer_norm_bwd``
(replaces ``_aln_bwd_kernel``), across checkouts of the repository.

    python3 tools/torch_ln_bwd_ab.py ROOT [ROOT ...] [--out FILE]

Each ROOT is a checkout holding ``paddle_tpu_torch``.  Each runs in its own
process, in the order given (to compare a parent P with a change C on one
card: P C C P), builds its ``layer_norm`` library and, at the training
path's shapes (rows 4096 and 640 / 1000 of D = 768), float32 and bfloat16:

* checks the kernel against its plain twin (max |Δ| of dx, dscale, dbias)
  and dscale/dbias bit for bit across two launches;
* times it with CUDA events, median of 25, as ``chip_smoke.py`` does (the
  L2 cache warm from the previous sample) and again with the L2 flushed
  before each sample (a 64 MB write between samples, outside the events);
* times ``torch.ops.aten.native_layer_norm_backward`` at the same shape,
  from saved mean and rstd (of a + b for the residual variant), both ways;
* records one profiled run of ten calls: device time per call by kernel
  name (the row pass and the column pass), from ``torch.profiler``.

Timing and the profiler split are ``chip_smoke.py``'s (``time_ms``,
``kernel_split_ms``), taken from the checkout this script lies in.  Bound:
bytes over 3.35 TB/s (H100 SXM), each input read once and each output
written once.  Prints one line per measurement, the card's name and
power limit, and writes every number as JSON to FILE (default
``chiprun_out/ln_bwd_ab.json``).  Imports torch and the port only."""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("layer_norm_bwd", 4096, 768), ("layer_norm_bwd", 640, 768),
          ("add_layer_norm_bwd", 4096, 768), ("add_layer_norm_bwd", 1000, 768))
FLUSH_BYTES = 64 << 20        # more than the H100's 50 MB L2
SEED = 2024


def worker(root, out):
    import torch
    sys.path.insert(0, REPO)
    from chip_smoke import HBM_BYTES_PER_S, kernel_split_ms, time_ms
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops.cuda import build
    from paddle_tpu_torch.ops.cuda import fused_ops as K
    assert os.path.abspath(K.__file__).startswith(os.path.abspath(root))
    rep = build.build(["layer_norm"], verbose=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rows_out = []
    for dtname, dt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        es = torch.finfo(dt).bits // 8
        for name, r, d in SHAPES:
            def randn(*shape, scale=1.0):
                return (torch.randn(*shape, generator=gen, device=dev) *
                        scale).to(dt)
            x, b, dy = randn(r, d), randn(r, d), randn(r, d)
            s = (1.0 + randn(d, scale=0.1)).to(dt)
            if name == "layer_norm_bwd":
                def kern():
                    return K.layer_norm_bwd(x, s, dy)
                ref = K.layer_norm_bwd_plain(x, s, dy)
                u, nbytes = x, (3 * r * d + 3 * d) * es
            else:
                def kern():
                    return K.add_layer_norm_bwd(x, b, s, dy)
                ref = K.add_layer_norm_bwd_plain(x, b, s, dy)
                u, nbytes = x + b, (4 * r * d + 3 * d) * es
            got, again = kern(), kern()
            errs = [float((g.float() - f.float()).abs().max())
                    for g, f in zip(got, ref)]
            same = all(torch.equal(p, q) for p, q in zip(got[1:], again[1:]))
            _, mean, rstd = torch.ops.aten.native_layer_norm(u, [d], s, s,
                                                              1e-5)

            def lib():
                return torch.ops.aten.native_layer_norm_backward(
                    dy, u, [d], mean, rstd, s, s, [True, True, True])
            row = {"kernel": name, "rows": r, "d": d, "dtype": dtname,
                   "max_abs_err": errs, "dsum_bit_identical": same,
                   "ms": time_ms(torch, kern),
                   "ms_cold_l2": time_ms(torch, kern, flush=flush),
                   "library_ms": time_ms(torch, lib),
                   "library_ms_cold_l2": time_ms(torch, lib, flush=flush),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "split_ms": kernel_split_ms(torch, kern)}
            rows_out.append(row)
    with open(out, "w") as f:
        json.dump({"root": root, "ptxas": rep["ptxas"].get("layer_norm", ""),
                   "build_s": rep["seconds"], "rows": rows_out}, f)


def main(argv):
    if argv[:1] == ["--worker"]:
        worker(argv[1], argv[2])
        return 0
    out = "chiprun_out/ln_bwd_ab.json"
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
            split = ", ".join(f"{k} {v:.4f}" for k, v in
                              row["split_ms"].items())
            print(f"  {row['kernel']} [{row['rows']},{row['d']}] "
                  f"{row['dtype']}: kernel {row['ms']:.4f} ms (cold L2 "
                  f"{row['ms_cold_l2']:.4f}), library "
                  f"{row['library_ms']:.4f} (cold "
                  f"{row['library_ms_cold_l2']:.4f}), bound "
                  f"{row['bound_ms']:.4f}; split: {split}; "
                  f"max|Δ| {['%.2e' % e for e in row['max_abs_err']]}, "
                  f"bit-identical sums {row['dsum_bit_identical']}")
    with open(out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card)
    bad = [r for run in runs for r in run["rows"]
           if not r["dsum_bit_identical"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
