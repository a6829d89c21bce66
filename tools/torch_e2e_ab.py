#!/usr/bin/env python3
"""End-to-end A/B of the port on one CUDA card, across checkouts of the
repository: served requests/s and training step times.

    python3 tools/torch_e2e_ab.py ROOT [ROOT ...] [--out FILE]

Each ROOT is a checkout holding ``paddle_tpu_torch``.  Each runs in its own
process, in the order given (to compare a parent P with a change C on one
card: P C C P, or longer alternations, since these metrics move between
runs of one code), builds its kernels and, through the ``chip_smoke.py``
beside this script and the checkout's own port:

* saves BERT-base and serves ``chip_smoke.py``'s window (16 bursts of 24
  requests, ``serve_phase``): requests/s, per-burst requests/s and p50,
  with the phase's own checks (lone runs, plain path, launches);
* trains BERT-base 10 steps unfused with Adam (``train_phase`` over
  ``build_train``) and 10 steps of the fused program with the published
  recipe (``build_fused_train``): the median step of steps 3-10 and every
  step's time, with the phases' launch and fallback checks.

Prints one line per run and the card's name and power limit, and writes
every number as JSON to FILE (default ``paddle_tpu_torch/_build/
e2e_ab.json``).  Imports torch and the port only."""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(root, out):
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as C
    sys.path.insert(0, root)
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.cuda import build
    assert os.path.abspath(build.__file__).startswith(os.path.abspath(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    model_dir = os.path.join(build.BUILD_DIR, "e2e_bert_base")
    cfg = C.build_and_save(torch, model_dir)
    _, serving, _, _ = C.serve_phase(torch, np, model_dir, cfg)
    base = bert.BertConfig.base()
    _, train = C.train_phase(torch, np, base, C.build_train,
                             C.TRAIN_LAUNCHES)
    _, fused = C.train_phase(torch, np, base, C.build_fused_train,
                             C.FUSED_LAUNCHES, schedule=C.scheduled_lr)
    with open(out, "w") as f:
        json.dump({"root": root,
                   "requests_per_s": serving["requests_per_s"],
                   "burst_requests_per_s": serving["burst_requests_per_s"],
                   "p50_ms": serving["p50_ms"],
                   "train_ms": train["step_ms_median_3_10"],
                   "train_step_s": train["step_s"],
                   "fused_ms": fused["step_ms_median_3_10"],
                   "fused_step_s": fused["step_s"]}, f)


def main(argv):
    if argv[:1] == ["--worker"]:
        worker(argv[1], argv[2])
        return 0
    out = "paddle_tpu_torch/_build/e2e_ab.json"
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
        print(f"== run {i}: {root}: {run['requests_per_s']:.2f} requests/s "
              f"(p50 {run['p50_ms']:.2f} ms), unfused step "
              f"{run['train_ms']:.2f} ms, fused step {run['fused_ms']:.2f} "
              f"ms", flush=True)
    with open(out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
