#!/usr/bin/env python3
"""Find the ops of a BERT-base training step on the card whose outputs
differ between two runs from one seed.

    python3 tools/torch_determinism_probe.py [STEPS] [lamb]

Builds ``chip_smoke.py``'s fused program and recipe (phase 8's AdamW, or
phase 13's LAMB with the word ``lamb``), runs STEPS prepared steps
(default 3) twice from fresh scopes, and fingerprints every op output
and every parameter gradient (the int64 sum of its bit patterns: a
change of one ulp anywhere moves it).  Prints the losses of both runs and the first outputs whose
fingerprints differ, in program order; the first of them names the op
whose result depends on more than its inputs (an atomic sum, say).  Needs
one CUDA card; imports nothing of JAX."""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fingerprint(torch, t):
    t = t.detach().contiguous()
    if t.is_floating_point():
        as_int = {8: torch.int64, 4: torch.int32, 2: torch.int16}
        return t.view(as_int[t.element_size()]).to(torch.int64).sum()
    return t.to(torch.int64).sum()


def main(argv):
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.framework import executor as E
    from paddle_tpu_torch.models import bert
    steps = int(argv[0]) if argv and argv[0].isdigit() else 3
    lamb = "lamb" in argv
    if not torch.cuda.is_available():
        print("torch_determinism_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = bert.BertConfig.base()
    records = []
    scatter, grad = E._scatter_outputs, torch.autograd.grad

    def recording_scatter(op, outs, env):
        scatter(op, outs, env)
        for slot, names in op.outputs.items():
            vals = outs.get(slot, [])
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            for n, v in zip(names, vals):
                if torch.is_tensor(v):
                    records.append((op.type, n, fingerprint(torch, v)))

    def recording_grad(outputs, inputs, *a, **k):
        gs = grad(outputs, inputs, *a, **k)
        records.extend(("autograd", f"grad of input {i}",
                        fingerprint(torch, g))
                       for i, g in enumerate(gs) if g is not None)
        return gs

    def run():
        records.clear()
        compiled, startup, total, _ = C.build_fused_train(cfg, lamb=lamb)
        feed = bert.make_fake_batch(np.random.RandomState(C.SEED), cfg,
                                    C.TRAIN_BATCH, C.TRAIN_SEQ,
                                    C.TRAIN_MASKS)
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(startup, scope=scope)
        first = len(records)
        step = exe.prepare(compiled, fetch_list=[total], scope=scope,
                           donate_state=True)
        losses = [float(step.run(feed)[0]) for _ in range(steps)]
        return losses, [(t, n, int(v)) for t, n, v in records[first:]]

    E._scatter_outputs, torch.autograd.grad = recording_scatter, \
        recording_grad
    try:
        (la, a), (lb, b) = run(), run()
    finally:
        E._scatter_outputs, torch.autograd.grad = scatter, grad
    print(f"losses {la} / {lb}; {len(a)} / {len(b)} outputs recorded")
    differ = [(i, x, y) for i, (x, y) in enumerate(zip(a, b)) if x != y]
    print(f"{len(differ)} outputs differ")
    for i, x, y in differ[:40]:
        print(f"  #{i} {x[0]} {x[1]}: {x[2]} / {y[2]}")
    print(C.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
