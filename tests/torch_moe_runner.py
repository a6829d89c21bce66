"""Rank program for the port's MoE tests, started by
``python -m paddle_tpu_torch.distributed.launch`` on the CPU over gloo.

    launch --nproc N --backend gloo --timeout T tests/torch_moe_runner.py \\
        LEGS IN.npz OUT_DIR

``LEGS`` is a comma-separated list of legs, run in turn in one launch on
the N ranks:

* a leg of :data:`BERT_LEGS`: BERT-tiny MoE (:func:`bert_cfg`: hidden 64,
  2 layers, 4 experts, top-2, capacity factor 2.0, dropout 0) built dense
  with Adam :data:`BERT_LR`, retrofitted by ``apply_expert_sharding`` onto
  the leg's layout (ZeRO-3 after it where the layout has fsdp), compiled
  ``with_mesh`` over ``layout.batch_axes`` with bucketed gradient sync,
  its parameters set to ``IN.npz``'s ``bert/init/*`` and trained STEPS
  steps on the global batches ``bert/b<i>/*``;
* a leg of :data:`TOY_LEGS`: the MoE block of ``tests/test_moe.py``
  (``x [B, 4, 8]``, 8 experts, FFN 16, routing groups of
  :data:`GROUP` tokens) with Adam 5e-3, likewise, on ``toy/x<i>``;
* ``manual_k1`` / ``manual_k2``: ``moe_ffn(ep_degree=2, axis_name="dp")``
  (top-k 1 / 2, SGD 0.2) under plain data parallelism
  (``with_data_parallel``);
* ``ep2_clip`` / ``fsdp2ep2_clip`` / ``manual_k2_clip``: ``ep2`` /
  ``fsdp2ep2`` / ``manual_k2`` with the global-norm clip of
  :data:`CLIPPED` (the squares of the expert gradients summed over the
  expert axis, and of the ZeRO-3 blocks over fsdp, before the root);
* ``drops``: the toy block at capacity factor 0.125, top-1, over
  ``MeshLayout(expert=2)``, its output fetched twice from fresh scopes;
* ``ckpt`` (4 ranks): the toy at ``MeshLayout(expert=4)`` trained 6
  steps; again 3 steps, a sharded ``save_checkpoint``, and a restore onto
  ``MeshLayout(data=2, expert=2)`` that takes steps 4-6.

Each leg saves its losses, every parameter's global value and what the
test checks besides; each rank writes ``OUT_DIR/rank<r>.npz``.  Ranks run
one intra-op thread.  Imports the port only."""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from paddle_tpu_torch import fluid, io, parallel  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import (  # noqa: E402
    PaddleCloudRoleMaker)
from paddle_tpu_torch.framework import unique_name  # noqa: E402
from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding  # noqa
from paddle_tpu_torch.framework.mesh_layout import MeshLayout  # noqa
from paddle_tpu_torch.models import bert  # noqa: E402
from paddle_tpu_torch.ops.collective_ops import whole_of  # noqa: E402

STEPS = 3
BERT_LR = 1e-3
TOY_LR = 5e-3
SGD_LR = 0.2
M, FFN, E = 8, 16, 8
GROUP = 4
#: leg -> (layout sizes, aux weight, exchange tier)
BERT_LEGS = {
    "ep2": ({"expert": 2}, 0.0, None),
    "dp2ep2": ({"data": 2, "expert": 2}, 0.0, None),
    "dp2ep2_aux": ({"data": 2, "expert": 2}, 0.01, None),
    "fsdp2ep2": ({"fsdp": 2, "expert": 2}, 0.0, None),
    "ep2_clip": ({"expert": 2}, 0.0, None),
    "fsdp2ep2_clip": ({"fsdp": 2, "expert": 2}, 0.0, None),
}
#: leg -> the global-norm clip its optimizer takes (one that binds)
CLIPPED = {"ep2_clip": 0.05, "fsdp2ep2_clip": 0.05, "manual_k2_clip": 0.01}
TOY_LEGS = {
    "toy_ep2_aux": ({"expert": 2}, 0.01, None),
    "toy_ep2_bf16": ({"expert": 2}, 0.0, "bfloat16"),
    "toy_ep2_int8": ({"expert": 2}, 0.0, "int8"),
}


def bert_cfg(aux=0.01):
    return bert.BertConfig(
        vocab_size=1024, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, moe_experts=4,
        moe_aux_weight=aux)


def toy_attr(seed):
    return fluid.ParamAttr(initializer=fluid.initializer.UniformInitializer(
        -0.5, 0.5, seed=seed))


def toy_model(top_k=2, cf=8.0, ep=None, aux_weight=0.0, group_size=0,
              quant_spec=None):
    """``tests/test_moe.py::_build`` in the port."""
    L = fluid.layers
    x = L.data("x", shape=[4, M])
    out, aux = parallel.moe_ffn(
        x, num_experts=E, ffn_hidden=FFN, top_k=top_k, capacity_factor=cf,
        ep_degree=ep, axis_name="dp", group_size=group_size,
        quant_spec=quant_spec, param_attr=toy_attr(7))
    loss = L.mean(L.square(out))
    if aux_weight:
        loss = L.elementwise_add(loss, L.scale(aux, scale=aux_weight))
    return loss, aux, out


def _fill(scope, main, inp, prefix):
    for p in main.all_parameters():
        scope.set_var(p.name, torch.from_numpy(
            np.array(inp[f"{prefix}/init/{p.name}"])))


def _globals(dp, scope, main):
    return {p.name: whole_of(dp, p, scope.find_var(p.name)).detach().numpy()
            .copy() for p in main.all_parameters()}


def _compile(main, loss, layout, quant=None, fsdp_report=None):
    """apply_expert_sharding (then ZeRO-3 where the layout has fsdp) and
    ``with_mesh`` over the layout's batch axes; returns (the compiled
    program, the expert report)."""
    rep = parallel.apply_expert_sharding(main, layout, quant_spec=quant)
    if layout.fsdp > 1:
        fsdp_report.update(apply_fsdp_sharding(main, layout,
                                               min_shard_numel=16))
    main._mesh_layout = layout
    bs = fluid.BuildStrategy()
    bs.fuse_all_reduce_ops = True
    prog = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=loss.name,
        batch_axis=layout.batch_axes, build_strategy=bs)
    return prog, rep


def _train(exe, prog, loss, scope, feeds):
    return [float(np.asarray(exe.run(prog, feed=f, fetch_list=[loss],
                                     scope=scope)[0]).reshape(-1)[0])
            for f in feeds]


def _save(out, leg, losses, prog, scope, main):
    out[f"{leg}/losses"] = np.array(losses)
    for n, v in _globals(prog._dp, scope, main).items():
        out[f"{leg}/p/{n}"] = v


def bert_feeds(inp, i):
    pre = f"bert/b{i}/"
    return {k[len(pre):]: inp[k] for k in inp if k.startswith(pre)}


def bert_leg(leg, inp, out):
    sizes, aux, quant = BERT_LEGS[leg]
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        _, loss, _, _ = bert.build_pretrain_network(bert_cfg(aux))
        fluid.optimizer.Adam(BERT_LR, grad_clip=_clip(leg)).minimize(loss)
    fsdp_rep = {}
    prog, rep = _compile(main, loss, MeshLayout(**sizes), quant, fsdp_rep)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    _fill(scope, main, inp, "bert")
    losses = _train(exe, prog, loss, scope,
                    [bert_feeds(inp, i) for i in range(STEPS)])
    _save(out, leg, losses, prog, scope, main)
    out[f"{leg}/types"] = np.array([op.type for op in
                                    main.global_block().ops])
    out[f"{leg}/stamped"] = np.array(json.dumps(rep["stamped"]))
    out[f"{leg}/exchanges"] = np.array(sum(
        op.type == "c_expert_alltoall" for op in main.global_block().ops))
    if fsdp_rep:
        out[f"{leg}/fsdp_sharded"] = np.array(json.dumps(
            [s["param"] for s in fsdp_rep["sharded"]]))
        out[f"{leg}/fsdp_skipped"] = np.array(json.dumps(
            fsdp_rep["skipped"]))


def build_toy(sizes, aux=0.0, quant=None):
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss, _, _ = toy_model(aux_weight=aux, group_size=GROUP,
                               quant_spec=quant)
        fluid.optimizer.Adam(TOY_LR).minimize(loss)
    prog, _ = _compile(main, loss, MeshLayout(**sizes), quant)
    return prog, main, startup, loss


def toy_feeds(inp, n):
    return [{"x": inp[f"toy/x{i}"]} for i in range(n)]


def toy_leg(leg, inp, out):
    sizes, aux, quant = TOY_LEGS[leg]
    prog, main, startup, loss = build_toy(sizes, aux, quant)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    _fill(scope, main, inp, "toy")
    _save(out, leg, _train(exe, prog, loss, scope, toy_feeds(inp, STEPS)),
          prog, scope, main)


def _clip(leg):
    c = CLIPPED.get(leg)
    return fluid.clip.GradientClipByGlobalNorm(c) if c else None


def manual_leg(leg, inp, out):
    top_k = int(leg[len("manual_k")])
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss, _, _ = toy_model(top_k=top_k, ep=2)
        fluid.optimizer.SGD(SGD_LR, grad_clip=_clip(leg)).minimize(loss)
    out[f"{leg}/types"] = np.array([op.type for op in
                                    main.global_block().ops])
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    _fill(scope, main, inp, "toy")
    _save(out, leg, _train(exe, prog, loss, scope, toy_feeds(inp, STEPS)),
          prog, scope, main)


def drops_leg(inp, out):
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4, M])
        o, _ = parallel.moe_ffn(x, num_experts=E, ffn_hidden=FFN, top_k=1,
                                capacity_factor=0.125, group_size=GROUP,
                                param_attr=toy_attr(3))
    layout = MeshLayout(expert=2)
    parallel.apply_expert_sharding(main, layout)
    main._mesh_layout = layout
    prog = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), batch_axis=layout.batch_axes)
    exe = fluid.Executor(fluid.CPUPlace())
    outs = []
    for _ in range(2):
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        outs.append(np.asarray(exe.run(prog, feed={"x": inp["drops/x"]},
                                       fetch_list=[o], scope=scope)[0]))
    out["drops/a"], out["drops/b"] = outs


def ckpt_leg(inp, out, tmp):
    feeds = toy_feeds(inp, 2 * STEPS)
    exe = fluid.Executor(fluid.CPUPlace())
    ep4 = {"expert": 4}

    def fresh(sizes):
        prog, main, startup, loss = build_toy(sizes)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        return prog, main, startup, loss, scope

    prog, main, _, loss, scope = fresh(ep4)
    _fill(scope, main, inp, "toy")
    out["ckpt/ref"] = np.array(_train(exe, prog, loss, scope, feeds))

    prog, main, _, loss, scope = fresh(ep4)
    _fill(scope, main, inp, "toy")
    out["ckpt/before"] = np.array(_train(exe, prog, loss, scope,
                                         feeds[:STEPS]))
    path = os.path.join(tmp, "ckpt")
    d = io.save_checkpoint(exe, path, io.TrainStatus(STEPS - 1, STEPS - 1),
                           main, scope=scope, sharded=True)
    for n, v in _globals(prog._dp, scope, main).items():
        out[f"ckpt/saved/{n}"] = v
    man = io._read_manifest(d)
    out["ckpt/manifest"] = np.array(json.dumps(
        {"mesh_layout": man["mesh_layout"],
         "shard_specs": man["shard_specs"]}))
    out["ckpt/dir"] = np.array(d)

    prog, main, _, loss, scope = fresh({"data": 2, "expert": 2})
    st = io.load_checkpoint(exe, path, main_program=main, scope=scope)
    out["ckpt/reshard"] = np.array(json.dumps(
        {"src": st.reshard["src_layout"], "dst": st.reshard["dst_layout"]}
        if st.reshard else None))
    out["ckpt/after"] = np.array(_train(exe, prog, loss, scope,
                                        feeds[STEPS:]))


def main_(legs, in_path, out_dir):
    torch.set_num_threads(1)
    fleet.init(PaddleCloudRoleMaker(place=fluid.CPUPlace()))
    rank = fleet.worker_index()
    inp = dict(np.load(in_path))
    out = {}
    for leg in legs.split(","):
        if leg in BERT_LEGS:
            bert_leg(leg, inp, out)
        elif leg in TOY_LEGS:
            toy_leg(leg, inp, out)
        elif leg.startswith("manual_k"):
            manual_leg(leg, inp, out)
        elif leg == "drops":
            drops_leg(inp, out)
        elif leg == "ckpt":
            ckpt_leg(inp, out, out_dir)
        else:
            raise SystemExit(f"unknown leg {leg!r}")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main_(*sys.argv[1:4])
