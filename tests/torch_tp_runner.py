"""Rank program for the port's tensor- and sequence-parallel tests, started
by ``python -m paddle_tpu_torch.distributed.launch`` on the CPU over gloo.

    launch --nproc N --backend gloo --timeout T tests/torch_tp_runner.py \\
        ring IN.npz OUT_DIR
    launch --nproc N ... mlp LAYOUT IN.npz OUT_DIR
    launch --nproc N ... bert LAYOUT IN.npz OUT_DIR

``ring``: on a ``sp`` axis of the N ranks, ``ring_attention`` of this
rank's sequence shard of the global q, k, v and kv_mask in ``IN.npz``
for every case of :data:`RING_CASES` (the plain or the flash inner step,
causal or not, with or without the mask), its output and its q/k/v
gradients under the cotangent ``dO`` (the causal cases take
``kv_mask_causal``).
``mlp``: three SGD steps of a two-layer MLP built with
``column_parallel_fc`` / ``row_parallel_fc`` and a
``vocab_parallel_embedding`` sum under LAYOUT (``tp2`` on two ranks,
``dp2tp2`` on four), from the global parameters in ``IN.npz``; and the
collective ops of :data:`COMM_CASES` over the tp group with their
gradients.
``bert``: BERT-tiny built by ``build_pretrain_network_parallel`` under
LAYOUT (``tp2``, ``sp2``, ``tp2sp2``), from the global parameters of
``IN.npz``, three SGD steps through ``Executor.run`` and three Adam steps
through ``prepare(donate_state=True)`` on the batches ``b<i>``; with
``IN.npz``'s ``odd/...`` batch, one SGD step on it; under ``tp2sp2`` the
Adam state is saved (``save_checkpoint`` sharded, ``AsyncCheckpointer``,
and whole) under ``OUT_DIR`` and restored onto the same layout in a
fresh scope.  Every mode writes ``OUT_DIR/rank<r>.npz``.  Imports the
port only."""

from __future__ import annotations

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
from paddle_tpu_torch.framework.mesh_layout import MeshLayout  # noqa
from paddle_tpu_torch.models import bert  # noqa: E402
from paddle_tpu_torch.ops import registry  # noqa: E402
from paddle_tpu_torch.ops.collective_ops import (  # noqa: E402
    DataParallelGroup, MeshGroups, whole_of)

#: (case, use_flash, causal, masked) of the ring mode
RING_CASES = [(f"{'flash' if fl else 'plain'}{'_causal' if c else ''}"
               f"{'_mask' if m else ''}", fl, c, m)
              for fl in (False, True) for c in (False, True)
              for m in (False, True)]
#: (case, op type, attrs) of the collective ops in the mlp mode, over
#: the tp group: each on its input ``X`` (``W`` and ``Ids`` for
#: c_embedding), with the cotangent ``G_<case>``
COMM_CASES = [
    ("c_embedding", "c_embedding", {"_axis_name": "tp",
                                    "per_shard_rows": 4}),
    ("c_allgather", "c_allgather", {"_axis_name": "tp", "gather_dim": -1}),
    ("c_concat", "c_concat", {"_axis_name": "tp", "gather_dim": 1}),
    ("c_split", "c_split", {"_axis_name": "tp"}),
    ("permute", "collective_permute", {"_axis_name": "tp", "shift": 1}),
    ("mp_copy", "mp_copy", {"_axis_name": "tp"}),
    ("mp_allreduce_sum", "mp_allreduce_sum", {"_axis_name": "tp"}),
]
#: the layouts: (MeshLayout kwargs, tp degree of the build, sequence axis)
BERT_LAYOUTS = {"tp2": ({"tp": 2}, 2, None),
                "sp2": ({"extra_axes": {"sp": 2}}, 1, "sp"),
                "tp2sp2": ({"tp": 2, "extra_axes": {"sp": 2}}, 2, "sp")}
MLP_LAYOUTS = {"tp2": {"tp": 2}, "dp2tp2": {"data": 2, "tp": 2}}
SGD_LR = 0.5
ADAM_LR = 1e-3
MLP_LR = 0.1
VOCAB = 16


def _init(rank):
    # one thread a rank: four ranks beside the rest of a parallel test run
    torch.set_num_threads(1)
    fleet.init(PaddleCloudRoleMaker(place=fluid.CPUPlace()))
    assert fleet.worker_index() == rank
    return fleet.worker_num()


def _routes():
    return np.array(sorted(f"{k[0]}:{k[1]}:{k[2]}:{k[3]}"
                           for k in registry.route_counts()))


def ring(inputs, out_dir):
    rank = int(os.environ["RANK"])
    n = _init(rank)
    data = np.load(inputs)
    g = DataParallelGroup.current("sp")
    assert g.world == n and g.rank == rank
    s = data["q"].shape[2] // n
    cut = slice(rank * s, (rank + 1) * s)
    out = {}
    for case, use_flash, causal, masked in RING_CASES:
        q, k, v = (torch.from_numpy(data[t][:, :, cut].copy())
                   .requires_grad_(True) for t in ("q", "k", "v"))
        name = "kv_mask_causal" if causal else "kv_mask"
        mask = torch.from_numpy(data[name][:, cut].copy()) \
            if masked else None
        o = parallel.ring_attention(q, k, v, "sp", causal=causal,
                                    kv_mask=mask, use_flash=use_flash,
                                    group=g)
        o.backward(torch.from_numpy(data["dO"][:, :, cut].copy()))
        out[f"{case}/o"] = o.detach().numpy()
        for t, name in ((q, "dq"), (k, "dk"), (v, "dv")):
            out[f"{case}/{name}"] = t.grad.numpy()
    out["routes"] = _routes()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def _comm(data, rank, groups):
    """The collective ops of :data:`COMM_CASES` over the tp group of the
    run, each on this rank's input and its cotangent: outputs and
    gradients."""
    ctx = registry.LoweringContext(torch.Generator(), torch.device("cpu"),
                                   dp=groups)
    out = {}
    for case, op, attrs in COMM_CASES:
        xin = torch.from_numpy(data[f"r{rank}/X"].copy()).requires_grad_(
            True)
        if op == "c_embedding":
            ins = {"W": [xin], "Ids": [torch.from_numpy(data["ids"])]}
        else:
            ins = {"X": [xin]}
        res = registry.get_op(op)(ctx, ins, dict(attrs))["Out"]
        res.backward(torch.from_numpy(data[f"r{rank}/G_{case}"].copy()))
        out[f"{case}/out"] = res.detach().numpy()
        out[f"{case}/grad"] = xin.grad.numpy()
    return out


def _load(inputs):
    data = np.load(inputs)
    init = {k[2:]: data[k] for k in data.files if k.startswith("p/")}
    steps = len({k.split("/", 1)[0] for k in data.files
                 if k[0] == "b" and k[1].isdigit()})
    batches = [{k.split("/", 1)[1]: data[k] for k in data.files
                if k.startswith(f"b{i}/")} for i in range(steps)]
    odd = {k.split("/", 1)[1]: data[k] for k in data.files
           if k.startswith("odd/")}
    return init, batches, odd


def _fill(scope, main, init):
    """The parameters of ``init`` (global values) into ``scope``; the
    optimizer's own state stays as its startup made it."""
    dtypes = {v.name: v.dtype for v in main.list_vars()}
    names = [p.name for p in main.all_parameters() if p.name in init]
    for n, t in io.convert_params({n: init[n] for n in names}, "cpu",
                                  dtypes).items():
        scope.set_var(n, t)


def _global_state(groups, main, scope):
    """Every persistable's global value (every rank calls this in the
    same order: the gathers are collectives)."""
    out = {}
    for v in sorted(main.list_vars(), key=lambda v: v.name):
        if v.persistable and scope.find_var(v.name) is not None:
            out[v.name] = io._to_numpy(
                whole_of(groups, v, scope.find_var(v.name))).copy()
    return out


def _held(main, scope):
    """This rank's persistables as it holds them (its blocks)."""
    return {v.name: io._to_numpy(scope.find_var(v.name)).copy()
            for v in main.list_vars()
            if v.persistable and torch.is_tensor(scope.find_var(v.name))}


def _mlp_program(tp):
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[6])
        ids = fluid.layers.data("ids", shape=[3], dtype="int64")
        h = parallel.column_parallel_fc(
            x, 16, tp, act="relu", param_attr=fluid.ParamAttr(name="w1"),
            bias_attr=fluid.ParamAttr(name="b1"))
        y = parallel.row_parallel_fc(
            h, 4, tp, param_attr=fluid.ParamAttr(name="w2"),
            bias_attr=fluid.ParamAttr(name="b2"))
        emb = parallel.vocab_parallel_embedding(
            ids, VOCAB, 4, tp, param_attr=fluid.ParamAttr(name="emb_w"))
        loss = fluid.layers.mean(fluid.layers.square(y)) + \
            fluid.layers.mean(fluid.layers.square(emb))
        fluid.optimizer.SGD(MLP_LR).minimize(loss)
    return main, startup, loss


def mlp(layout_name, inputs, out_dir):
    rank = int(os.environ["RANK"])
    _init(rank)
    init, batches, _ = _load(inputs)
    layout = MeshLayout(**MLP_LAYOUTS[layout_name])
    main, startup, loss = _mlp_program(layout.tp)
    main._mesh_layout = layout
    program = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=loss.name,
        batch_axis=layout.batch_axes)
    groups = program._dp
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    _fill(scope, main, init)
    losses = [float(np.asarray(exe.run(program, feed=b, fetch_list=[loss],
                                       scope=scope)[0]).reshape(()))
              for b in batches]
    out = {"losses": np.array(losses), "routes": _routes()}
    out.update(_comm(np.load(inputs), rank, groups))
    out.update({f"p/{n}": a for n, a in
                _global_state(groups, main, scope).items()})
    out.update({f"held/{n}": a for n, a in _held(main, scope).items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def _cfg():
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def bert_program(layout_name, opt):
    """The user's program under ``layout_name``: BERT-tiny built by
    ``build_pretrain_network_parallel`` at the layout's tp degree and
    sequence axis, ``opt`` minimized, ``with_mesh`` over the layout with
    every feed split ("dp", "sp").  Returns (compiled, main, startup,
    loss)."""
    kw, tp, seq = BERT_LAYOUTS[layout_name]
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        feeds, loss = bert.build_pretrain_network_parallel(
            _cfg(), tp_degree=tp, seq_axis=seq)
        (fluid.optimizer.SGD(SGD_LR) if opt == "sgd" else
         fluid.optimizer.Adam(ADAM_LR)).minimize(loss)
    layout = MeshLayout(**kw)
    main._mesh_layout = layout
    specs = {f.name: ("dp", "sp") for f in feeds} if seq else None
    compiled = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=loss.name, batch_axis="dp",
        seq_axis=seq, feed_specs=specs)
    return compiled, main, startup, loss


def bert_run(layout_name, inputs, out_dir):
    rank = int(os.environ["RANK"])
    _init(rank)
    init, batches, odd = _load(inputs)
    exe = fluid.Executor(fluid.CPUPlace())
    out = {}
    # SGD through Executor.run
    program, main, startup, loss = bert_program(layout_name, "sgd")
    groups = program._dp
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    _fill(scope, main, init)
    losses = []
    for i, b in enumerate(batches):
        losses.append(float(np.asarray(exe.run(
            program, feed=b, fetch_list=[loss], scope=scope)[0]).reshape(())))
        if i == 0:
            # the parameters after one step: the gradient, times the LR
            out.update({f"sgd1/p/{n}": a for n, a in
                        _global_state(groups, main, scope).items()
                        if n in init})
    out["sgd/losses"] = np.array(losses)
    out.update({f"sgd/p/{n}": a for n, a in
                _global_state(groups, main, scope).items()})
    if odd:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        _fill(scope, main, init)
        out["odd/loss"] = np.asarray(exe.run(
            program, feed=odd, fetch_list=[loss], scope=scope)[0])
    # Adam through a donated prepared step
    program, main, startup, loss = bert_program(layout_name, "adam")
    groups = program._dp
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    _fill(scope, main, init)
    step = exe.prepare(program, fetch_list=[loss], scope=scope,
                       donate_state=True)
    out["adam/losses"] = np.array([float(step.run(b)[0]) for b in batches])
    fluid.sync_prepared_state(scope)
    state = _global_state(groups, main, scope)
    out.update({f"adam/p/{n}": a for n, a in state.items()})
    held = _held(main, scope)
    out.update({f"held/{n}": a for n, a in held.items()})
    out["coords"] = np.array(
        [groups.coords[a] for a in groups.mesh.axis_names]
        if isinstance(groups, MeshGroups) else [groups.rank])
    out["routes"] = _routes()
    if layout_name == "tp2sp2":
        out.update(_checkpoints(exe, main, scope, held, out_dir))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def _checkpoints(exe, main, scope, held, out_dir):
    """Save the state three ways, restore the sharded and the async save
    onto this layout in fresh scopes: 1 where every held block comes back
    bit for bit."""
    st = io.TrainStatus(3)
    io.save_checkpoint(exe, os.path.join(out_dir, "ckpt"), st, main,
                       scope=scope, sharded=True)
    ck = io.AsyncCheckpointer()
    ck.save(exe, os.path.join(out_dir, "async"), st, main, scope=scope)
    ck.wait()
    io.save_checkpoint(exe, os.path.join(out_dir, "whole"), st, main,
                       scope=scope)
    out = {}
    for src in ("ckpt", "async"):
        fresh = fluid.Scope()
        got = io.load_checkpoint(exe, os.path.join(out_dir, src),
                                 main_program=main, scope=fresh)
        same = got.epoch_no == 3 and all(
            np.array_equal(io._to_numpy(fresh.find_var(n)), a)
            for n, a in held.items())
        out[f"restored/{src}"] = np.array(int(same))
    return out


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "ring":
        ring(sys.argv[2], sys.argv[3])
    elif mode == "mlp":
        mlp(*sys.argv[2:])
    elif mode == "bert":
        bert_run(*sys.argv[2:])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
