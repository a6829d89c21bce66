"""Rank program for the port's fsdp-beside-tp/sp tests, started by
``python -m paddle_tpu_torch.distributed.launch`` on the CPU over gloo:

    launch --nproc 4|8 --backend gloo --timeout T \\
        tests/torch_fsdp_tp_runner.py IN.npz OUT_DIR

The four-rank launch runs these legs, in this order:

* ``fsdp2tp2`` (``MeshLayout(fsdp=2, tp=2)``, the build at tp 2) and
  ``fsdp2sp2`` (``MeshLayout(fsdp=2, extra_axes={"sp": 2})``, the build
  at tp 1 with ring attention over ``sp``): BERT-tiny built by
  ``build_pretrain_network_parallel``, rewritten by
  ``apply_fsdp_sharding`` over the layout and compiled ``with_mesh``
  (the batch over fsdp, the sequence over sp), from the global
  parameters in ``IN.npz``: three SGD steps through ``Executor.run``,
  three SGD steps under the global-norm clip :data:`CLIP_NORM` and three
  Adam steps through ``prepare(donate_state=True)`` on the batches
  ``b<i>``;
* under ``fsdp2tp2`` the Adam state is saved sharded (``OUT_DIR/ckpt``)
  and whole (``OUT_DIR/whole``), and the sharded save is restored onto
  :data:`RESTORES` (tp 2 x sp 2, data 4, fsdp 4): each a freshly built
  program and ``Scope`` reading the files back, then one more Adam step
  on the batch ``next``;
* ``auto``: fleet's ``auto_shard`` with ``auto_shard_configs`` of
  ``IN.npz``'s ``budget_gb`` and ``max_tp`` 2 on the Adam program built
  at tp 2; its winner is stamped and trained three steps.

The eight-rank launch runs :data:`LEGS8`, fsdp beside two of the data,
tensor and sequence axes (dp 2 x fsdp 2 x tp 2, dp 2 x fsdp 2 x sp 2,
fsdp 2 x tp 2 x sp 2), each three SGD steps as above.

Writes ``OUT_DIR/rank<r>.npz``.  Imports the port only."""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from paddle_tpu_torch import fluid, io  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import (  # noqa: E402
    DistributedStrategy, PaddleCloudRoleMaker)
from paddle_tpu_torch.framework import unique_name  # noqa: E402
from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding  # noqa
from paddle_tpu_torch.framework.mesh_layout import MeshLayout  # noqa
from paddle_tpu_torch.framework.serialization import (  # noqa: E402
    program_to_desc)
from paddle_tpu_torch.models import bert  # noqa: E402
from paddle_tpu_torch.ops import registry  # noqa: E402
from paddle_tpu_torch.ops.collective_ops import whole_of  # noqa: E402

#: leg -> (MeshLayout kwargs, tp degree of the build, sequence axis)
LEGS = {"fsdp2tp2": ({"fsdp": 2, "tp": 2}, 2, None),
        "fsdp2sp2": ({"fsdp": 2, "extra_axes": {"sp": 2}}, 1, "sp")}
#: the eight-rank launch's legs, three axes above size 1 each (as LEGS)
LEGS8 = {"dp2fsdp2tp2": ({"data": 2, "fsdp": 2, "tp": 2}, 2, None),
         "dp2fsdp2sp2": ({"data": 2, "fsdp": 2, "extra_axes": {"sp": 2}},
                         1, "sp"),
         "fsdp2tp2sp2": ({"fsdp": 2, "tp": 2, "extra_axes": {"sp": 2}},
                         2, "sp")}
#: the restores of the fsdp2tp2 save: name -> (MeshLayout kwargs, tp
#: degree of the build, sequence axis)
RESTORES = {"tp2sp2": ({"tp": 2, "extra_axes": {"sp": 2}}, 2, "sp"),
            "data4": ({"data": 4}, 1, None),
            "fsdp4": ({"fsdp": 4}, 1, None)}
OPTS = ("sgd", "clip", "adam")
SGD_LR = 0.5
ADAM_LR = 1e-3
#: the ``clip`` runs' global-norm clip (one that binds)
CLIP_NORM = 0.5


def _cfg():
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def optimizer(fl, opt):
    """``opt``'s optimizer in the package ``fl`` (either one's ``fluid``):
    SGD, Adam, or SGD under the global-norm clip :data:`CLIP_NORM`."""
    if opt == "adam":
        return fl.optimizer.Adam(ADAM_LR)
    clip = fl.clip.GradientClipByGlobalNorm(CLIP_NORM) if opt == "clip" \
        else None
    return fl.optimizer.SGD(SGD_LR, grad_clip=clip)


def _feed_specs(feeds, layout, seq):
    """Every feed's dim 0 over the layout's batch axes and dim 1 over the
    sequence axis (None without one)."""
    if not seq:
        return None
    return {f.name: (layout.batch_axes, seq) for f in feeds}


def build(kw, tp, seq, opt):
    """The user's program: BERT-tiny at tp degree ``tp`` and sequence
    axis ``seq``, ``opt`` minimized, ``apply_fsdp_sharding`` over the
    layout (a no-op without a fsdp axis), ``with_mesh`` over it.
    Returns (compiled, main, startup, loss)."""
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        feeds, loss = bert.build_pretrain_network_parallel(
            _cfg(), tp_degree=tp, seq_axis=seq)
        optimizer(fluid, opt).minimize(loss)
    layout = MeshLayout(**kw)
    apply_fsdp_sharding(main, layout)
    main._mesh_layout = layout
    compiled = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=loss.name,
        batch_axis=layout.batch_axes, seq_axis=seq,
        feed_specs=_feed_specs(feeds, layout, seq))
    return compiled, main, startup, loss


def _load(inputs):
    data = np.load(inputs)
    init = {k[2:]: data[k] for k in data.files if k.startswith("p/")}
    steps = len({k.split("/", 1)[0] for k in data.files
                 if k[0] == "b" and k[1].isdigit()})
    batches = [{k.split("/", 1)[1]: data[k] for k in data.files
                if k.startswith(f"b{i}/")} for i in range(steps)]
    nxt = {k.split("/", 1)[1]: data[k] for k in data.files
           if k.startswith("next/")}
    return data, init, batches, nxt


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


def _routes():
    return np.array(sorted(f"{k[0]}:{k[1]}:{k[2]}:{k[3]}"
                           for k in registry.route_counts()))


def _loss(v):
    """The global loss: a fetched (1,) loss comes back one element a
    batch shard (gathered over the batch axes, as the JAX package's
    fetch), each the weighted mean of its shard's tokens."""
    return float(np.mean(np.asarray(v)))


def _estimate(name, compiled, main, held, feed):
    """The static estimate's persistent bytes of a rank under the run's
    layout at the feed's shapes, beside the bytes the rank holds of the
    persistables it prices and of those it leaves out."""
    from paddle_tpu_torch.framework import memory_analysis as ma
    loss = compiled._loss_name
    est = ma.estimate(
        main, feed_shapes={k: (tuple(v.shape), str(v.dtype))
                           for k, v in feed.items()},
        fetch_names=[loss], mesh_axes=compiled._mesh_axes,
        batch_axis=compiled._batch_axis, seq_axis=compiled._seq_axis,
        feed_specs=compiled._feed_specs)
    state_in, _ = ma._state_names(main, [loss])
    return {f"{name}/est_state": np.array(est.state_bytes),
            f"{name}/held_state": np.array(sum(
                held[n].nbytes for n in state_in if n in held)),
            f"{name}/held_other": np.array(json.dumps(sorted(
                (n, int(a.nbytes)) for n, a in held.items()
                if n not in state_in)))}


def leg(name, init, batches, opts=OPTS):
    """The runs of ``opts`` under leg ``name`` (of LEGS or LEGS8); returns
    (its outputs, (exe, main, scope, prepared step) of the last run, the
    step None unless it is Adam's)."""
    kw, tp, seq = {**LEGS, **LEGS8}[name]
    exe = fluid.Executor(fluid.CPUPlace())
    out = {}
    step = None
    registry.reset_route_counts()
    for opt in opts:
        compiled, main, startup, loss = build(kw, tp, seq, opt)
        groups = compiled._dp
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        _fill(scope, main, init)
        if opt == "adam":
            step = exe.prepare(compiled, fetch_list=[loss], scope=scope,
                               donate_state=True)
            losses = [_loss(step.run(b)[0]) for b in batches]
            fluid.sync_prepared_state(scope)
        else:
            losses = [_loss(exe.run(compiled, feed=b, fetch_list=[loss],
                                    scope=scope)[0]) for b in batches]
        out[f"{name}/{opt}/losses"] = np.array(losses)
        out.update({f"{name}/{opt}/p/{n}": a for n, a in
                    _global_state(groups, main, scope).items()})
        out[f"{name}/{opt}/allreduces"] = np.array(sorted(
            str(op.attrs["_axis_name"]) for op in main.global_block().ops
            if op.type == "c_global_norm_allreduce"))
    held = _held(main, scope)
    out.update({f"{name}/held/{n}": a for n, a in held.items()})
    out.update(_estimate(name, compiled, main, held, batches[0]))
    out[f"{name}/axes"] = np.array(list(groups.mesh.axis_names))
    out[f"{name}/coords"] = np.array(
        [groups.coords[a] for a in groups.mesh.axis_names])
    out[f"{name}/routes"] = _routes()
    out[f"{name}/desc"] = np.array(json.dumps(program_to_desc(main)))
    return out, (exe, main, scope, step)


def restores(exe, main, scope, step, nxt, out_dir):
    """Save the fsdp2tp2 Adam state (its prepared ``step`` synced into
    ``scope``) sharded and whole, restore the sharded save onto each of
    :data:`RESTORES` in a fresh program and scope, and take each
    layout's next step, the source's last."""
    out = {}
    st = io.TrainStatus(3)
    io.save_checkpoint(exe, os.path.join(out_dir, "ckpt"), st, main,
                       scope=scope, sharded=True)
    io.save_checkpoint(exe, os.path.join(out_dir, "whole"), st, main,
                       scope=scope)
    for name, (kw, tp, seq) in RESTORES.items():
        compiled, dmain, _, loss = build(kw, tp, seq, "adam")
        dscope = fluid.Scope()
        got = io.load_checkpoint(exe, os.path.join(out_dir, "ckpt"),
                                 main_program=dmain, scope=dscope)
        out[f"r/{name}/epoch"] = np.array(got.epoch_no)
        rs = got.read_stats or {}
        out[f"r/{name}/bytes_read"] = np.array(rs.get("bytes_read", -1))
        out[f"r/{name}/planned_bytes"] = np.array(
            rs.get("planned_bytes", -1))
        info = got.reshard or {}
        out[f"r/{name}/steps"] = np.array(json.dumps(
            info.get("steps_by_kind"), sort_keys=True))
        out[f"r/{name}/wire"] = np.array(info.get("wire_bytes", -1))
        out.update({f"r/{name}/p/{n}": a for n, a in
                    _global_state(compiled._dp, dmain, dscope).items()})
        dstep = exe.prepare(compiled, fetch_list=[loss], scope=dscope,
                            donate_state=True)
        out[f"r/{name}/next"] = np.array(_loss(dstep.run(nxt)[0]))
    out["r/fsdp2tp2/next"] = np.array(_loss(step.run(nxt)[0]))
    return out


def auto(data, init, batches):
    """fleet ``auto_shard`` over the four ranks with ``data``'s budget
    (``budget_gb``) and ``max_tp`` 2 on the Adam program built at tp 2,
    the feeds' shapes those of the first batch."""
    budget = float(data["budget_gb"])
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        feeds, loss = bert.build_pretrain_network_parallel(
            _cfg(), tp_degree=2)
        s = DistributedStrategy()
        s.auto_shard = True
        s.auto_shard_configs = {
            "hbm_budget_gb": float(budget), "max_tp": 2,
            "feed_shapes": {f.name: (tuple(int(n) for n in data[
                f"b0/{f.name}"].shape), str(data[f"b0/{f.name}"].dtype))
                for f in feeds}}
        fleet.distributed_optimizer(optimizer(fluid, "adam"), s).minimize(
            loss)
    compiled = fleet.main_program
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    _fill(scope, main, init)
    losses = [_loss(exe.run(compiled, feed=b, fetch_list=[loss],
                            scope=scope)[0]) for b in batches]
    layout = main._mesh_layout
    out = {"auto/layout": np.array(json.dumps(layout.sizes)),
           "auto/losses": np.array(losses),
           "auto/ranked": np.array(json.dumps(
               [c.layout.sizes for c in fleet._plan.configs]))}
    out.update({f"auto/p/{n}": a for n, a in
                _global_state(compiled._dp, main, scope).items()})
    return out


def main(inputs, out_dir):
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    fleet.init(PaddleCloudRoleMaker(place=fluid.CPUPlace()))
    assert fleet.worker_num() in (4, 8)
    data, init, batches, nxt = _load(inputs)
    out = {}
    if fleet.worker_num() == 8:
        for name in sorted(LEGS8):
            out.update(leg(name, init, batches, opts=("sgd",))[0])
    else:
        out.update(leg("fsdp2sp2", init, batches)[0])
        o, adam = leg("fsdp2tp2", init, batches)
        out.update(o)
        out.update(restores(*adam, nxt, out_dir))
        out.update(auto(data, init, batches))
    out["jax_imported"] = np.array(
        [m for m in sys.modules if m == "jax" or m.startswith(("jax.",
                                                               "paddle_tpu."))
         or m == "paddle_tpu"])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
