"""Tensor and sequence parallelism through the port against the JAX
package: BERT-tiny (2 layers, B4 x S64, dropout 0) built by
``build_pretrain_network_parallel`` at tp 2, sp 2 and tp 2 x sp 2, the
port as gloo processes on the CPU (``tests/torch_tp_runner.py``), held to
the JAX package's ONE-DEVICE run of the same program built with
``tp_degree=1, seq_axis=None`` from the same global weights — what the
model means (the JAX mesh run scales tp gradients, pinned below).

* 3 SGD steps through ``Executor.run`` and 3 Adam steps through
  ``prepare(donate_state=True)``: losses within ``TOL`` = 1e-5 (the HSDP
  tests' float32 tolerance), every parameter within ``TOL`` after SGD and
  within ``TOL_ADAM`` = 1e-4 (a tenth of Adam's LR) after Adam, on
  batches whose ``lm_weights`` rows hold the same masked count in each sp
  shard (the loss is the per-shard weighted mean, averaged over the
  shards).  Adam divides each gradient by its own magnitude, so an
  element whose gradient is near the float32 rounding of the sum moves
  by up to its LR in either package: the attention key biases, whose
  exact gradient is 0 (a bias on every key of a query row shifts its
  scores by a constant), are left out of the Adam comparison.
* With unequal masked counts per sp shard the port's loss is the mean of
  the per-shard weighted means, computed here from the JAX run's per-token
  losses (within ``TOL``).
* The port's tp gradients are 1x the one-device gradients; the JAX mesh
  run's are 2x (4x for ``word_embedding``): the autodiff transposes of
  ``c_allgather`` and of ``c_embedding``'s forward sum add the replicated
  cotangent over tp (a Reference caveat, ROADMAP.md).
* Checkpoints under tp x sp: ``save_checkpoint(sharded=True)`` and
  ``AsyncCheckpointer`` write each block once and restore onto the same
  layout bit for bit; the whole save loads into the one-rank
  ``tp_degree=1`` program bit for bit; a restore onto another tp layout,
  and pipe or expert axes, are refused by name.

Each launch has its own timeout, so a hung collective fails its test."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import compiler as jcompiler
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert
from paddle_tpu.parallel import build_mesh as jbuild_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_tp_runner.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_tp_runner import ADAM_LR, SGD_LR  # noqa: E402

LAYOUTS = {"tp2": 2, "sp2": 2, "tp2sp2": 4}
STEPS = 3
BATCH, SEQ, PER_SHARD = 4, 64, 5
LAUNCH_TIMEOUT_S = 300
TOL = 1e-5          # losses, and parameters after SGD (float32)
TOL_ADAM = 1e-4     # parameters after Adam: a tenth of ADAM_LR
ZERO_GRAD = "_attn_k.b_"


def _cfg():
    cfg = jbert.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _batch(rng, counts):
    """make_fake_parallel_batch's feeds with ``counts[h]`` masked tokens in
    half h (the sp 2 shard) of every row."""
    d = jbert.make_fake_parallel_batch(rng, _cfg(), BATCH, SEQ)
    w = np.zeros((BATCH, SEQ), np.float32)
    half = SEQ // 2
    for i in range(BATCH):
        for h, c in enumerate(counts):
            w[i, h * half + rng.choice(half, c, replace=False)] = 1.0
    d["lm_weights"] = w
    return d


def _jax_program(opt, tp=1, seq_axis=None):
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = 3
    with jfluid.program_guard(main, startup):
        _, loss = jbert.build_pretrain_network_parallel(
            _cfg(), tp_degree=tp, seq_axis=seq_axis)
        (jfluid.optimizer.SGD(SGD_LR) if opt == "sgd" else
         jfluid.optimizer.Adam(ADAM_LR)).minimize(loss)
    return main, startup, loss


def _per_token_name(main):
    return next(op.outputs["Out"][0] for op in main.global_block().ops
                if op.type == "squeeze2")


def launch(tmp, nproc, *args):
    out_dir = tmp / "out"
    out_dir.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--backend", "gloo",
           "--timeout", str(LAUNCH_TIMEOUT_S), RUNNER, *args, str(out_dir)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S + 60,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(nproc)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX one-device runs (SGD and Adam) and the runner's inputs."""
    rng = np.random.RandomState(0)
    batches = [_batch(rng, (PER_SHARD, PER_SHARD)) for _ in range(STEPS)]
    odd = _batch(rng, (2, 9))
    out = {"batches": batches, "odd": odd}
    for opt in ("sgd", "adam"):
        main, startup, loss = _jax_program(opt)
        scope = jfluid.Scope()
        exe = jfluid.Executor(jfluid.CPUPlace())
        with jfluid.scope_guard(scope):
            exe.run(startup)
            params = {p.name for p in main.all_parameters()}
            init = {n: np.asarray(scope.find_var(n)) for n in params}
            losses = []
            for i, b in enumerate(batches):
                losses.append(float(np.asarray(exe.run(
                    main, feed=b, fetch_list=[loss])[0]).reshape(-1)[0]))
                if i == 0 and opt == "sgd":
                    out["sgd1"] = {n: np.asarray(scope.find_var(n))
                                   for n in params}
            out[opt] = {"losses": losses, "init": init, "final": {
                n: np.asarray(scope.find_var(n)) for n in params}}
        if opt == "sgd":
            # the odd batch's per-token losses from the initial weights
            scope = jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe.run(startup)
                out["odd_tok"] = np.asarray(exe.run(
                    main, feed=odd,
                    fetch_list=[_per_token_name(main)])[0])
    assert all(np.array_equal(out["sgd"]["init"][n], a)
               for n, a in out["adam"]["init"].items())
    tmp = tmp_path_factory.mktemp("tp_sp_bert")
    arrays = {f"p/{n}": a for n, a in out["sgd"]["init"].items()}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    arrays.update({f"odd/{k}": v for k, v in odd.items()})
    np.savez(tmp / "in.npz", **arrays)
    out["in"] = tmp / "in.npz"
    out["tmp"] = tmp_path_factory
    return out


_RUNS = {}


@pytest.fixture
def ranks(ref):
    def get(layout):
        if layout not in _RUNS:
            tmp = ref["tmp"].mktemp(layout)
            _RUNS[layout] = (launch(tmp, LAYOUTS[layout], "bert", layout,
                                    str(ref["in"])), tmp / "out")
        return _RUNS[layout]
    return get


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_the_slice_trains_like_the_one_device_jax_run(ref, ranks, layout,
                                                      opt):
    outs, _ = ranks(layout)
    want = ref[opt]
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{opt}/losses"], want["losses"],
                                   rtol=0, atol=TOL, err_msg=f"rank {r}")
        for n, w in want["final"].items():
            if opt == "adam" and ZERO_GRAD in n:
                continue
            got = out[f"{opt}/p/{n}"]
            assert got.shape == w.shape, n
            tol = TOL if opt == "sgd" else TOL_ADAM
            np.testing.assert_allclose(got, w, rtol=tol, atol=tol,
                                       err_msg=f"rank {r} {n}")
    routes = [str(x) for x in outs[0]["routes"]]
    assert not [x for x in routes if ":fallback:" in x], routes
    ring = [x for x in routes if x.startswith(
        "fused_attention:ring_flash_attention:hit")]
    assert bool(ring) == ("sp" in layout), routes


@pytest.mark.parametrize("layout", ["sp2", "tp2sp2"])
def test_unequal_masked_counts_give_the_mean_of_shard_means(ref, ranks,
                                                            layout):
    """(2, 9) masked tokens a row in the two sp shards: the fetched loss is
    the mean over the shards of each shard's weighted mean."""
    outs, _ = ranks(layout)
    tok, w = ref["odd_tok"], ref["odd"]["lm_weights"]
    half = SEQ // 2
    means = [float((tok[:, h * half:(h + 1) * half] *
                    w[:, h * half:(h + 1) * half]).sum() /
                   (w[:, h * half:(h + 1) * half].sum() + 1e-6))
             for h in range(2)]
    for out in outs:
        np.testing.assert_allclose(float(out["odd/loss"].reshape(-1)[0]),
                                   np.mean(means), rtol=0, atol=TOL)


def test_tp_gradients_are_the_one_device_gradients(ref, ranks):
    """The port's first SGD step at tp 2 moves every parameter by the
    one-device gradient (ratio 1); the JAX mesh run at tp 2 moves it by 2x
    (4x for ``word_embedding``) — the caveat stays true and visible."""
    outs, _ = ranks("tp2")
    init, one = ref["sgd"]["init"], ref["sgd1"]
    main, startup, loss = _jax_program("sgd", tp=2)
    mesh = jbuild_mesh({"tp": 2}, jax.devices()[:2])
    compiled = jfluid.CompiledProgram(main).with_mesh(
        mesh, loss_name=loss.name, batch_axis="dp")
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for n, a in init.items():
            scope.set_var(n, a)
        exe.run(compiled, feed=ref["batches"][0], fetch_list=[loss])
        jax_mesh = {n: np.asarray(scope.find_var(n)) for n in init}
    ratios = {"port": {}, "jax_mesh": {}}
    for n in init:
        d_one = (one[n] - init[n]).astype(np.float64)
        if np.abs(d_one).max() < 1e-5:       # no gradient to speak of
            continue
        for who, after in (("port", outs[0][f"sgd1/p/{n}"]),
                           ("jax_mesh", jax_mesh[n])):
            d = (after - init[n]).astype(np.float64)
            ratios[who][n] = float((d * d_one).sum() / (d_one * d_one).sum())
    assert len(ratios["port"]) > 30
    for n, r in ratios["port"].items():
        assert abs(r - 1.0) < 1e-3, (n, r)
    for n, r in ratios["jax_mesh"].items():
        want = 4.0 if n == "word_embedding" else 2.0
        assert abs(r - want) < 1e-2, (n, r)


def test_each_rank_holds_its_tp_block_and_the_tp_ranks_agree(ref, ranks):
    """tp x sp: a tp-stamped persistable is held at half its width (its
    block at the rank's tp coordinate), the rest whole; the replicated
    persistables are bit for bit equal across the ranks."""
    outs, _ = ranks("tp2sp2")
    final = ref["adam"]["final"]
    main, _, _ = _jax_program("adam", tp=2, seq_axis="sp")
    stamped = {v.name: v.dist_attr for v in main.list_vars()
               if v.persistable and getattr(v, "dist_attr", None)}
    assert {"word_embedding", "mask_lm_out_w"} <= set(stamped)
    for r, out in enumerate(outs):
        assert list(out["coords"]) == [r // 2, r % 2]
        for n, w in final.items():
            got = out[f"held/{n}"]
            if n in stamped:
                d = [i for i, e in enumerate(stamped[n]) if e][0]
                shape = list(w.shape)
                shape[d] //= 2
                assert list(got.shape) == shape, n
                tp = r // 2
                np.testing.assert_array_equal(
                    got, np.split(out[f"adam/p/{n}"], 2, axis=d)[tp])
            else:
                assert got.shape == w.shape, n
                np.testing.assert_array_equal(got, outs[0][f"held/{n}"])


def test_the_program_is_the_jax_packages_desc():
    """``build_pretrain_network_parallel(tp 2, sp)`` + Adam and the
    gradient sync over ("dp", "sp") are the JAX package's desc, op for op
    and attr for attr, dist_attr included."""
    from paddle_tpu_torch import fluid as tfluid
    from paddle_tpu_torch.framework import compiler as tcompiler
    from paddle_tpu_torch.framework import unique_name as tun
    from paddle_tpu_torch.framework.serialization import (
        program_to_desc as tdesc)
    from paddle_tpu_torch.models import bert as tbert
    descs = []
    for fl, un, model, comp, to_desc in (
            (jfluid, jun, jbert, jcompiler, jdesc),
            (tfluid, tun, tbert, tcompiler, tdesc)):
        un.reset()
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            cfg = model.BertConfig.tiny()
            _, loss = model.build_pretrain_network_parallel(
                cfg, tp_degree=2, seq_axis="sp")
            fl.optimizer.Adam(ADAM_LR).minimize(loss)
        bs = fl.BuildStrategy()
        bs.fuse_all_reduce_ops = True
        comp.insert_grad_sync(main, bs, 4, ("dp", "sp"),
                              axis_sizes={"dp": 2, "tp": 2, "sp": 2})
        descs.append((json.dumps(to_desc(main)),
                      json.dumps(to_desc(startup))))
    assert descs[0] == descs[1]
    ops = json.loads(descs[1][0])["blocks"][0]["ops"]
    types = [op["type"] for op in ops]
    assert {"mp_copy", "mp_allreduce_sum", "c_embedding",
            "c_allgather"} <= set(types)
    assert [op["attrs"]["_seq_axis"] for op in ops
            if op["type"] == "fused_attention"] == ["sp"] * 2


# ---------------------------------------------------------------------------
# checkpoints under tp x sp
# ---------------------------------------------------------------------------


def test_sharded_saves_write_each_block_once_and_restore_in_place(
        ref, ranks):
    outs, out_dir = ranks("tp2sp2")
    for r, out in enumerate(outs):
        assert int(out["restored/ckpt"]) == 1, r
        assert int(out["restored/async"]) == 1, r
    d = str(out_dir / "ckpt" / f"checkpoint_{STEPS}")
    seen, covered = set(), {}
    for r in range(4):
        with open(os.path.join(d, f"shard_manifest_{r}.json")) as f:
            man = json.load(f)
        assert dict(man["mesh_layout"]["axes"]) == {
            "dp": 1, "fsdp": 1, "tp": 2, "sp": 2}
        for name, rec in man["vars"].items():
            for e in rec["shards"]:
                key = (name, json.dumps(e["index"]))
                assert key not in seen, key
                seen.add(key)
                n = np.prod(rec["shape"]) if e["index"] is None else \
                    np.prod([b - a for a, b in e["index"]])
                covered[name] = covered.get(name, 0) + int(n)
        if r % 2:
            # sp coordinate 1: a replica of its sp-0 peer's blocks
            assert man["vars"] == {}
    state = {k[len("adam/p/"):]: v for k, v in outs[0].items()
             if k.startswith("adam/p/")}
    assert covered == {n: a.size for n, a in state.items()}


def test_the_whole_save_loads_into_the_one_rank_program(ref, ranks):
    """The gathered (whole) save of the tp x sp run into the port's
    one-rank ``tp_degree=1`` program: every persistable bit for bit."""
    from paddle_tpu_torch import fluid as tfluid
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.framework import unique_name as tun
    from paddle_tpu_torch.models import bert as tbert
    outs, out_dir = ranks("tp2sp2")
    tun.reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        _, loss = tbert.build_pretrain_network_parallel(_cfg())
        tfluid.optimizer.Adam(ADAM_LR).minimize(loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    st = tio.load_checkpoint(exe, str(out_dir / "whole"), main_program=main,
                             scope=scope)
    assert st.epoch_no == STEPS
    names = [v.name for v in main.list_vars() if v.persistable]
    assert names
    for n in names:
        np.testing.assert_array_equal(
            tio._to_numpy(scope.find_var(n)), outs[0][f"adam/p/{n}"],
            err_msg=n)


def test_a_restore_onto_another_tp_layout_is_refused_by_name(ref, ranks):
    from paddle_tpu_torch import fluid as tfluid
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.framework.errors import UnimplementedError
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    from paddle_tpu_torch.models import bert as tbert
    _, out_dir = ranks("tp2sp2")
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        _, loss = tbert.build_pretrain_network_parallel(_cfg(), 2, "sp")
        tfluid.optimizer.Adam(ADAM_LR).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    for dst in (MeshLayout(tp=4), MeshLayout(extra_axes={"sp": 4}),
                MeshLayout(data=2)):
        with pytest.raises(UnimplementedError,
                           match="tensor or sequence layout"):
            tio.load_checkpoint(exe, str(out_dir / "ckpt"),
                                main_program=main, scope=tfluid.Scope(),
                                dst_layout=dst)
    for dst, axis in ((MeshLayout(pipe=2), "pp"),
                      (MeshLayout(expert=2), "ep")):
        with pytest.raises(UnimplementedError, match=f"{axis}.*not ported"):
            tio.load_checkpoint(exe, str(out_dir / "ckpt"),
                                main_program=main, scope=tfluid.Scope(),
                                dst_layout=dst)
