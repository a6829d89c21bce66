"""The port's resharding planner (``paddle_tpu_torch/framework/
reshard.py``) and its verifier (``framework/analysis.verify_reshard``)
against the JAX package's, on every layout pair and spec that
``tests/test_reshard.py`` plans:

* ``plan_reshard(...).as_dict()`` is the JAX package's, key for key, less
  the priced ``wire_time_ms`` / ``exposed_comm_ms`` (``ReshardPlan.price``
  needs the exposed-comm model, which the port has not yet: it raises by
  name);
* ``execute_reshard`` on seeded arrays is the JAX one bit for bit, and so
  are its moved-byte counts;
* ``verify_reshard`` gives the same diagnostics, on the plans as made and
  on a schedule broken by hand; a plan that does not validate raises the
  same ``InvalidArgumentError``;
* the restore's reader reads only the planned bytes of a sharded
  checkpoint (the JAX package's
  ``test_restore_reads_only_planned_slice_bytes``), with the JAX reader's
  counts and arrays."""

import json
import os

import numpy as np
import pytest

from paddle_tpu import io as jio
from paddle_tpu.framework import analysis as janalysis
from paddle_tpu.framework import reshard as jreshard
from paddle_tpu.framework.errors import (
    InvalidArgumentError as JInvalidArgumentError)
from paddle_tpu.framework.mesh_layout import (MeshLayout as JLayout,
                                              ShardSpec as JSpec)

from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import analysis as tanalysis
from paddle_tpu_torch.framework import reshard as treshard
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.framework.mesh_layout import (MeshLayout as TLayout,
                                                    ShardSpec as TSpec)

PKGS = {"jax": (jreshard, janalysis, JLayout, JSpec),
        "port": (treshard, tanalysis, TLayout, TSpec)}

#: the plans of tests/test_reshard.py: (id, src layout, dst layout,
#: var_sigs, src specs, dst specs, flat_meta)
CASES = [
    ("fsdp8-fsdp4", {"fsdp": 8}, {"fsdp": 4}, {"w": ((64, 32), "float32")},
     {"w": ("fsdp", None)}, None, None),
    ("fsdp8-fsdp16", {"fsdp": 8}, {"fsdp": 16},
     {"w": ((64, 32), "float32")}, {"w": ("fsdp", None)}, None, None),
    ("dp4tp2-dp8", {"data": 4, "tp": 2}, {"data": 8, "tp": 1},
     {"wq": ((32, 64), "float32"), "b": ((64,), "float32")},
     {"wq": (None, "tp")}, None, None),
    ("fsdp8-fsdp6", {"fsdp": 8}, {"fsdp": 6}, {"w": ((48, 4), "float32")},
     {"w": ("fsdp", None)}, None, None),
    ("fsdp8-fsdp4-two-vars", {"fsdp": 8}, {"fsdp": 4},
     {"w": ((64, 32), "float32"), "v": ((48, 4), "float32")},
     {"w": ("fsdp", None), "v": ("fsdp", None)}, None, None),
    ("fsdp8-fsdp6-execute", {"fsdp": 8}, {"fsdp": 6},
     {"w": ((48, 32), "float32"), "v": ((48, 4), "float32")},
     {"w": ("fsdp", None), "v": ("fsdp", None)}, None, None),
    ("zero1-repad-dp8-dp4", {"data": 8}, {"data": 4},
     {"m0": ((2048,), "float32")}, None, None,
     {"m0": {"numel": 1300, "align": 128, "axes": ["dp"]}}),
    ("indivisible-fsdp8-fsdp3", {"fsdp": 8}, {"fsdp": 3},
     {"w": ((30, 4), "float32")}, {"w": ("fsdp", None)}, None, None),
    ("dangling-sp", {"data": 8}, {"data": 4}, {"w": ((64, 4), "float32")},
     {"w": ("sp", None)}, None, None),
    ("read-ranges-dp4-dp8", {"data": 4}, {"data": 8},
     {"w": ((256, 8), "float32"), "b": ((64,), "float32")},
     {"w": ("dp", None)}, {"w": ("dp", None)}, None),
    ("flat-clamp-dp2-dp4", {"data": 2}, {"data": 4},
     {"f": ((1024,), "float32")}, None, None,
     {"f": {"numel": 1000, "align": 128, "axes": ["dp"], "src_pad": 1024,
            "n_src": 2, "dst_pad": 1024, "n_dst": 4}}),
    # the layouts of this slice's restores: HSDP onto fsdp 4 and onto
    # plain data parallelism
    ("hsdp-fsdp4", {"data": 2, "fsdp": 2}, {"fsdp": 4},
     {"w": ((64, 32), "float32"), "b": ((32,), "float32")},
     {"w": ("fsdp", None)}, None, None),
    ("hsdp-data2", {"data": 2, "fsdp": 2}, {"data": 2},
     {"w": ((64, 32), "float32"), "b": ((32,), "float32")},
     {"w": ("fsdp", None)}, {}, None),
]
IDS = [c[0] for c in CASES]


def _plan(pkg, case, validate=False):
    reshard, _, Layout, Spec = PKGS[pkg]
    _, src, dst, sigs, src_specs, dst_specs, flat = case
    return reshard.plan_reshard(
        Layout(**src), Layout(**dst), var_sigs=sigs,
        src_specs={k: Spec(v) for k, v in (src_specs or {}).items()},
        dst_specs=None if dst_specs is None else
        {k: Spec(v) for k, v in dst_specs.items()},
        flat_meta=None if flat is None else {k: dict(v)
                                             for k, v in flat.items()},
        validate=validate)


def _jax_dict(plan):
    d = plan.as_dict()
    d.pop("wire_time_ms", None)
    d.pop("exposed_comm_ms", None)
    return d


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plan_is_the_jax_packages(case):
    want = _jax_dict(_plan("jax", case))
    got = _plan("port", case).as_dict()
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_verify_reshard_gives_the_jax_diagnostics(case):
    diags = []
    for pkg in ("jax", "port"):
        res = PKGS[pkg][1].verify_reshard(_plan(pkg, case))
        diags.append([(d.severity, d.code, d.message)
                      for d in res.diagnostics])
    assert diags[0] == diags[1]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_a_plan_that_does_not_validate_raises_the_jax_error(case):
    errs = []
    for pkg, exc in (("jax", JInvalidArgumentError),
                     ("port", InvalidArgumentError)):
        try:
            _plan(pkg, case, validate=True)
            errs.append(None)
        except exc as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[1] is not None) == case[0].startswith("indivisible")


def test_a_broken_schedule_gets_the_jax_diagnostic():
    diags = []
    for pkg in ("jax", "port"):
        plan = _plan(pkg, CASES[0])
        plan.transfers["w"].steps[0].src_parts = 5
        res = PKGS[pkg][1].verify_reshard(plan)
        diags.append([(d.severity, d.code, d.message)
                      for d in res.diagnostics])
        assert [c for _, c, _ in diags[-1]] == ["reshard-divs-unresolved"]
    assert diags[0] == diags[1]


def test_flat_var_transfer_is_the_jax_packages():
    out = []
    for pkg in ("jax", "port"):
        reshard, _, Layout, Spec = PKGS[pkg]
        tr = reshard.plan_var_transfer(
            "m0", (2048,), "float32", Spec(("dp",)), Layout(data=8),
            Spec(("dp",)), Layout(data=4),
            flat={"numel": 1300, "align": 128, "axes": ["dp"]})
        out.append(json.dumps(tr.as_dict(), sort_keys=True))
    assert out[0] == out[1]


@pytest.mark.parametrize("case", [c for c in CASES
                                  if not c[0].startswith("indivisible")],
                         ids=[i for i in IDS
                              if not i.startswith("indivisible")])
def test_execute_reshard_is_the_jax_one_bit_for_bit(case):
    rng = np.random.RandomState(sum(map(ord, case[0])))
    arrays = {}
    for name, (shape, dtype) in sorted(case[3].items()):
        arrays[name] = rng.randn(*shape).astype(dtype)
    for name, rec in (case[6] or {}).items():
        arrays[name][rec["numel"]:] = 0         # the flat pad is zero
    results = []
    for pkg in ("jax", "port"):
        reshard = PKGS[pkg][0]
        plan = _plan(pkg, case)
        results.append(reshard.execute_reshard(
            plan, {k: v.copy() for k, v in arrays.items()}))
    (jout, jstats), (tout, tstats) = results
    assert tstats == jstats
    assert sorted(tout) == sorted(jout)
    for name in jout:
        assert tout[name].dtype == jout[name].dtype
        assert np.array_equal(tout[name], jout[name]), name


def test_dst_read_ranges_are_the_jax_packages():
    for case, owned in ((CASES[9], {"w": [5, 6]}),
                        (CASES[10], {"f": [3]}), (CASES[10], {"f": [0]}),
                        (CASES[11], {"w": [1, 2]})):
        got = _plan("port", case).dst_read_ranges(owned)
        assert got == _plan("jax", case).dst_read_ranges(owned)
    assert _plan("port", CASES[9]).dst_read_ranges({"w": [5, 6]}) == \
        {"w": [(160, 224)]}


def test_price_and_fault_drills_wait_for_their_slices():
    plan = _plan("port", CASES[0])
    jplan = _plan("jax", CASES[0])
    # the restore is priced through the port's exposed_comm_model now
    got, want = plan.price(ici_gbps=0.75), jplan.price(ici_gbps=0.75)
    assert got["link_gbps"] == want["ici_gbps"] == 0.75
    for k, v in want.items():
        if k not in ("ici_gbps", "peak_flops"):
            assert got[k] == v, k
    assert plan.wire_summary() == jplan.wire_summary()
    # the reshard_execute seam strikes between per-var transfers, in the
    # port (armed through arm_fault) as in the JAX package
    from paddle_tpu.testing import faultline as jfl
    from paddle_tpu_torch.testing import faultline as tfl
    case = CASES[5]
    arrays = {n: np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
              for n, (shape, _) in case[3].items()}
    for pkg, fl, arm in (("jax", jfl, lambda: jfl.arm(
            "reshard_execute", action="raise", at=1)),
            ("port", tfl, lambda: treshard.arm_fault(action="raise",
                                                      at=1))):
        reshard = PKGS[pkg][0]
        spec = arm()
        try:
            with pytest.raises(fl.FaultlineError, match="reshard_execute"):
                reshard.execute_reshard(_plan(pkg, case), arrays)
            assert (spec.hits, spec.fired) == (2, 1)
        finally:
            fl.disarm()
    got, _ = treshard.execute_reshard(_plan("port", case), arrays)
    want, _ = jreshard.execute_reshard(_plan("jax", case), arrays)
    assert all(np.array_equal(got[n], want[n]) for n in want)


def _fake_sharded_ckpt(d, w, b, n_shards):
    """The JAX test's checkpoint: ``w`` in ``n_shards`` dim-0 blocks and
    ``b`` whole, in one process's files."""
    os.makedirs(d, exist_ok=True)
    h = w.shape[0] // n_shards
    arrays = {f"w@{k}": w[k * h:(k + 1) * h] for k in range(n_shards)}
    arrays["b@full"] = b
    manifest = {
        "w": {"shape": list(w.shape), "dtype": str(w.dtype),
              "shards": [{"key": f"w@{k}",
                          "index": [[k * h, (k + 1) * h], [0, w.shape[1]]]}
                         for k in range(n_shards)]},
        "b": {"shape": list(b.shape), "dtype": str(b.dtype),
              "shards": [{"key": "b@full", "index": None}]}}
    np.savez(os.path.join(d, "shard_data_0.npz"), **arrays)
    with open(os.path.join(d, "shard_manifest_0.json"), "w") as f:
        json.dump({"format_version": 2, "vars": manifest}, f)


def test_restore_reads_only_planned_slice_bytes(tmp_path):
    """A rank that holds blocks 5 and 6 of 8 under the destination reads
    exactly their rows: bytes read equal the planned slice bytes, the
    blocks outside are never read, and the owned rows are the saved ones
    — as the JAX reader reads them."""
    d = str(tmp_path)
    w = np.arange(256 * 8, dtype="float32").reshape(256, 8)
    b = np.arange(64, dtype="float32")
    _fake_sharded_ckpt(d, w, b, n_shards=4)
    plan = _plan("port", CASES[9])
    ranges = plan.dst_read_ranges({"w": [5, 6]})
    got_stats, want_stats = {}, {}
    out = tio._read_sharded_arrays(d, row_ranges=ranges,
                                   read_stats=got_stats)
    want = jio._read_sharded_arrays(d, row_ranges=ranges,
                                    read_stats=want_stats)
    planned = sum(hi - lo for lo, hi in ranges["w"]) * 8 * 4 + b.nbytes
    assert got_stats["bytes_read"] == planned
    assert tio._planned_bytes(d, None, ranges) == planned
    assert got_stats == want_stats
    assert got_stats["members_skipped"] == 2
    assert got_stats["members_partial"] == 2
    for k in want:
        assert np.array_equal(out[k], want[k]), k
    assert np.array_equal(out["w"][160:224], w[160:224])
    assert not out["w"][:160].any() and not out["w"][224:].any()
    full_stats = {}
    full = tio._read_sharded_arrays(d, read_stats=full_stats)
    assert np.array_equal(full["w"], w) and np.array_equal(full["b"], b)
    assert full_stats["bytes_read"] == w.nbytes + b.nbytes
