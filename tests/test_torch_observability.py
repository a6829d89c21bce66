"""The port's observability layer (``observability/``, ``profiler.py``,
``monitor.py``) held against the JAX package on the CPU:

* the span names of one prepared step, one ``Executor.run``, one served
  batch and one checkpoint are the JAX package's for the same program;
* the telemetry recorder's JSONL passes both packages'
  ``validate_jsonl``; MFU is exact with pinned inputs and the peak follows
  the program's GEMM dtype;
* the Prometheus text for one sequence of registry calls is byte for byte
  the JAX package's;
* flight bundles are written on a non-finite loss and on a raising op,
  and nothing is written with the recorder off;
* ``check_nan_inf`` names the var, and its per-op mode the op, the JAX
  package names;
* the collective span's attributes, the profiler's state on a stop that
  raises, the Chrome trace, the timeline merge, the metrics endpoint and
  the new modules' imports.

No wall-clock assertion."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import recorder as jrecorder
from paddle_tpu.observability import tracing as jtracing

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import monitor, profiler
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.observability import (TelemetryRecorder, flight,
                                            flops, metrics, tracing,
                                            validate_jsonl)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: span names only the JAX package has: its persistent executable cache
JAX_ONLY_SPANS = {"aot_cache::load", "aot_cache::save"}


@pytest.fixture(autouse=True)
def fresh(tmp_path):
    keep = (jflags.get_flags(["flight_dump_dir", "flight_recorder",
                              "check_nan_inf", "check_nan_inf_per_op"]),
            tflags.get_flags(["flight_dump_dir", "flight_recorder",
                              "check_nan_inf", "check_nan_inf_per_op"]))
    for f in (jflags, tflags):
        f.set_flags({"flight_dump_dir": str(tmp_path / "flight")})
    for tr in (jtracing, tracing):
        tr.disable()
        tr.clear_events()
    metrics.reset_metrics()
    jmetrics.reset_metrics()
    flight.reset()
    yield
    for tr in (jtracing, tracing):
        tr.disable()
        tr.clear_events()
    metrics.reset_metrics()
    jflags.set_flags(keep[0])
    tflags.set_flags(keep[1])


def _fc_train(fluid, core, un, width=6):
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 3
    with core.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[width])
        h = fluid.layers.fc(x, 8)
        loss = fluid.layers.mean(fluid.layers.fc(h, 3))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


FEED = {"x": np.ones((2, 6), np.float32)}
PKGS = {"jax": (jfluid, jcore, jun, jtracing),
        "port": (tfluid, tcore, tun, tracing)}


def _names(tr):
    return {e[0] for e in tr.get_events()}


def _traced(tr, fn):
    tr.clear_events()
    tr.enable()
    try:
        fn()
    finally:
        tr.disable()
    return _names(tr)


def _prepared_step(pkg):
    fluid, core, un, tr = PKGS[pkg]
    main, startup, loss = _fc_train(fluid, core, un)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    kw = {"donate_state": True}

    def step():
        prepared = exe.prepare(main, fetch_list=[loss], scope=scope, **kw)
        prepared.run(FEED)[0].numpy()
        prepared.sync_scope()
    return _traced(tr, step)


def _executor_run(pkg):
    fluid, core, un, tr = PKGS[pkg]
    main, startup, loss = _fc_train(fluid, core, un)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        return _traced(tr, lambda: exe.run(main, feed=FEED,
                                           fetch_list=[loss]))


def _checkpoint(pkg, tmp_path):
    fluid, core, un, tr = PKGS[pkg]
    io = jfluid.io if pkg == "jax" else tio
    main, startup, loss = _fc_train(fluid, core, un)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=FEED, fetch_list=[loss])

        def save():
            ck = io.AsyncCheckpointer()
            ck.save(exe, str(tmp_path / pkg), io.TrainStatus(epoch_no=1),
                    main, scope=scope)
            ck.wait()
        return _traced(tr, save)


def _served_batch(pkg, model_dir):
    if pkg == "jax":
        from paddle_tpu.inference import (AnalysisConfig,
                                          create_paddle_predictor)
        from paddle_tpu.serving import ServingConfig, ServingEngine
        tr = jtracing
    else:
        from paddle_tpu_torch.inference import (AnalysisConfig,
                                                create_paddle_predictor)
        from paddle_tpu_torch.serving import ServingConfig, ServingEngine
        tr = tracing
    config = AnalysisConfig(model_dir)
    config.disable_gpu()
    engine = ServingEngine(create_paddle_predictor(config),
                           ServingConfig(max_batch_size=2, max_wait_ms=1.0))
    rng = np.random.RandomState(0)

    def serve():
        for _ in range(2):
            engine.submit({"x": rng.randn(1, 6).astype(np.float32)}) \
                .result(timeout=60)
        engine.drain(timeout=60)
    try:
        names = _traced(tr, serve)
        by_sid = {}
        for n, *_x, a in tr.get_events():
            if n in ("serving::pad", "serving::run", "serving::split"):
                by_sid.setdefault(a["step_id"], set()).add(n)
        stats = engine.stats()
        if pkg == "port":
            assert profiler.serving_stats()[-1] == stats
    finally:
        engine.shutdown()
    full = [s for s, ns in by_sid.items() if len(ns) == 3]
    assert len(full) == 2, by_sid          # each batch's spans share its id
    return names


@pytest.fixture(scope="module")
def served_model(tmp_path_factory):
    jun.reset()
    main, startup = jcore.Program(), jcore.Program()
    with jcore.program_guard(main, startup):
        x = jfluid.layers.data("x", shape=[6])
        y = jfluid.layers.fc(x, 3)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        d = str(tmp_path_factory.mktemp("served") / "m")
        jfluid.io.save_inference_model(d, ["x"], [y], exe, main)
    return d


@pytest.mark.parametrize("unit", ["prepared", "executor_run", "served",
                                  "checkpoint"])
def test_span_names_are_the_jax_packages(unit, tmp_path, request):
    def names(pkg):
        if unit == "prepared":
            return _prepared_step(pkg)
        if unit == "executor_run":
            return _executor_run(pkg)
        if unit == "checkpoint":
            return _checkpoint(pkg, tmp_path)
        return _served_batch(pkg, request.getfixturevalue("served_model"))
    want, got = names("jax") - JAX_ONLY_SPANS, names("port")
    assert got == want
    assert got


def test_step_ids_monotone_and_thread_pinned():
    assert tracing.next_step_id() < tracing.next_step_id()
    base = tracing.current_step_id()
    with tracing.step_scope(7):
        assert tracing.current_step_id() == 7
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            tracing.current_step_id()))
        t.start()
        t.join()
        assert seen == [base]
    assert tracing.current_step_id() == base


def test_prepared_spans_correlate_on_the_step_axis():
    main, startup, loss = _fc_train(tfluid, tcore, tun)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    prepared = exe.prepare(main, fetch_list=[loss], scope=scope)
    prepared.run(FEED)[0].numpy()
    tracing.enable()
    try:
        sids = []
        for _ in range(3):
            prepared.run(FEED)[0].numpy()
            sids.append(tracing.current_step_id())
    finally:
        tracing.disable()
    events = tracing.get_events()
    assert [a["step_id"] for n, s, e, t, a in events
            if n == "prepared::dispatch"] == sids
    assert len(set(sids)) == 3 and all("step_id" in e[4] for e in events)


# ---------------------------------------------------------------------------
# the telemetry recorder
# ---------------------------------------------------------------------------


def test_recorder_jsonl_passes_both_validators(tmp_path):
    main, startup, loss = _fc_train(tfluid, tcore, tun)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    prepared = exe.prepare(main, fetch_list=[loss], scope=scope,
                           donate_state=True)
    path = str(tmp_path / "t.jsonl")
    with TelemetryRecorder(path, program=main, feed_shapes=FEED,
                           fetch_names=[loss.name], tokens_per_step=2) as rec:
        rec.attach(prepared)
        recs = []
        for _ in range(3):
            with rec.step() as st:
                st.loss = prepared.run(FEED)[0]
            recs.append(st.record)
    mine, theirs = validate_jsonl(path), jrecorder.validate_jsonl(path)
    assert mine["steps"] == theirs["steps"] == 3
    header = mine["header"]
    assert header["peak_dtype"] == "float32"
    assert header["static"]["flops_per_step"] == 3 * 2 * 2 * (6 * 8 + 8 * 3)
    assert recs[0]["compiles"] == 1 and recs[1]["compiles"] == 0
    assert recs[0]["stalls_ms"]["compile"] > 0
    assert all(0 < r["mfu"] <= 1 and r["loss_finite"] for r in recs)
    assert "hbm_headroom_bytes" not in recs[0]         # the CPU: None


def test_recorder_mfu_exact_with_overrides(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with TelemetryRecorder(path, flops_per_step=3e11, peak_flops=1e12,
                           tokens_per_step=128) as rec:
        r1 = rec.record_step(wall_ns=1e9, loss=1.25)
        r2 = rec.record_step(wall_ns=5e8)
    assert r1["mfu"] == pytest.approx(0.3)
    assert r2["mfu"] == pytest.approx(0.6)
    facts = jrecorder.validate_jsonl(path)
    assert facts["summary"]["mfu_mean"] == pytest.approx(0.45)


@pytest.mark.parametrize("dtype,tf32,want", [
    ("float32", False, "float32"), ("float32", True, "tf32"),
    ("bfloat16", False, "bfloat16"), ("float16", True, "float16")])
def test_matmul_dtype_picks_the_peak(dtype, tf32, want, monkeypatch):
    tun.reset()
    main, startup = tcore.Program(), tcore.Program()
    with tcore.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4], dtype=dtype)
        tfluid.layers.fc(x, 3)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    assert flops.matmul_dtype(main) == want
    assert flops.device_info(dtype=want)["peak_dtype"] == want


def test_flight_dump_on_nonfinite_loss(tmp_path):
    main, startup, loss = _nan_program(tfluid, tcore, tun)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    prepared = exe.prepare(main, fetch_list=[loss], scope=scope)
    path = str(tmp_path / "t.jsonl")
    with TelemetryRecorder(path, program=main, fetch_names=[loss.name]) \
            as rec:
        x = np.ones((2, 2), np.float32)
        with rec.step() as st:
            st.loss = prepared.run({"x": x, "d": x})[0]
        with rec.step() as st:
            st.loss = prepared.run({"x": x, "d": np.zeros_like(x)})[0]
        bad = st.record
    assert bad["loss_finite"] is False
    bundle = flight.validate_bundle(bad["flight_bundle"])
    assert bundle["reason"] == "non_finite_loss"
    assert bundle["extra"]["step"] == bad["step"]
    assert any(s[1] == "prepared" for s in bundle["steps"])
    events = [r for r in map(json.loads, open(path))
              if r.get("record") == "event"]
    assert events[0]["flight_bundle"] == bad["flight_bundle"]
    jrecorder.validate_jsonl(path)


def test_flight_dump_on_raising_op(monkeypatch):
    from paddle_tpu_torch.framework import executor
    main, startup, loss = _fc_train(tfluid, tcore, tun)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    prepared = exe.prepare(main, fetch_list=[loss], scope=scope)
    prepared.run(FEED)

    def boom(*a, **k):
        raise ValueError("injected device failure")

    monkeypatch.setattr(executor, "run_block", boom)
    with pytest.raises(ValueError, match="injected device failure"):
        prepared.run(FEED)
    bundle = flight.validate_bundle(flight.last_dumps()[-1])
    assert bundle["reason"] == "prepared_step_exception"
    assert bundle["exception"]["type"] == "ValueError"
    assert bundle["program"]["uid"] == main._uid
    assert bundle["extra"]["fetches"] == [loss.name]


def test_flight_disabled_is_silent():
    tflags.set_flags({"flight_recorder": False})
    flight.note_step(1, "prepared", None)
    assert flight.dump("test_reason") is None
    assert flight.steps_snapshot() == []


# ---------------------------------------------------------------------------
# metrics and monitor
# ---------------------------------------------------------------------------


def _registry_calls(mon, met):
    mon.stat("obs_prom_counter").add(4)
    met.gauge("obs_prom_gauge", model="bert", bucket="8x32").set(1.5)
    met.gauge("obs_prom_gauge", model="moe", bucket="8x32").set(2)
    met.counter("watchdog::trip", beacon="prepared").add()
    h = met.histogram("obs_prom_hist", buckets=(0.5, 2.0))
    h.observe(0.3)
    h.observe(1.0)
    met.histogram("telemetry_step_wall_seconds", run="r").observe(0.07)


def test_prometheus_text_is_the_jax_packages_byte_for_byte(monkeypatch):
    for mon, met in ((jmonitor, jmetrics), (monitor, metrics)):
        monkeypatch.setattr(mon, "_stats", {})
        met.reset_metrics()
        _registry_calls(mon, met)
    text = metrics.prometheus_text()
    assert text == jmetrics.prometheus_text()
    assert 'paddle_tpu_obs_prom_hist_bucket{le="+Inf"} 2' in text
    snap = metrics.metrics_snapshot()
    want = jmetrics.metrics_snapshot()
    for k in ("schema", "counters", "metrics"):
        assert snap[k] == want[k], k


def test_metrics_http_endpoint_on_loopback():
    metrics.counter("obs_http_hits").add(9)
    with metrics.serve_metrics(port=0) as srv:
        assert srv.addr == "127.0.0.1"
        text = urllib.request.urlopen(srv.url).read().decode()
        assert "paddle_tpu_obs_http_hits 9" in text
        js = json.loads(urllib.request.urlopen(
            srv.url + ".json").read().decode())
        assert js["schema"] == "paddle_tpu.metrics/1"


def test_monitor_concurrent_adds_and_reset():
    s = monitor.stat("obs_test_threads")
    s.reset()
    threads = [threading.Thread(target=lambda: [s.add(1)
                                                for _ in range(500)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert s.get() == 2000
    snap = monitor.stats_snapshot()
    snap["obs_test_threads"] = 0
    assert s.get() == 2000
    monitor.reset_all()
    assert s.get() == 0


# ---------------------------------------------------------------------------
# check_nan_inf
# ---------------------------------------------------------------------------


def _nan_program(fluid, core, un):
    """x / d - x / d: Inf at the division where d is 0, NaN after."""
    un.reset()
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[2])
        d = fluid.layers.data("d", shape=[2])
        y = fluid.layers.elementwise_div(x, d)
        out = fluid.layers.mean(fluid.layers.elementwise_sub(y, y))
    return main, startup, out


@pytest.mark.parametrize("per_op", [False, True], ids=["var", "op"])
def test_check_nan_inf_names_what_the_jax_package_names(per_op):
    msgs = []
    for fluid, core, un, fl in ((jfluid, jcore, jun, jflags),
                                (tfluid, tcore, tun, tflags)):
        main, startup, out = _nan_program(fluid, core, un)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        fl.set_flags({"FLAGS_check_nan_inf": True,
                      "FLAGS_check_nan_inf_per_op": per_op})
        try:
            with fluid.scope_guard(scope):
                exe.run(startup)
                x = np.ones((2, 2), np.float32)
                with pytest.raises(RuntimeError, match="NaN/Inf") as e:
                    exe.run(main, feed={"x": x, "d": np.zeros_like(x)},
                            fetch_list=[out])
                r, = exe.run(main, feed={"x": x, "d": x},
                             fetch_list=[out])
                assert float(r) == 0.0
        finally:
            fl.set_flags({"FLAGS_check_nan_inf": False,
                          "FLAGS_check_nan_inf_per_op": False})
        msgs.append(str(e.value).split(" (ref:")[0])
    assert msgs[0] == msgs[1]
    assert ("'elementwise_div'" in msgs[1]) == per_op


# ---------------------------------------------------------------------------
# collective spans, the profiler, the timeline
# ---------------------------------------------------------------------------


def test_collective_span_attrs_are_the_jax_packages():
    from paddle_tpu.ops.collective_ops import maybe_trace_collective
    from paddle_tpu_torch.ops.collective_ops import trace_collective

    class _Op:
        type = "c_fused_allreduce_sum"
        attrs = {"_axis_name": "dp", "_bucket_index": 3, "_ready_rank": 1,
                 "_overlap": True}

    class _Ctx:
        mesh = None

    xs = [np.zeros((4, 8), np.float32), np.zeros((8,), np.float32)]
    spans = []
    for tr, open_span in (
            (jtracing, lambda: maybe_trace_collective(
                _Op, {"X": xs}, _Ctx)),
            (tracing, lambda: trace_collective(
                _Op.type, _Op.attrs,
                {"X": [torch.from_numpy(a) for a in xs]}, None))):
        tr.enable()
        try:
            with open_span():
                pass
        finally:
            tr.disable()
        (name, *_x, attrs), = tr.get_events()
        attrs.pop("step_id")
        spans.append((name, attrs))
    assert spans[0] == spans[1]
    assert spans[1][1]["bucket_index"] == 3 and spans[1][1]["ready_rank"] == 1


def test_stop_profiler_restores_state_when_the_stop_raises(tmp_path,
                                                           monkeypatch):
    calls = []

    class _Prof:
        def __init__(self, **kw):
            calls.append("start")

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            calls.append("stop")
            raise RuntimeError("backend died mid-trace")

    monkeypatch.setattr(torch.profiler, "profile", _Prof)
    profiler.start_profiler("All", trace_dir=str(tmp_path))
    assert profiler._device_trace_dir == str(tmp_path)
    profiler.stop_profiler()
    assert calls == ["start", "stop"]
    assert profiler._device_trace_dir is None
    assert not profiler.is_profiler_enabled()
    profiler.stop_profiler()
    assert calls.count("stop") == 1
    with pytest.raises(ValueError, match="tracer_option"):
        profiler.start_profiler("CPU", tracer_option="Bogus")


def test_chrome_trace_and_timeline_merge(tmp_path):
    tracing.enable()
    try:
        with tracing.Span("op::custom", cache="hit", step_id=41):
            pass
    finally:
        tracing.disable()
    path = str(tmp_path / "trace.json")
    profiler.save_chrome_trace(path)
    trace = json.load(open(path))
    ev, = [e for e in trace["traceEvents"] if e["name"] == "op::custom"]
    assert ev["args"] == {"cache": "hit", "step_id": 41}
    assert any(e.get("ph") == "M" and e["tid"] == ev["tid"]
               for e in trace["traceEvents"])
    from tools.timeline import merge
    for perfetto in (False, True):
        want = merge([f"a:{path}", f"b:{path}"],
                     str(tmp_path / f"j{perfetto}.json"), perfetto)
        got = profiler.merge_timelines([f"a:{path}", f"b:{path}"],
                                       str(tmp_path / f"t{perfetto}.json"),
                                       perfetto)
        assert got[0] == want[0] and got[1].endswith(
            ".gz" if perfetto else ".json")
    breakdown = profiler.step_breakdown([("prepared::dispatch", 0, 2000,
                                          1, {})])
    assert breakdown["prepared::dispatch"] == {"calls": 1,
                                               "total_ms": 0.002,
                                               "avg_us": 2.0}


OBS_MODULES = ["paddle_tpu_torch.testing.faultline",
               "paddle_tpu_torch.profiler", "paddle_tpu_torch.monitor",
               "paddle_tpu_torch.observability",
               "paddle_tpu_torch.framework.guardrails"]


@pytest.fixture(scope="module")
def imported_alone():
    """The modules of this layer imported in a fresh process (one for all
    of them): the JAX modules it pulled in."""
    code = ("import sys, " + ", ".join(OBS_MODULES) + ";"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


@pytest.mark.parametrize("module", OBS_MODULES)
def test_the_observability_modules_import_no_jax(module, imported_alone):
    assert imported_alone == "[]"
    path = os.path.join(REPO, *module.split("."))
    assert os.path.exists(path + ".py") or \
        os.path.exists(os.path.join(path, "__init__.py"))
