"""Control flow in the PyTorch port against the JAX package, on the CPU:
``Program._create_block`` / ``_rollback``, ``layers.cond`` / ``case``,
the ``conditional_block`` op, and the modulo, comparison and logical ops
their predicates are built from.

The cases of the JAX package's ``tests/test_control_flow.py`` that do not
need ``while_loop``, ``switch_case`` or ``StaticRNN`` (not ported) run in
both packages: the branches' values, the gradient through the taken
branch, ``case``; each program is the JAX package's desc for desc, and a
desc with sub-blocks round-trips and runs in the other package.  The
closure of a branch is exactly the JAX package's, and a prepared step
counts one host read of the predicate per ``conditional_block`` run.
The ops are held to the JAX ops element for element, dtype for dtype
(float results within 1e-6; bools, ints and counters exactly)."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.serialization import (desc_to_program as jfrom,
                                                program_to_desc as jdesc)
from paddle_tpu.layers.control_flow import _closure_names as jclosure
from paddle_tpu.ops import registry as jregistry

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.serialization import (desc_to_program as
                                                      tfrom,
                                                      program_to_desc as
                                                      tdesc)
from paddle_tpu_torch.layers.control_flow import _closure_names as tclosure
from paddle_tpu_torch.ops import registry as tregistry

PACKAGES = {"jax": (jfluid, jcore, jun), "port": (tfluid, tcore, tun)}
TOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_state():
    yield
    tcore.reset_default_programs()


def _desc(pkg, program):
    return json.dumps((jdesc if pkg == "jax" else tdesc)(program),
                      sort_keys=True)


def _both(build):
    """``build(fluid)`` in a fresh program of each package: (main, startup,
    outputs) per package."""
    out = {}
    for pkg, (fluid, core, un) in PACKAGES.items():
        un.reset()
        main, startup = core.Program(), core.Program()
        startup.random_seed = 5
        with core.program_guard(main, startup):
            outs = build(fluid)
        out[pkg] = (main, startup, outs)
    return out


def _run(pkg, main, startup, feed, fetch, scope=None):
    fluid = PACKAGES[pkg][0]
    scope = scope or fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        return [np.asarray(v) for v in
                exe.run(main, feed=feed, fetch_list=fetch)], scope


def test_create_block_and_rollback():
    p = tcore.Program()
    b1 = p._create_block()
    assert (b1.idx, b1.parent_idx, p.current_block() is b1) == (1, 0, True)
    b2 = p._create_block()
    assert (b2.idx, b2.parent_idx) == (2, 1)
    p._rollback()
    assert p.current_block() is b1
    p._rollback()
    assert p.current_block() is p.global_block()
    b3 = p._create_block(parent_idx=0)
    assert b3.parent_idx == 0 and b3._find_var_recursive("nothing") is None


def _branches(fluid):
    layers = fluid.layers
    a = layers.fill_constant(shape=[2], dtype="float32", value=3.0)
    b = layers.fill_constant(shape=[2], dtype="float32", value=5.0)
    pred = layers.less_than(layers.reduce_sum(a), layers.reduce_sum(b))
    out = layers.cond(pred, lambda: a + b, lambda: a - b)
    out2 = layers.cond(layers.logical_not(pred),
                       lambda: a + b, lambda: a * b)
    return [out, out2]


def test_cond_branches():
    built = _both(_branches)
    assert _desc("port", built["port"][0]) == _desc("jax", built["jax"][0])
    vals = {pkg: _run(pkg, m, s, {}, outs)[0]
            for pkg, (m, s, outs) in built.items()}
    for pkg in PACKAGES:
        np.testing.assert_allclose(vals[pkg][0], [8.0, 8.0])
        np.testing.assert_allclose(vals[pkg][1], [15.0, 15.0])


def _taken_branch_grad(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[1])
    w = layers.fc(x, 1, bias_attr=False,
                  param_attr=fluid.ParamAttr(
                      name="w_cond",
                      initializer=fluid.initializer.Constant(1.0)))
    pred = layers.less_than(layers.reduce_sum(w),
                            layers.fill_constant([1], "float32", 100.0))
    out = layers.cond(pred, lambda: w * 3.0, lambda: w * 5.0)
    loss = layers.mean(out)
    fluid.optimizer.SGD(0.1).minimize(loss)
    return [loss]


def test_cond_gradient_flows_through_taken_branch():
    built = _both(_taken_branch_grad)
    assert _desc("port", built["port"][0]) == _desc("jax", built["jax"][0])
    x = np.ones((1, 1), np.float32)
    for pkg, (main, startup, outs) in built.items():
        _, scope = _run(pkg, main, startup, {"x": x}, outs)
        w = np.asarray(scope.find_var("w_cond"))
        # the taken branch's gradient 3, times the LR 0.1
        assert np.isclose(float(w.reshape(())), 0.7, atol=1e-5), pkg


def _case(fluid):
    layers = fluid.layers
    one = layers.fill_constant([1], "float32", 1.0)
    two = layers.fill_constant([1], "float32", 2.0)
    p_false = layers.less_than(two, one)
    p_true = layers.less_than(one, two)
    c = layers.case([(p_false, lambda: one + 10.0),
                     (p_true, lambda: two + 20.0)],
                    default=lambda: one * 0.0)
    d = layers.case([(p_false, lambda: one + 10.0),
                     (p_false, lambda: two + 20.0)],
                    default=lambda: one * 7.0)
    e = layers.case([(p_false, lambda: one + 10.0),
                     (p_false, lambda: two + 30.0)])
    return [c, d, e]


def test_case_takes_the_first_true_pair_or_the_default():
    built = _both(_case)
    assert _desc("port", built["port"][0]) == _desc("jax", built["jax"][0])
    for pkg, (main, startup, outs) in built.items():
        c, d, e = _run(pkg, main, startup, {}, outs)[0]
        # no default: the last pair's function runs when none holds
        assert [float(v.reshape(())) for v in (c, d, e)] == \
            [22.0, 7.0, 32.0], pkg


def _nested(fluid):
    layers = fluid.layers
    x = layers.data("x", shape=[3])
    s = layers.reduce_sum(x)
    zero = layers.fill_constant([1], "float32", 0.0)
    ten = layers.fill_constant([1], "float32", 10.0)

    def positive():
        return layers.cond(layers.greater_than(s, ten),
                           lambda: x * 100.0, lambda: x * 10.0)

    out = layers.cond(layers.greater_equal(s, zero), positive,
                      lambda: layers.scale(x, scale=-1.0))
    return [out]


@pytest.mark.parametrize("row,factor", [((1.0, 2.0, 3.0), 10.0),
                                        ((4.0, 5.0, 6.0), 100.0),
                                        ((-1.0, -2.0, 0.5), -1.0)])
def test_nested_cond_closures_and_values(row, factor):
    built = _both(_nested)
    jmain, tmain = built["jax"][0], built["port"][0]
    assert _desc("port", tmain) == _desc("jax", jmain)
    # every branch block's closure is the JAX package's, in its order
    for jb, tb in zip(jmain.blocks[1:], tmain.blocks[1:]):
        assert tclosure([tb], []) == jclosure([jb], [])
    feed = {"x": np.asarray([row], np.float32)}
    for pkg, (main, startup, outs) in built.items():
        got, = _run(pkg, main, startup, feed, outs)[0]
        np.testing.assert_allclose(got, feed["x"] * factor, rtol=TOL,
                                   err_msg=pkg)


@pytest.mark.parametrize("src", ["jax", "port"])
def test_a_program_with_sub_blocks_crosses_as_its_desc(src):
    built = _both(_nested)
    main = built[src][0]
    desc = (jdesc if src == "jax" else tdesc)(main)
    other = "port" if src == "jax" else "jax"
    back = (tfrom if other == "port" else jfrom)(json.loads(json.dumps(desc)))
    assert len(back.blocks) == len(main.blocks) == 5
    cb = [op for op in back.global_block().ops
          if op.type == "conditional_block"][-1]
    # block-valued attrs resolve to the decoded program's own blocks
    assert cb.attrs["true_block"] is back.blocks[cb.attrs["true_block"].idx]
    assert cb.attrs["false_block"].parent_idx == 0
    assert _desc(other, back) == _desc(src, main)
    feed = {"x": np.asarray([[4.0, 5.0, 6.0]], np.float32)}
    out_name = built[src][2][0].name
    got, = _run(other, back, built[other][1], feed, [out_name])[0]
    np.testing.assert_allclose(got, feed["x"] * 100.0, rtol=TOL)


def test_prepared_step_counts_one_predicate_read_per_cond():
    built = _both(_nested)
    main, startup, outs = built["port"]
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    step = exe.prepare(main, fetch_list=outs, scope=scope)
    for row, reads in (((1.0, 2.0, 3.0), 2), ((-1.0, -2.0, 0.5), 1)):
        before = step.stats["predicate_reads"]
        step.run({"x": np.asarray([row], np.float32)})
        # the outer cond, and the inner one only where its branch runs
        assert step.stats["predicate_reads"] - before == reads


def test_the_branch_runs_with_the_runs_generator_and_state_mode():
    """``_sub_ctx``: the branch draws from the run's generator, on its
    device, with its ``donate_state`` and test mode."""
    from paddle_tpu_torch.ops.controlflow_ops import _sub_ctx
    gen = torch.Generator()
    ctx = tregistry.LoweringContext(gen, torch.device("cpu"), is_test=True,
                                    donate_state=True)
    sub = _sub_ctx(ctx)
    assert (sub.generator is gen, sub.device, sub.is_test,
            sub.donate_state, sub.dp) == (True, torch.device("cpu"), True,
                                          True, None)


# ---------------------------------------------------------------------------
# the ops the predicates and step masks are built from
# ---------------------------------------------------------------------------

CMP_OPS = ("equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal")
LOGICAL_OPS = ("logical_and", "logical_or", "logical_xor")
#: operand dtypes: same kind, and int with float (jnp promotes to float)
CMP_DTYPES = [("float32", "float32"), ("int32", "int32"),
              ("int64", "int64"), ("int32", "float32"),
              ("float32", "bool")]


def _operands(dx, dy, shape_y=(3, 4)):
    rng = np.random.RandomState(3)
    a = rng.randint(-3, 4, (3, 4)).astype(dx)
    b = rng.randint(-3, 4, shape_y).astype(dy)
    return a, b


def _both_ops(op, ins, attrs=None):
    import jax.numpy as jnp
    jout = jregistry.get_op(op)(None, {k: [jnp.asarray(v)] for k, v in
                                       ins.items()}, dict(attrs or {}))
    tout = tregistry.get_op(op)(
        tregistry.LoweringContext(), {k: [torch.from_numpy(np.asarray(v))]
                                      for k, v in ins.items()},
        dict(attrs or {}))
    return np.asarray(jout["Out"]), tout["Out"].numpy()


@pytest.mark.parametrize("dtypes", CMP_DTYPES, ids="-".join)
@pytest.mark.parametrize("op", CMP_OPS)
def test_comparisons_match_the_jax_ops(op, dtypes):
    a, b = _operands(*dtypes)
    want, got = _both_ops(op, {"X": a, "Y": b})
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", CMP_OPS)
def test_comparisons_broadcast_as_numpy(op):
    a, b = _operands("float32", "float32", shape_y=(1, 4))
    want, got = _both_ops(op, {"X": a, "Y": b})
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", LOGICAL_OPS + ("logical_not",))
def test_logical_ops_match_the_jax_ops(op):
    a, b = _operands("bool", "bool")
    ins = {"X": a} if op == "logical_not" else {"X": a, "Y": b}
    want, got = _both_ops(op, ins)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "int32", "int64"])
def test_elementwise_mod_is_floored_as_jnp_mod(dtype):
    rng = np.random.RandomState(4)
    a = rng.randint(-20, 21, (5, 6)).astype(dtype)
    b = rng.choice([-7, -3, 2, 5], (5, 6)).astype(dtype)
    if dtype == "float32":
        a = a + np.float32(0.25)
    want, got = _both_ops("elementwise_mod", {"X": a, "Y": b}, {"axis": -1})
    # the operands' dtype (the JAX package narrows int64 to int32 with
    # x64 off; the port keeps int64, ops/registry.py)
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the sign follows the divisor
    assert (np.sign(got[got != 0]) == np.sign(b[got != 0])).all()


@pytest.mark.parametrize("step", [0.0, 1.0, 3.0, 4.0, 7.0, 8.0])
def test_the_step_mask_ops_match_bit_for_bit(step):
    """``_periodic_mask``'s chain: step % k == 0 on float32 counters."""
    s = np.asarray([step], np.float32)
    k = np.asarray([4.0], np.float32)
    jm, tm = _both_ops("elementwise_mod", {"X": s, "Y": k}, {"axis": -1})
    np.testing.assert_array_equal(tm, jm)
    zero = np.zeros(1, np.float32)
    je, te = _both_ops("equal", {"X": tm, "Y": zero})
    np.testing.assert_array_equal(te, je)
    assert bool(te[0]) == (step % 4 == 0)


@pytest.mark.parametrize("attrs", [
    {"dim": [1], "keep_dim": False, "reduce_all": False},
    {"dim": [0, 1], "keep_dim": True, "reduce_all": False},
    {"dim": [-1], "keep_dim": True, "reduce_all": False},
    {"dim": [], "keep_dim": False, "reduce_all": False},
    {"dim": [0], "keep_dim": False, "reduce_all": True}])
def test_reduce_sum_and_square_match_the_jax_ops(attrs):
    a = np.random.RandomState(5).randn(3, 4, 5).astype(np.float32)
    want, got = _both_ops("reduce_sum", {"X": a}, attrs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want, got = _both_ops("square", {"X": a})
    np.testing.assert_allclose(got, want, rtol=TOL)
