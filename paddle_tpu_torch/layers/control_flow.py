"""Graph-building control flow — the port of paddle_tpu/layers/
control_flow.py (``cond`` and ``case``; ref: python/paddle/fluid/layers/
control_flow.py cond, conditional_block:63, case:2789).

``cond`` opens a sub-block per branch in the current Program, runs the
user's Python closure once to record its ops there, computes the outer
variables the branches read (the closure, replacing the reference's
runtime scope-chain lookup) and appends one ``conditional_block`` op that
lists them as inputs.  Names, blocks and attrs are the JAX package's, so
a program with branches crosses between the packages as its desc.  The
op runs the taken branch only (``ops/controlflow_ops.py``).

``while_loop``, ``switch_case`` and ``StaticRNN`` are not ported."""

from __future__ import annotations

from typing import Callable, List, Optional

from ..framework import unique_name
from ..framework.core import Variable, default_main_program


def _flatten_vars(out):
    if out is None:
        return []
    if isinstance(out, Variable):
        return [out]
    if isinstance(out, (list, tuple)):
        res = []
        for o in out:
            res.extend(_flatten_vars(o))
        return res
    raise TypeError(f"branch functions must return Variables, got {type(out)}")


def _closure_names(blocks, bound_names) -> List[str]:
    """Outer var names read by the given blocks, in first-read order.

    Nested control-flow ops already list their own closures as explicit
    inputs, so a linear scan per block suffices (no recursion)."""
    bound = set(bound_names)
    needed: List[str] = []
    for block in blocks:
        local = set(bound)
        for op in block.ops:
            if op.type in ("feed", "fetch"):
                continue
            for n in op.input_names():
                if n not in local and n not in needed:
                    needed.append(n)
            local |= set(op.output_names())
    return needed


def cond(pred: Variable, true_fn: Optional[Callable] = None,
         false_fn: Optional[Callable] = None, name: Optional[str] = None):
    """``true_fn()`` where ``pred`` holds, else ``false_fn()``.  Both
    branches must return matching structures of variables."""
    main = default_main_program()
    parent = main.current_block()

    true_block = main._create_block()
    t_out = true_fn() if true_fn is not None else None
    t_vars = _flatten_vars(t_out)
    main._rollback()

    false_block = main._create_block()
    f_out = false_fn() if false_fn is not None else None
    f_vars = _flatten_vars(f_out)
    main._rollback()

    if len(t_vars) != len(f_vars):
        raise ValueError(
            "true_fn and false_fn must return the same number of outputs "
            f"({len(t_vars)} vs {len(f_vars)})")
    if not t_vars:
        raise ValueError("cond with no outputs computes nothing; return "
                         "the values the branches compute")

    closure = _closure_names([true_block, false_block], [])
    outs = [parent.create_var(
        name=unique_name.generate(name or "cond"),
        shape=v.shape, dtype=v.dtype) for v in t_vars]
    parent.append_op(
        type="conditional_block",
        inputs={"Cond": [pred], "Closure": closure},
        outputs={"Out": outs},
        attrs={"closure_names": closure,
               "true_block": true_block, "false_block": false_block,
               "true_out_names": [v.name for v in t_vars],
               "false_out_names": [v.name for v in f_vars]})
    if isinstance(t_out, Variable):
        return outs[0]
    return outs


def case(pred_fn_pairs, default: Optional[Callable] = None,
         name: Optional[str] = None):
    """The function of the first pair whose predicate holds, else
    ``default`` (the last pair's function when None): chained conds."""
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs must be non-empty")
    (pred, fn), rest = pred_fn_pairs[0], pred_fn_pairs[1:]
    if rest:
        return cond(pred, fn, lambda: case(rest, default), name=name)
    if default is None:
        _, default = pred_fn_pairs[-1]
    return cond(pred, fn, default, name=name)
