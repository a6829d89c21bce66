"""AMP program rewrite (ref: contrib/mixed_precision/fp16_utils.py
rewrite_program) — the port of the JAX package's rewrite, line for line
against the port's IR, so both packages give the same program: the same
cast ops (names, inputs, ``out_dtype``) at the same places and the same
var dtypes.

It walks the forward ops inserting cast ops so that white-list ops
compute in bf16/fp16 while black-list ops stay float32.  Master weights
stay float32 in the scope; the casts are part of the forward the
executor differentiates, so parameter gradients come back float32."""

from __future__ import annotations

from ...framework import unique_name
from ...framework.core import Program
from .fp16_lists import AutoMixedPrecisionLists

_FLOAT = {"float32", "float64"}


def _insert_cast(block, idx, name, cur_dtype, target_dtype, cache):
    key = (name, target_dtype)
    if key in cache:
        return cache[key], idx
    out_name = unique_name.generate(f"{name}.cast_{target_dtype}")
    var = block._find_var_recursive(name)
    block.create_var(name=out_name, shape=var.shape if var else (),
                     dtype=target_dtype, stop_gradient=True)
    block._insert_op(idx, type="cast", inputs={"X": [name]},
                     outputs={"Out": [out_name]},
                     attrs={"out_dtype": target_dtype})
    cache[key] = out_name
    return out_name, idx + 1


def rewrite_program(program: Program, amp_lists: AutoMixedPrecisionLists,
                    dest_dtype: str = "bfloat16"):
    """Rewrite the forward block in place (call BEFORE append_backward)."""
    block = program.global_block()
    var_dtype = {}      # name -> current compute dtype ("float32"/dest)
    cast_cache = {}

    def cur(name):
        if name in var_dtype:
            return var_dtype[name]
        v = block._find_var_recursive(name)
        return v.dtype if v is not None else "float32"

    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        t = op.type
        if t == "backward":
            break
        is_white = t in amp_lists.white_list
        is_black = t in amp_lists.black_list
        if any(n in amp_lists.black_varnames for ns in op.inputs.values()
               for n in ns):
            is_white, is_black = False, True

        if is_white:
            target = dest_dtype
        elif is_black:
            target = "float32"
        elif t in amp_lists.gray_list:
            float_ins = [n for ns in op.inputs.values() for n in ns
                         if cur(n) in _FLOAT or cur(n) == dest_dtype]
            target = dest_dtype if float_ins and all(
                cur(n) == dest_dtype for n in float_ins) else None
            if target is None:
                # mixed or fp32 inputs: normalise everything to fp32
                target = "float32"
        else:
            # unknown op: play safe, fp32
            target = "float32"

        for slot, names in list(op.inputs.items()):
            new_names = []
            for n in names:
                c = cur(n)
                if c in _FLOAT and target == dest_dtype:
                    n, i = _insert_cast(block, i, n, c, dest_dtype,
                                        cast_cache)
                elif c == dest_dtype and target == "float32":
                    n, i = _insert_cast(block, i, n, c, "float32",
                                        cast_cache)
                new_names.append(n)
            op.inputs[slot] = new_names

        out_dtype = dest_dtype if target == dest_dtype else "float32"
        for ns in op.outputs.values():
            for n in ns:
                v = block._find_var_recursive(n)
                if v is not None and v.dtype in _FLOAT | {dest_dtype}:
                    var_dtype[n] = out_dtype
                    if not v.persistable:   # master weights stay fp32
                        v.dtype = out_dtype
        i += 1
    program._bump_version()
    return program


def cast_parameters_to_bf16(program: Program, scope):
    """Pure-bf16 helper: cast the stored parameters themselves to
    bfloat16 (for a caller that opts out of float32 master weights).  On
    the card the Adam kernel (#10) takes float32 parameters only, so a
    program updated by ``adam`` / ``adamw`` then raises there with the
    kernel gate's reason."""
    import numpy as np
    import torch
    for p in program.all_parameters():
        val = scope.find_var(p.name)
        if val is not None:
            t = val if isinstance(val, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(np.asarray(val)))
            if t.dtype in (torch.float32, torch.float64):
                scope.set_var(p.name, t.to(torch.bfloat16))
        p.dtype = "bfloat16"
