"""Versioned Program serialization — the port of
paddle_tpu/framework/serialization.py, on the same schema.

A program crosses between the JAX package and this port as its *desc*: a
JSON-able dict with ``format_version`` 1 holding only primitive data
(names, shapes, dtypes, attr values; blocks by index, ndarrays base64).
Both packages emit the same desc for the same program, byte for byte once
dumped with ``json.dumps``, and each reads the other's.  The program's
``mesh_layout`` is a :class:`~.mesh_layout.MeshLayout` both ways; a
variable's ``dist_attr`` is a :class:`~.mesh_layout.ShardSpec`.  A
regularizer this port does not have is kept verbatim and written back
unchanged."""

from __future__ import annotations

import base64
from typing import Any, Dict

import numpy as np

from .core import Block, Operator, Parameter, Program, Variable
from . import initializer as init_mod

FORMAT_VERSION = 1

# initializers serialize by class name + __dict__ (all-primitive by
# construction); unknown classes degrade to None (params already trained)
_INITIALIZERS = {
    c.__name__: c for c in (
        init_mod.ConstantInitializer, init_mod.UniformInitializer,
        init_mod.NormalInitializer, init_mod.TruncatedNormalInitializer,
        init_mod.XavierInitializer, init_mod.MSRAInitializer,
        init_mod.NumpyArrayInitializer)
}


class RegularizerDesc:
    """A parameter regularizer read from a desc: the port applies none yet,
    so it keeps the class name and state to write them back unchanged."""

    def __init__(self, class_name: str, state: Dict[str, Any]):
        self.class_name = class_name
        self.state = state


def _enc_ndarray(a: np.ndarray) -> Dict[str, Any]:
    return {"__kind__": "ndarray", "dtype": str(a.dtype),
            "shape": list(a.shape),
            "data": base64.b64encode(np.ascontiguousarray(a).tobytes())
            .decode("ascii")}


def _dec_ndarray(d) -> np.ndarray:
    raw = base64.b64decode(d["data"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]).copy()


def _enc_attr(v):
    if isinstance(v, Block):
        return {"__kind__": "block", "idx": v.idx}
    if isinstance(v, np.ndarray):
        return _enc_ndarray(v)
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, tuple):
        return {"__kind__": "tuple", "items": [_enc_attr(x) for x in v]}
    if isinstance(v, list):
        return [_enc_attr(x) for x in v]
    if isinstance(v, dict):
        return {"__kind__": "dict",
                "items": {k: _enc_attr(x) for k, x in v.items()}}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    # tensors captured as constants serialize as ndarray
    if hasattr(v, "__array__"):
        return _enc_ndarray(np.asarray(v))
    raise TypeError(
        f"attr value {v!r} ({type(v).__name__}) is not serializable — "
        f"extend serialization.py in both packages")


def _dec_attr(v, program: Program):
    if isinstance(v, dict):
        kind = v.get("__kind__")
        if kind == "block":
            return program.blocks[v["idx"]]
        if kind == "ndarray":
            return _dec_ndarray(v)
        if kind == "tuple":
            return tuple(_dec_attr(x, program) for x in v["items"])
        if kind == "dict":
            return {k: _dec_attr(x, program) for k, x in v["items"].items()}
        raise ValueError(f"unknown attr kind {kind!r}")
    if isinstance(v, list):
        return [_dec_attr(x, program) for x in v]
    return v


def _enc_initializer(init):
    if init is None:
        return None
    cls = type(init).__name__
    if cls not in _INITIALIZERS:
        return None
    state = {k: _enc_attr(v) for k, v in init.__dict__.items()}
    return {"class": cls, "state": state}


def _dec_initializer(d, program):
    if d is None or d.get("class") not in _INITIALIZERS:
        return None
    obj = _INITIALIZERS[d["class"]].__new__(_INITIALIZERS[d["class"]])
    obj.__dict__.update(
        {k: _dec_attr(v, program) for k, v in d["state"].items()})
    return obj


def _enc_var(v: Variable) -> Dict[str, Any]:
    d = {
        "name": v.name, "shape": list(v.shape), "dtype": v.dtype,
        "persistable": v.persistable, "stop_gradient": v.stop_gradient,
        "trainable": v.trainable, "is_data": v.is_data,
        "initializer": _enc_initializer(v.initializer),
        "is_parameter": isinstance(v, Parameter),
    }
    if v.dist_attr is not None:
        d["dist_attr"] = _enc_attr(tuple(v.dist_attr))
    if isinstance(v, Parameter):
        d["need_clip"] = v.need_clip
        d["is_distributed"] = v.is_distributed
        d["optimize_attrs"] = {k: _enc_attr(x)
                               for k, x in v.optimize_attrs.items()}
        reg = v.regularizer
        if isinstance(reg, RegularizerDesc):
            d["regularizer"] = {"class": reg.class_name, "state": reg.state}
        elif reg is not None:
            d["regularizer"] = {"class": type(reg).__name__,
                                "state": {k: _enc_attr(x) for k, x
                                          in reg.__dict__.items()}}
    return d


def _dec_var(block: Block, d, program: Program) -> Variable:
    init = _dec_initializer(d.get("initializer"), program)
    if d.get("is_parameter"):
        v = Parameter(block, d["name"], d["shape"], d["dtype"],
                      initializer=init, need_clip=d.get("need_clip", True),
                      trainable=d.get("trainable", True),
                      is_distributed=d.get("is_distributed", False))
        v.optimize_attrs.update(
            {k: _dec_attr(x, program)
             for k, x in d.get("optimize_attrs", {}).items()})
        reg = d.get("regularizer")
        if reg is not None:
            v.regularizer = RegularizerDesc(reg["class"], reg["state"])
    else:
        v = Variable(block, d["name"], d["shape"], d["dtype"],
                     persistable=d.get("persistable", False),
                     stop_gradient=d.get("stop_gradient", True),
                     trainable=d.get("trainable", False),
                     is_data=d.get("is_data", False), initializer=init)
    if "dist_attr" in d:
        v.dist_attr = _dec_attr(d["dist_attr"], program)
    block.vars[v.name] = v
    return v


def program_to_desc(program: Program) -> Dict[str, Any]:
    """Program → versioned primitive-only desc dict (the ProgramDesc
    analog)."""
    layout = program._mesh_layout
    return {
        "format_version": FORMAT_VERSION,
        "random_seed": program.random_seed,
        "is_test": program._is_test,
        "mesh_layout": layout.to_desc() if layout is not None else None,
        "blocks": [{
            "idx": b.idx,
            "parent_idx": b.parent_idx,
            "vars": [_enc_var(v) for v in b.vars.values()],
            "ops": [{
                "type": op.type,
                "inputs": {k: list(v) for k, v in op.inputs.items()},
                "outputs": {k: list(v) for k, v in op.outputs.items()},
                "attrs": {k: _enc_attr(v) for k, v in op.attrs.items()},
            } for op in b.ops],
        } for b in program.blocks],
    }


def desc_to_program(desc: Dict[str, Any]) -> Program:
    """Desc dict → fresh Program, field by field."""
    version = desc.get("format_version")
    if version is None or version > FORMAT_VERSION:
        raise ValueError(
            f"program desc format_version {version!r} is newer than this "
            f"framework supports ({FORMAT_VERSION})")
    program = Program()
    program.random_seed = desc.get("random_seed", 0)
    program._is_test = desc.get("is_test", False)
    if desc.get("mesh_layout") is not None:
        from .mesh_layout import MeshLayout
        program._mesh_layout = MeshLayout.from_desc(desc["mesh_layout"])
    # materialise all blocks first so block-index attrs can resolve
    for bd in desc["blocks"][1:]:
        program.blocks.append(Block(program, bd["idx"],
                                    bd.get("parent_idx", -1)))
    for bd in desc["blocks"]:
        block = program.blocks[bd["idx"]]
        for vd in bd["vars"]:
            _dec_var(block, vd, program)
    for bd in desc["blocks"]:
        block = program.blocks[bd["idx"]]
        for od in bd["ops"]:
            op = Operator.__new__(Operator)
            op.block = block
            op.type = od["type"]
            op.inputs = {k: list(v) for k, v in od["inputs"].items()}
            op.outputs = {k: list(v) for k, v in od["outputs"].items()}
            op.attrs = {k: _dec_attr(v, program)
                        for k, v in od["attrs"].items()}
            op.callstack = []
            block.ops.append(op)
    program._bump_version()
    return program
