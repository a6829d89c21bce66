"""Program IR (ref: PaddlePaddle Fluid framework.proto ProgramDesc and
python/paddle/fluid/framework.py) — the port of paddle_tpu/framework/core.py.

The contract is the JAX package's: a serializable, Python-built static
program of named variables and symbolic ops.  Ops carry no kernels; they
are resolved against the port's op registry (ops/registry.py) when the
executor interprets the program op by op on a ``torch.device``.

Places name devices: ``CUDAPlace(i)`` is the GPU, ``CPUPlace()`` the host.
:func:`device_for` turns a place into a ``torch.device`` and refuses a
CUDA place when no GPU is present — the port never drops to the CPU
unless the caller asked for it.  :func:`backend_for` names the
``torch.distributed`` backend of a rank on a place: NCCL on a GPU unless
the caller names gloo, gloo on the CPU; it never switches on its own."""

from __future__ import annotations

import contextlib
import copy
import itertools
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import unique_name

# ---------------------------------------------------------------------------
# dtype handling
# ---------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float32": "float32", "fp32": "float32", np.float32: "float32",
    "float64": "float64", "fp64": "float64", np.float64: "float64",
    "float16": "float16", "fp16": "float16", np.float16: "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", np.int8: "int8",
    "uint8": "uint8", np.uint8: "uint8",
    "int16": "int16", np.int16: "int16",
    "int32": "int32", np.int32: "int32",
    "int64": "int64", np.int64: "int64",
    "bool": "bool", np.bool_: "bool", bool: "bool",
    float: "float32", int: "int64",
}


def convert_dtype(dtype) -> str:
    """Normalise any dtype spelling (numpy, torch, string) to a canonical
    string."""
    if isinstance(dtype, str) and dtype in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[dtype]
    if not isinstance(dtype, str) and dtype in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[dtype]
    text = str(dtype)
    if text.startswith("torch."):
        text = text[len("torch."):]
        if text in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[text]
    try:
        return np.dtype(dtype).name
    except TypeError:
        pass
    raise ValueError(f"unsupported dtype: {dtype!r}")


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    """The name of ``name``'s gradient variable (ref: framework.py)."""
    return name + GRAD_SUFFIX


# ---------------------------------------------------------------------------
# Variable / Parameter
# ---------------------------------------------------------------------------


class Variable:
    """A named tensor slot in a Block (ref: fluid framework.py Variable).

    ``shape`` may contain -1 (unknown/batch dims); concrete shapes come
    from the feeds when the program runs."""

    def __init__(self, block: "Block", name: str, shape: Sequence[int] = (),
                 dtype="float32", persistable: bool = False,
                 stop_gradient: bool = True, trainable: bool = False,
                 is_data: bool = False, initializer=None):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.trainable = trainable
        self.is_data = is_data
        self.initializer = initializer
        # distributed layout annotation (a tuple over mesh axis names);
        # None means replicated — carried through the desc unchanged
        self.dist_attr = None

    # -- python sugar mirroring the reference's Variable operators --------
    def _elementwise(self, other, op):
        from ..layers import math_ops
        return math_ops._binary(op, self, other)

    def __add__(self, other):
        return self._elementwise(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._elementwise(other, "elementwise_sub")

    def __rsub__(self, other):
        from ..layers import math_ops
        return math_ops._binary("elementwise_sub", other, self)

    def __mul__(self, other):
        return self._elementwise(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._elementwise(other, "elementwise_div")

    def __matmul__(self, other):
        from ..layers import math_ops
        return math_ops.matmul(self, other)

    def __neg__(self):
        from ..layers import math_ops
        return math_ops.scale(self, scale=-1.0)

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    __str__ = __repr__


class Parameter(Variable):
    """A trainable persistable Variable (ref: framework.py Parameter)."""

    def __init__(self, block, name, shape, dtype="float32", initializer=None,
                 regularizer=None, need_clip=True, trainable=True,
                 is_distributed=False):
        super().__init__(block, name, shape, dtype, persistable=True,
                         stop_gradient=not trainable, trainable=trainable,
                         initializer=initializer)
        self.regularizer = regularizer
        self.need_clip = need_clip
        self.is_distributed = is_distributed
        self.optimize_attrs = {"learning_rate": 1.0}


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------


class Operator:
    """Symbolic op node (ref: framework.proto OpDesc).  ``inputs`` and
    ``outputs`` map slot names to lists of variable names; the callable
    semantics live in the op registry keyed by ``type``."""

    def __init__(self, block: "Block", type: str,
                 inputs: Optional[Dict[str, Any]] = None,
                 outputs: Optional[Dict[str, Any]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.block = block
        self.type = type
        self.inputs = {k: _to_name_list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: _to_name_list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        # user creation site, attached to runtime errors
        from .errors import capture_user_callstack
        self.callstack = capture_user_callstack()

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def input_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def __repr__(self):
        return f"Op({self.type}, in={self.inputs}, out={self.outputs})"


def _to_name_list(v) -> List[str]:
    if v is None:
        return []
    if isinstance(v, (Variable, str)):
        v = [v]
    return [x.name if isinstance(x, Variable) else str(x) for x in v]


# ---------------------------------------------------------------------------
# Block / Program
# ---------------------------------------------------------------------------


class Block:
    """Ordered op list + var scope (ref: framework.py Block / BlockDesc)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def create_var(self, name=None, shape=None, dtype=None,
                   persistable=False, stop_gradient=True, is_data=False,
                   initializer=None, **kw) -> Variable:
        if name is None:
            name = unique_name.generate("tmp")
        if name in self.vars:
            # re-declaration returns the existing var only when the
            # requested metadata agrees ((), None mean "unspecified")
            existing = self.vars[name]
            from .errors import InvalidArgumentError
            if shape and existing.shape and \
                    tuple(int(s) for s in shape) != tuple(existing.shape):
                raise InvalidArgumentError(
                    f"create_var({name!r}): requested shape "
                    f"{list(shape)} conflicts with existing declaration "
                    f"{list(existing.shape)}")
            if dtype is not None and \
                    convert_dtype(dtype) != existing.dtype:
                raise InvalidArgumentError(
                    f"create_var({name!r}): requested dtype "
                    f"{convert_dtype(dtype)} conflicts with existing "
                    f"declaration {existing.dtype}")
            return existing
        v = Variable(self, name, shape if shape is not None else (),
                     dtype if dtype is not None else "float32",
                     persistable=persistable,
                     stop_gradient=stop_gradient, is_data=is_data,
                     initializer=initializer)
        self.vars[name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, name, shape, dtype="float32", initializer=None,
                         regularizer=None, trainable=True, need_clip=True,
                         is_distributed=False) -> Parameter:
        if name in self.vars:
            existing = self.vars[name]
            if not isinstance(existing, Parameter):
                from .errors import InvalidArgumentError
                raise InvalidArgumentError(
                    f"create_parameter({name!r}): a non-parameter variable "
                    f"of that name exists")
            return existing
        p = Parameter(self, name, shape, dtype, initializer=initializer,
                      regularizer=regularizer, trainable=trainable,
                      need_clip=need_clip, is_distributed=is_distributed)
        self.vars[name] = p
        self.program._bump_version()
        return p

    def append_op(self, type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def _insert_op(self, index: int, type: str, inputs=None, outputs=None,
                   attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def __repr__(self):
        return f"Block(idx={self.idx}, ops={len(self.ops)}, vars={len(self.vars)})"


def _clone_attrs(attrs, new_program):
    """Copy op attrs for Program.clone, remapping Block references into the
    cloned program (everything else is deep-copied)."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, Block):
            out[k] = new_program.blocks[v.idx]
        elif isinstance(v, (list, tuple)) and any(
                isinstance(x, Block) for x in v):
            out[k] = type(v)(new_program.blocks[x.idx]
                             if isinstance(x, Block) else copy.deepcopy(x)
                             for x in v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Program:
    """A whole training/inference program (ref: framework.py Program).
    A *main* and a *startup* program exist at any time, as in the
    reference — see :func:`default_main_program`."""

    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0          # bumped on mutation
        self._uid = next(Program._uid_counter)
        self._is_test = False
        # a mesh layout read from a JAX-package desc, kept to write back
        self._mesh_layout_desc = None

    # -- structure -------------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _bump_version(self):
        self._version += 1

    # -- queries ---------------------------------------------------------
    def all_parameters(self) -> List[Parameter]:
        out = []
        for b in self.blocks:
            out.extend(b.all_parameters())
        return out

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    # -- cloning (ref: framework.py Program.clone) -----------------------
    def clone(self, for_test: bool = False) -> "Program":
        p = Program.__new__(Program)
        p.blocks = []
        p.current_block_idx = self.current_block_idx
        p.random_seed = self.random_seed
        p._version = 0
        p._uid = next(Program._uid_counter)
        p._is_test = for_test or self._is_test
        p._mesh_layout_desc = copy.deepcopy(self._mesh_layout_desc)
        for b in self.blocks:
            p.blocks.append(Block(p, b.idx, b.parent_idx))
        for b, nb in zip(self.blocks, p.blocks):
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                nop = Operator(nb, op.type, dict(op.inputs), dict(op.outputs),
                               _clone_attrs(op.attrs, p))
                nb.ops.append(nop)
        if for_test:
            p._set_test_mode()
        return p

    def _set_test_mode(self):
        for b in self.blocks:
            for op in b.ops:
                if "is_test" in _TEST_MODE_OPS.get(op.type, ()):
                    op.attrs["is_test"] = True
        self._bump_version()

    # -- pruning (ref: framework.py Program._prune) ----------------------
    def _prune(self, targets: Sequence[Variable]) -> "Program":
        """A clone keeping only the ops needed to compute ``targets``
        (reads made inside control-flow sub-blocks count as reads of the
        op that owns the sub-block)."""
        p = self.clone()
        needed = {t.name if isinstance(t, Variable) else str(t)
                  for t in targets}
        blk = p.global_block()
        kept = []

        def op_reads(op):
            reads = set(op.input_names())
            for attr in op.attrs.values():
                subs = attr if isinstance(attr, (list, tuple)) else (attr,)
                for sub in subs:
                    if isinstance(sub, Block):
                        for sub_op in sub.ops:
                            reads |= op_reads(sub_op)
            return reads

        for op in reversed(blk.ops):
            if set(op.output_names()) & needed:
                kept.append(op)
                needed |= op_reads(op)
        blk.ops = list(reversed(kept))
        p._bump_version()
        return p

    def __repr__(self):
        return f"Program(blocks={len(self.blocks)}, version={self._version})"


# ops whose behavior flips in eval mode
_TEST_MODE_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
}


# ---------------------------------------------------------------------------
# global program state (ref: framework.py default_main_program etc.)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


def reset_default_programs():
    """Fresh global programs and names (used by tests)."""
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
    unique_name.reset()


# ---------------------------------------------------------------------------
# Places (ref: platform/place.h) — CUDAPlace is the accelerator
# ---------------------------------------------------------------------------


class Place:
    _kind = "undefined"

    def __eq__(self, other):
        return type(self) is type(other) and getattr(self, "device_id", 0) == \
            getattr(other, "device_id", 0)

    def __hash__(self):
        return hash((self._kind, getattr(self, "device_id", 0)))

    def __repr__(self):
        return f"{type(self).__name__}({getattr(self, 'device_id', '')})"


class CPUPlace(Place):
    _kind = "cpu"


class CUDAPlace(Place):
    """One NVIDIA GPU."""
    _kind = "cuda"

    def __init__(self, device_id: int = 0):
        self.device_id = device_id


def is_compiled_with_cuda() -> bool:
    import torch
    return torch.cuda.is_available()


def device_for(place: Place):
    """The ``torch.device`` a place names.  A CUDA place without a usable
    GPU raises: the port runs on the CPU only when asked to."""
    import torch
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if isinstance(place, CUDAPlace):
        if not torch.cuda.is_available():
            from .errors import UnavailableError
            raise UnavailableError(
                f"{place!r} requested but no CUDA device is available — "
                f"pass CPUPlace() (or AnalysisConfig.disable_gpu()) to run "
                f"on the CPU")
        if place.device_id >= torch.cuda.device_count():
            from .errors import InvalidArgumentError
            raise InvalidArgumentError(
                f"{place!r}: only {torch.cuda.device_count()} CUDA "
                f"device(s) present")
        # float32 matrix products stay full float32 on the card (no TF32),
        # as the XLA dots of the JAX package do — stated, not assumed
        torch.backends.cuda.matmul.allow_tf32 = False
        return torch.device("cuda", place.device_id)
    raise TypeError(f"unsupported place {place!r}")


def backend_for(place: Place, requested: Optional[str] = None) -> str:
    """The ``torch.distributed`` backend of a rank on ``place``: on a GPU
    NCCL, or gloo when the caller names it (two ranks on one GPU need
    gloo: NCCL refuses them); on the CPU gloo.  Anything else raises."""
    from .errors import InvalidArgumentError
    req = (requested or "").strip().lower() or None
    if isinstance(place, CPUPlace):
        if req not in (None, "gloo"):
            raise InvalidArgumentError(
                f"backend {requested!r} on {place!r}: ranks on the CPU "
                f"communicate over gloo")
        return "gloo"
    if isinstance(place, CUDAPlace):
        if req not in (None, "nccl", "gloo"):
            raise InvalidArgumentError(
                f"backend {requested!r} on {place!r}: nccl or gloo")
        return req or "nccl"
    raise TypeError(f"unsupported place {place!r}")
