"""Op registry and kernel-route table — the port of
paddle_tpu/ops/registry.py.

An op impl has the JAX package's signature::

    fn(ctx, ins, attrs) -> {slot: tensor | [tensors]}

with ``ins`` mapping input slot names to lists of ``torch.Tensor`` and
``ctx`` a :class:`LoweringContext` (test mode, device, ``torch.Generator``).

The kernel-route table mirrors ``PallasLowering`` / ``pallas_route``
(registry.py:87,153 of the JAX package): every routing decision onto a
hand-written CUDA kernel is a (flag, shape) gate in ONE statically
enumerable table, registered per op type with :func:`register_routes`.
Each route's ``supported(ins, attrs)`` states exactly what its CUDA
kernel rejects, and every decision is counted in :data:`ROUTE_COUNTS`
(``(op, kernel, outcome, reason) -> n``), so a run can prove which ops
reached a kernel and that none fell back.  A hit does not mean the GPU:
the route's kernel wrapper runs its plain version on CPU tensors.

No fallback on the card: the op's plain composition runs in place of a
kernel only when the route's flag (or the op's attr) turns it off, or
when the op's tensors lie on the CPU.  A gate that rejects tensors on any
other device raises :class:`UnimplementedError` with the gate's reason.

Integer ids stay int64 (the JAX package narrows them to int32 when x64
is off); tests compare values, not dtypes.

:func:`abstract_eval` is the counterpart of ``jax.eval_shape``: ops run
inside it on ``meta`` tensors take their plain compositions, and their
route decisions are not counted (no kernel, no launch, no fallback)."""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from ..framework.errors import UnimplementedError

OPS: Dict[str, Callable] = {}
#: op type -> the impl that takes a run of such ops at once (see
#: :func:`register_group`)
GROUPS: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        if name in OPS:
            raise ValueError(f"op {name!r} registered twice")
        OPS[name] = fn
        return fn
    return deco


def register_group(*names: str):
    """Register ``fn(ctx, [(op_type, ins, attrs), ...]) -> [outs, ...]``
    for the op types ``names``: the executor hands it every maximal run of
    consecutive ops of those types in which no op reads or writes what an
    earlier one of the run writes, nor writes what an earlier one reads
    (``executor._run_end``), and scatters each op's outputs as
    ``get_op``'s.  It
    must compute what the ops' own impls compute one after the other (the
    JAX package's step fuses such runs into one executable)."""
    def deco(fn):
        for name in names:
            if name in GROUPS:
                raise ValueError(f"op {name!r} grouped twice")
            GROUPS[name] = fn
        return fn
    return deco


def get_group(name: str) -> Optional[Callable]:
    return GROUPS.get(name)


def get_op(name: str) -> Callable:
    try:
        return OPS[name]
    except KeyError:
        raise NotImplementedError(
            f"op {name!r} has no PyTorch implementation in the port yet "
            f"({len(OPS)} ops available)") from None


class LoweringContext:
    """Threaded through one program run: test mode, the device the run
    executes on, the seeded generator random ops draw from, whether the
    run owns its state (``donate_state``: optimizer ops then update
    parameters and moments in place), and the process groups the
    collectives reduce over (``dp``: an ``ops.collective_ops.
    DataParallelGroup`` for a run over one axis, a ``MeshGroups`` for a
    mesh of several; None outside a process group).
    ``predicate_reads`` counts the device values the run read on the host
    to choose a path (a ``conditional_block``'s predicate, a LocalSGD
    sync step): each is one wait for the device.  ``grad_sync`` is the
    training run's ``collective_ops.GradSyncRecord`` when it synced
    gradients over a group, else None.  A guarded training run
    (``framework/guardrails.py``) sets ``guard`` (its policy) and
    ``guard_state`` before it starts, and the backward sets
    ``guard_skip`` (an int32 device tensor, 1 on a step to skip), which
    the ops that update in place read."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None,
                 is_test: bool = False, donate_state: bool = False,
                 dp=None):
        self.generator = generator
        self.device = device if device is not None else torch.device("cpu")
        self.is_test = is_test
        self.donate_state = donate_state
        self.dp = dp
        self.predicate_reads = 0
        self.grad_sync = None
        self.guard = None
        self.guard_state = None
        self.guard_skip = None

    def read_predicate(self, value: torch.Tensor) -> bool:
        """The one-element ``value`` as a Python bool, read on the host
        (a wait for the device where it lies there), counted in
        ``predicate_reads``."""
        self.predicate_reads += 1
        return bool(value.reshape(()).item())

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The run's mesh axes (the JAX package's mesh axis names): its
        groups' axes, or none."""
        return tuple(self.dp.axis_names) if self.dp is not None else ()


def x(ins, slot, i=0):
    """Fetch input ``slot[i]``, or None if absent/empty."""
    v = ins.get(slot)
    if not v:
        return None
    return v[i]


# ---------------------------------------------------------------------------
# kernel routes
# ---------------------------------------------------------------------------


class CudaLowering:
    """One hand-written kernel route for an op (the counterpart of the JAX
    package's ``PallasLowering``).  Fields:

    * ``kernel`` — route name (``"flash_attention"``, ``"fused_layer_norm"``
      ...), the unit the counters report on;
    * ``flag`` — the flags.py gate; ``attr`` optionally names an op attr
      that overrides the flag per op;
    * ``match(attrs)`` — applicability: a route that does not match is
      not in play for this op instance and is skipped silently (not a
      fallback);
    * ``supported(ins, attrs)`` → ``(ok, reason)`` — exactly what the CUDA
      kernel rejects, from the input tensors' shapes and dtypes;
    * ``kernels`` — the wrapper(s) this route launches, by their
      ``ops.cuda.LAUNCHES`` key;
    * ``replaces`` — for each of ``kernels``, the ``file:line`` of the TPU
      kernel it stands in for;
    * ``sources`` — for each of ``kernels``, the CUDA source it is built
      from (``source`` takes one path for all of them, or a tuple).

    The op impl calls the kernel wrapper itself when :func:`cuda_route`
    returns the route.
    """

    __slots__ = ("kernel", "flag", "attr", "match", "supported", "kernels",
                 "replaces", "sources")

    def __init__(self, kernel: str, flag: Optional[str] = None,
                 attr: Optional[str] = None,
                 match: Optional[Callable] = None,
                 supported: Optional[Callable] = None,
                 kernels=(), replaces=(), source=""):
        self.kernel = kernel
        self.flag = flag
        self.attr = attr
        self.match = match
        self.supported = supported
        self.kernels = tuple(kernels)
        self.replaces = tuple(replaces)
        self.sources = (source,) * len(self.kernels) \
            if isinstance(source, str) else tuple(source)


ROUTES: Dict[str, Tuple[CudaLowering, ...]] = {}

_ABSTRACT = threading.local()


class abstract_eval:
    """Context manager: inside it (on this thread) :func:`cuda_route`
    sends every op to its plain composition, uncounted — for running ops
    on ``meta`` tensors to learn their outputs' shapes and dtypes, as
    ``jax.eval_shape`` does, without launching or refusing a kernel."""

    def __enter__(self):
        self._old = getattr(_ABSTRACT, "on", False)
        _ABSTRACT.on = True
        return self

    def __exit__(self, *exc):
        _ABSTRACT.on = self._old
        return False

# ---------------------------------------------------------------------------
# the static spec channels (the JAX package's OpSpec, less ``infer`` and
# ``pallas``: shapes come from a forward on ``meta`` tensors, kernel
# routes from ROUTES)
# ---------------------------------------------------------------------------


class OpSpec:
    """Static metadata for one op type, read by the static estimators
    (``framework/memory_analysis.py``, ``observability/flops.py``):

    * ``collective`` — the op communicates (or rides the collective
      schedule) and runs after the backward as grad sync;
    * ``mem_transparent`` — True for fusible ops (views, elementwise
      arithmetic, activations): the output joins its input's residual
      alias class; None defers to the analyzer's fallback set;
    * ``mem_backward_extra(ins, outs, attrs) -> bytes`` — op-internal
      values kept for the backward that are no named variable;
    * ``wire(ins, attrs, axis_sizes) -> (logical_bytes, wire_bytes)`` —
      the collective's payload against what its ring schedule moves under
      its compression spec;
    * ``flops(ins, outs, attrs) -> float`` — forward GEMM-class FLOPs.

    ``ins`` / ``outs`` map slots to lists of ``op_specs.VarSig`` (None
    where unknown)."""

    __slots__ = ("name", "collective", "mem_transparent",
                 "mem_backward_extra", "wire", "flops")

    def __init__(self, name: str, collective: bool = False,
                 mem_transparent: Optional[bool] = None,
                 mem_backward_extra: Optional[Callable] = None,
                 wire: Optional[Callable] = None,
                 flops: Optional[Callable] = None):
        self.name = name
        self.collective = collective
        self.mem_transparent = mem_transparent
        self.mem_backward_extra = mem_backward_extra
        self.wire = wire
        self.flops = flops


#: op type -> its :class:`OpSpec` (``ops/op_specs.py`` fills it)
OP_SPECS: Dict[str, OpSpec] = {}


def op_spec(name: str, collective: bool = False,
            mem_transparent: Optional[bool] = None,
            mem_backward_extra: Optional[Callable] = None,
            wire: Optional[Callable] = None,
            flops: Optional[Callable] = None) -> OpSpec:
    """Register the static metadata of op ``name`` (re-registration
    replaces)."""
    spec = OpSpec(name, collective=collective,
                  mem_transparent=mem_transparent,
                  mem_backward_extra=mem_backward_extra, wire=wire,
                  flops=flops)
    OP_SPECS[name] = spec
    return spec


#: the static channels of an OpSpec, in census order (the JAX package's
#: ``infer`` channel is the port's forward on ``meta`` tensors)
SPEC_CHANNELS = ("flops", "wire", "mem")


def spec_coverage() -> Dict[str, list]:
    """Which registered op types carry each static channel:
    ``{"flops": [...], "wire": [...], "mem": [...]}``, each sorted; "mem"
    counts an op with ``mem_transparent`` or ``mem_backward_extra``."""
    cov = {ch: [] for ch in SPEC_CHANNELS}
    for name in sorted(OP_SPECS):
        spec = OP_SPECS[name]
        if spec.flops is not None:
            cov["flops"].append(name)
        if spec.wire is not None:
            cov["wire"].append(name)
        if spec.mem_transparent is not None or \
                spec.mem_backward_extra is not None:
            cov["mem"].append(name)
    return cov


#: bytes an element of each dtype takes on the card (int64 ids stay
#: int64 there; the JAX package prices them at int32, its x64 being off)
DTYPE_BYTES = {"float64": 8, "int64": 8, "float32": 4, "int32": 4,
               "bfloat16": 2, "float16": 2, "int16": 2, "int8": 1,
               "uint8": 1, "bool": 1}


def dtype_nbytes(dtype) -> int:
    """Bytes per element of ``dtype`` as the card holds it."""
    key = str(dtype).replace("torch.", "")
    b = DTYPE_BYTES.get(key)
    if b is None:
        b = int(torch.empty((), dtype=getattr(torch, key)).element_size())
    return b


#: (op type, kernel, "hit" | "fallback", reason) -> count
ROUTE_COUNTS: Dict[Tuple[str, str, str, str], int] = {}
_COUNT_LOCK = threading.Lock()


def register_routes(op_type: str, *routes: CudaLowering):
    ROUTES[op_type] = tuple(routes)


def route_table() -> Dict[str, Tuple[CudaLowering, ...]]:
    """The statically enumerable kernel tier: op type → its routes."""
    return dict(ROUTES)


def _count(op_type, kernel, outcome, reason):
    key = (op_type, kernel, outcome, reason)
    with _COUNT_LOCK:
        ROUTE_COUNTS[key] = ROUTE_COUNTS.get(key, 0) + 1


def reset_route_counts():
    with _COUNT_LOCK:
        ROUTE_COUNTS.clear()


def route_counts(outcome: Optional[str] = None
                 ) -> Dict[Tuple[str, str, str, str], int]:
    with _COUNT_LOCK:
        return {k: v for k, v in ROUTE_COUNTS.items()
                if outcome is None or k[2] == outcome}


def _device_of(ins) -> Optional[torch.device]:
    for vals in ins.values():
        for v in vals or ():
            if isinstance(v, torch.Tensor):
                return v.device
    return None


def cuda_route(op_type: str, ins, attrs, kernel: Optional[str] = None,
               count: bool = True):
    """Resolve the kernel route for one op instance (the counterpart of
    ``pallas_route``).  Returns ``(route, reason)``: the winning
    :class:`CudaLowering`, or None with the reason every matching route
    fell back (``flag:...=off``, or the kernel's shape/dtype reason for
    CPU tensors).  A gate that rejects tensors off the CPU raises
    :class:`UnimplementedError`: there the only plain path is the one a
    flag asks for.  Hits and fallbacks are counted in
    :data:`ROUTE_COUNTS`."""
    routes = ROUTES.get(op_type)
    if not routes:
        return None, "no-cuda-route"
    if getattr(_ABSTRACT, "on", False):
        return None, "abstract-eval"
    reasons = []
    rejected = []
    matched = []
    for route in routes:
        if kernel is not None and route.kernel != kernel:
            continue
        if route.match is not None and not route.match(attrs):
            continue
        matched.append(route.kernel)
        enabled = True
        if route.flag is not None:
            from ..flags import flag as _flag
            enabled = _flag(route.flag)
        if route.attr is not None and attrs.get(route.attr) is not None:
            enabled = attrs[route.attr]
        if not enabled:
            reasons.append(f"flag:{route.flag}=off")
            continue
        ok, why = (True, "") if route.supported is None else \
            route.supported(ins, attrs)
        if ok:
            if count:
                _count(op_type, route.kernel, "hit", "supported")
            return route, "supported"
        reasons.append(why)
        rejected.append(f"{route.kernel}: {why}")
    if not matched:
        return None, "no-matching-route"
    device = _device_of(ins)
    if rejected and device is not None and device.type != "cpu":
        raise UnimplementedError(
            f"{op_type} on {device}: the CUDA kernel rejects this input "
            f"({'; '.join(rejected)}), and the port runs no plain fallback "
            f"on the card; turn the route's flag off to ask for the plain "
            f"composition")
    reason = "; ".join(reasons)
    if count:
        _count(op_type, matched[0], "fallback", reason)
    return None, reason
