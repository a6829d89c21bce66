"""Static checks of the port — one function of paddle_tpu/framework/
analysis.py so far: :func:`verify_reshard`, the ``reshard-*`` diagnostics
of a resharding-restore plan (framework/reshard.py), against the port's
own op registry.  :class:`Diagnostic` and :class:`VerifyResult` are the
JAX package's containers; the program verifier, shape inference and the
other checks of that module wait for their slice."""

from __future__ import annotations

from typing import Dict, List, Optional

from .errors import InvalidArgumentError

#: anchored diagnostic codes for resharding-restore plans
RESHARD_INDIVISIBLE = "reshard-indivisible"
RESHARD_AXIS_DANGLING = "reshard-axis-dangling"
RESHARD_FLAT_SHAPE = "reshard-flat-shape"
RESHARD_UNKNOWN_STEP = "reshard-unknown-step"
RESHARD_UNLOWERABLE = "reshard-unlowerable-step"
RESHARD_DIVS_UNRESOLVED = "reshard-divs-unresolved"
RESHARD_NEGATIVE_WIRE = "reshard-negative-wire"
RESHARD_CANDIDATE_ORDER = "reshard-candidate-order"
RESHARD_NOOP = "reshard-noop"


class Diagnostic:
    """One verifier finding: severity (``error`` / ``warning``), code and
    message (a plan's findings name their persistable; none is anchored to
    an op)."""

    __slots__ = ("severity", "code", "message", "op_type", "block_idx",
                 "op_index", "callstack")

    def __init__(self, severity: str, code: str, message: str, op=None,
                 block_idx: int = 0, op_index: int = -1):
        self.severity = severity
        self.code = code
        self.message = message
        self.op_type = op.type if op is not None else None
        self.block_idx = block_idx
        self.op_index = op_index
        self.callstack = list(getattr(op, "callstack", None) or ())

    def format(self) -> str:
        loc = ""
        if self.op_type is not None:
            loc = (f" [operator < {self.op_type} > "
                   f"block {self.block_idx} op #{self.op_index}]")
        lines = [f"{self.severity.upper()} {self.code}{loc}: {self.message}"]
        if self.callstack:
            lines.append("  Python call stack (op creation site):")
            lines.extend(f"    {frame}" for frame in self.callstack)
        return "\n".join(lines)

    def __repr__(self):
        return f"Diagnostic({self.severity}, {self.code}, {self.op_type})"


class VerifyResult:
    """The diagnostics of one check."""

    def __init__(self, program=None):
        self.program = program
        self.diagnostics: List[Diagnostic] = []
        self.unspecced_ops: Dict[str, int] = {}

    def add(self, severity, code, message, op=None, block_idx=0,
            op_index=-1):
        self.diagnostics.append(
            Diagnostic(severity, code, message, op, block_idx, op_index))

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def raise_on_error(self):
        errs = self.errors()
        if errs:
            raise InvalidArgumentError(
                "program verification failed with "
                f"{len(errs)} error(s):\n" +
                "\n".join(d.format() for d in errs))
        return self

    def report(self) -> str:
        lines = [f"program verification: {len(self.errors())} error(s), "
                 f"{len(self.warnings())} warning(s)"]
        for d in self.diagnostics:
            lines.append(d.format())
        return "\n".join(lines)


def verify_reshard(plan, result: Optional[VerifyResult] = None
                   ) -> VerifyResult:
    """Validate a :class:`~.reshard.ReshardPlan` before anything moves:
    every step lowers to an op the port registers, the step chain lands on
    the destination shard counts, no step prices negative wire, the chosen
    candidate is the cheapest, plus the plan's own per-var issues
    (indivisible dims, dangling axes, flat-shard metadata that does not
    fit) — the JAX package's checks and codes."""
    from .. import ops  # noqa: F401  (registers every op)
    from ..ops.registry import OPS
    from .reshard import STEP_LOWERING

    result = result or VerifyResult()
    for sev, code, msg in plan.issues():
        result.add(sev, code, msg)
    if plan.identity and plan.transfers:
        src = plan.src_layout.sizes if plan.src_layout else None
        dst = plan.dst_layout.sizes if plan.dst_layout else None
        if src == dst:
            result.add("warning", RESHARD_NOOP,
                       f"reshard plan {src} -> {dst} moves nothing — "
                       f"the layouts are identical")
    local_ops = {"slice", "concat", "reshape", "c_identity"}
    for t in plan.transfers.values():
        if t.identity:
            continue
        cur = list(t.src_divs)
        for s in t.steps:
            if s.kind not in STEP_LOWERING:
                result.add("error", RESHARD_UNKNOWN_STEP,
                           f"persistable {t.name!r}: step kind "
                           f"{s.kind!r} has no lowering")
                continue
            for op in s.lowers_to:
                if op not in OPS and op not in local_ops:
                    result.add(
                        "error", RESHARD_UNLOWERABLE,
                        f"persistable {t.name!r}: step {s.kind!r} "
                        f"lowers to unregistered op {op!r}")
            if s.wire_bytes < 0:
                result.add("error", RESHARD_NEGATIVE_WIRE,
                           f"persistable {t.name!r}: step {s.kind!r} "
                           f"prices negative wire ({s.wire_bytes})")
            if s.kind != "repad" and s.dim < len(cur):
                if cur[s.dim] != s.src_parts:
                    result.add(
                        "error", RESHARD_DIVS_UNRESOLVED,
                        f"persistable {t.name!r}: step {s.kind!r} on "
                        f"dim {s.dim} expects {s.src_parts} source "
                        f"part(s), chain has {cur[s.dim]}")
                cur[s.dim] = s.dst_parts
            elif s.kind == "repad":
                cur = list(t.dst_divs)
        if t.flat is None and cur != list(t.dst_divs):
            result.add("error", RESHARD_DIVS_UNRESOLVED,
                       f"persistable {t.name!r}: schedule ends at shard "
                       f"counts {cur}, destination needs {t.dst_divs}")
        if t.candidates:
            chosen = [c for c in t.candidates if c.get("chosen")]
            if len(chosen) != 1:
                result.add("error", RESHARD_CANDIDATE_ORDER,
                           f"persistable {t.name!r}: "
                           f"{len(chosen)} chosen candidate(s), want 1")
            elif any(c["wire_bytes"] < chosen[0]["wire_bytes"]
                     for c in t.candidates):
                result.add(
                    "error", RESHARD_CANDIDATE_ORDER,
                    f"persistable {t.name!r}: a rejected candidate is "
                    f"cheaper than the chosen schedule "
                    f"({t.candidates})")
    return result


__all__ = ["Diagnostic", "VerifyResult", "verify_reshard",
           "RESHARD_INDIVISIBLE", "RESHARD_AXIS_DANGLING",
           "RESHARD_FLAT_SHAPE", "RESHARD_UNKNOWN_STEP",
           "RESHARD_UNLOWERABLE", "RESHARD_DIVS_UNRESOLVED",
           "RESHARD_NEGATIVE_WIRE", "RESHARD_CANDIDATE_ORDER",
           "RESHARD_NOOP"]
