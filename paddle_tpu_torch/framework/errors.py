"""Error enforcement: typed error taxonomy + Python call-site attachment
(ref: platform/enforce.h PADDLE_ENFORCE, platform/error_codes.proto, and
framework/op_call_stack.cc which attaches the Python stack of the op's
creation site to runtime errors).

Every Operator records the USER frame that created it (build time); when
executing an op fails, the executor wraps the exception in
``EnforceNotMet`` carrying the op type and that call site — so a shape
error deep inside a program points at the user's ``fluid.layers.*``
line, not a bare PyTorch traceback."""

from __future__ import annotations

import os
import traceback
from typing import List, Optional

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Error(Exception):
    """Base framework error (ref: platform/errors.h error classes)."""
    code = "UNKNOWN"


class InvalidArgumentError(Error):
    code = "INVALID_ARGUMENT"


class NotFoundError(Error):
    code = "NOT_FOUND"


class OutOfRangeError(Error):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(Error):
    code = "ALREADY_EXISTS"


class PermissionDeniedError(Error):
    code = "PERMISSION_DENIED"


class UnimplementedError(Error):
    code = "UNIMPLEMENTED"


class PreconditionNotMetError(Error):
    code = "PRECONDITION_NOT_MET"


class ExecutionTimeoutError(Error):
    code = "EXECUTION_TIMEOUT"


class UnavailableError(Error):
    code = "UNAVAILABLE"


class FatalError(Error):
    code = "FATAL"


class GuardrailViolation(Error):
    """The self-healing step runtime's controlled abort: the bounded
    consecutive-skip budget (``flag("max_skipped_steps")``) was
    exhausted by non-finite steps — a flight bundle with replayable
    sidecars was dumped before this raised (framework/guardrails.py)."""
    code = "GUARDRAIL_VIOLATION"


class EnforceNotMet(Error):
    """Runtime op failure with the op's Python creation site attached
    (ref: enforce.h EnforceNotMet + op_call_stack.cc
    InsertCallStackInfo)."""

    def __init__(self, op_type: str, cause: BaseException,
                 callstack: Optional[List[str]] = None):
        self.op_type = op_type
        self.cause = cause
        self.callstack = list(callstack or [])
        lines = [f"[operator < {op_type} > error] "
                 f"{type(cause).__name__}: {cause}"]
        if self.callstack:
            lines.append("Python call stack (op creation site):")
            lines.extend(f"  {frame}" for frame in self.callstack)
        super().__init__("\n".join(lines))


def capture_user_callstack(limit: int = 3) -> List[str]:
    """Innermost-first capture of the nearest ``limit`` user frames
    (outside this package) — recorded per op at build time (the
    op_call_stack analog).  Cheap: walks raw frames upward with
    sys._getframe and stops at ``limit``; source lines load lazily from
    the linecache."""
    import sys
    import linecache
    try:
        frame = sys._getframe(1)
    except ValueError:
        return []
    out = []
    while frame is not None and len(out) < limit:
        fname = frame.f_code.co_filename
        if not fname.startswith(_PKG_ROOT) and \
                "site-packages" not in fname:
            line = linecache.getline(fname, frame.f_lineno).strip()
            out.append(f'File "{fname}", line {frame.f_lineno}, '
                       f'in {frame.f_code.co_name}: {line}')
        frame = frame.f_back
    out.reverse()                  # outermost first, like a traceback
    return out


def enforce(condition, message, exc=InvalidArgumentError):
    """ref: PADDLE_ENFORCE — raise ``exc`` with message unless
    condition."""
    if not condition:
        raise exc(message)
