"""Static per-step FLOPs and the device's peak FLOP/s — the port of
:func:`estimate_step_flops` and :func:`device_peak_flops` of
paddle_tpu/observability/flops.py.

:func:`estimate_step_flops` walks the program with the shapes the static
memory estimate sees (``memory_analysis.shape_env``) and prices each
GEMM-class op through the ``flops`` channel of ``ops/op_specs.py`` (2
FLOPs a multiply-add).  A backward GEMM costs two forward ones (dX and
dW), so a program with a ``backward`` op prices at 3x its forward.

:func:`device_peak_flops` reads the card's dense peak by dtype from
:data:`DEVICE_PEAK_FLOPS`; ``flag("device_peak_flops")`` (> 0) overrides
it, and a run without a CUDA device takes the flag or
:data:`CPU_FALLBACK_FLOPS`."""

from __future__ import annotations

from typing import Any, Dict, Iterable

#: dense peak FLOP/s by device-name substring (lowercase, first match
#: wins) and operand type: the NVIDIA H100 SXM's data-sheet figures
DEVICE_PEAK_FLOPS = (
    ("h100", {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}),
)

#: the peak of a host without a CUDA device (the JAX package's CPU
#: fallback): only rankings, never a device figure, are read from it
CPU_FALLBACK_FLOPS = 5e11

#: flops-specced ops of elementwise or transcendental class, kept out of
#: the GEMM-only totals
NON_GEMM_FLOPS_OPS = frozenset({
    "softmax", "log_softmax", "softmax_with_cross_entropy",
    "cross_entropy", "cross_entropy2", "c_embedding",
})


def device_peak_flops(device=None, dtype: str = "bfloat16") -> float:
    """Peak FLOP/s of ``device`` (default: CUDA device 0) for ``dtype``
    operands; ``flag("device_peak_flops")`` (> 0) overrides the table."""
    from ..flags import flag
    override = float(flag("device_peak_flops") or 0.0)
    if override > 0:
        return override
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return CPU_FALLBACK_FLOPS
        device = 0
    dev = torch.device(device) if not isinstance(device, int) \
        else torch.device("cuda", device)
    if dev.type != "cuda":
        return CPU_FALLBACK_FLOPS
    name = torch.cuda.get_device_name(dev).lower()
    for sub, peaks in DEVICE_PEAK_FLOPS:
        if sub in name:
            return float(peaks.get(str(dtype), peaks["bfloat16"]))
    raise ValueError(
        f"device_peak_flops: no peak for {name!r} in DEVICE_PEAK_FLOPS; "
        f"set flag device_peak_flops")


def estimate_step_flops(program, feed_shapes=None,
                        fetch_names: Iterable[str] = (),
                        unknown_dim: int = 1) -> Dict[str, Any]:
    """Static GEMM-class FLOPs for one step of ``program``:
    ``{"fwd_flops", "total_flops", "fwd_flops_all", "total_flops_all",
    "has_backward", "by_op", "unpriced"}`` as the JAX package returns
    them (``total_flops`` = 3 x ``fwd_flops`` with a backward;
    :data:`NON_GEMM_FLOPS_OPS` only in the ``*_all`` totals)."""
    from ..ops.registry import OP_SPECS
    from ..framework.memory_analysis import _feed_sigs, _sig_lookup, \
        shape_env

    block = program.global_block()
    feed_sigs = _feed_sigs(program, feed_shapes, unknown_dim)
    sig_of = _sig_lookup(block, shape_env(program, feed_sigs))

    fwd = 0.0
    fwd_non_gemm = 0.0
    by_op: Dict[str, float] = {}
    unpriced = []
    has_backward = False
    for op in block.ops:
        if op.type == "backward":
            has_backward = True
            continue
        spec = OP_SPECS.get(op.type)
        fn = getattr(spec, "flops", None) if spec is not None else None
        if fn is None:
            continue
        ins = {slot: [sig_of(n) for n in names]
               for slot, names in op.inputs.items()}
        outs = {slot: [sig_of(n) for n in names]
                for slot, names in op.outputs.items()}
        try:
            f = fn(ins, outs, op.attrs)
        except Exception:       # accounting must not kill the caller
            f = None
        if f is None:
            unpriced.append(op.type)
            continue
        f = float(f)
        if op.type in NON_GEMM_FLOPS_OPS:
            fwd_non_gemm += f
        else:
            fwd += f
        by_op[op.type] = by_op.get(op.type, 0.0) + f
    total = 3.0 * fwd if has_backward else fwd
    fwd_all = fwd + fwd_non_gemm
    return {"fwd_flops": fwd, "total_flops": total,
            "fwd_flops_all": fwd_all,
            "total_flops_all": 3.0 * fwd_all if has_backward else fwd_all,
            "has_backward": has_backward, "by_op": by_op,
            "unpriced": sorted(set(unpriced))}


__all__ = ["device_peak_flops", "estimate_step_flops", "DEVICE_PEAK_FLOPS",
           "CPU_FALLBACK_FLOPS", "NON_GEMM_FLOPS_OPS"]
