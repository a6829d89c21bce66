"""Def/last-use liveness of a block — the port's private copy of what
``framework.fsdp.apply_fsdp_sharding`` needs from the JAX package's
``framework/memory_analysis.py`` (:func:`block_liveness`) and
``framework/analysis.py`` (:func:`op_reads_recursive`).  The JAX package's
static memory tier (peak estimates, budgets) is not ported."""

from __future__ import annotations

from typing import Dict, Set

from .core import Block, Operator


def _iter_sub_blocks(op: Operator):
    """Block-valued attrs of a control-flow op (single or list-valued)."""
    for v in op.attrs.values():
        if isinstance(v, Block):
            yield v
        elif isinstance(v, (list, tuple)):
            for item in v:
                if isinstance(item, Block):
                    yield item


def op_reads_recursive(op: Operator) -> Set[str]:
    """All names ``op`` reads, including reads made inside its
    control-flow sub-blocks (recursively)."""
    reads = set(op.input_names())
    for sub in _iter_sub_blocks(op):
        for sub_op in sub.ops:
            reads |= op_reads_recursive(sub_op)
    return reads


class Interval:
    """Liveness interval of one name inside one block: ``def_idx`` is the
    first producing op (None for roots that pre-exist the block — feeds,
    persistables), ``last_use`` the last op reading it (uses inside a
    control-flow sub-block count at the parent op's index).  ``pinned``
    roots (persistables, data vars) live across the whole block."""

    __slots__ = ("name", "def_idx", "last_use", "pinned")

    def __init__(self, name):
        self.name = name
        self.def_idx = None
        self.last_use = -1
        self.pinned = False

    def __repr__(self):
        return (f"Interval({self.name!r}, def={self.def_idx}, "
                f"last_use={self.last_use}, pinned={self.pinned})")


def block_liveness(block: Block) -> Dict[str, Interval]:
    """Def/last-use intervals for every name touched in ``block``.  A
    control-flow op reads, at its own index, every name its sub-blocks
    read; persistable and data roots are pinned (the JAX package's
    ``block_liveness`` with no feeds or fetches named)."""
    out: Dict[str, Interval] = {}
    for idx, op in enumerate(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        for n in op_reads_recursive(op):
            iv = out.get(n)
            if iv is None:
                iv = out[n] = Interval(n)
            iv.last_use = max(iv.last_use, idx)
        for n in op.output_names():
            iv = out.get(n)
            if iv is None:
                iv = out[n] = Interval(n)
            if iv.def_idx is None:
                iv.def_idx = idx
    for n, iv in out.items():
        v = block._find_var_recursive(n)
        if v is not None and (v.persistable or v.is_data):
            iv.pinned = True
    return out


__all__ = ["Interval", "block_liveness", "op_reads_recursive"]
