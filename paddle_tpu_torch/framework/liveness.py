"""Def/last-use liveness of a block — the port of the liveness half of
the JAX package's ``framework/memory_analysis.py`` (:func:`block_liveness`,
:func:`program_liveness`) and ``framework/analysis.py``
(:func:`op_reads_recursive`).  ``framework.memory_analysis`` (the static
peak estimate) and ``framework.fsdp`` (the gather windows) read it; it is
the one copy of these functions in the port."""

from __future__ import annotations

from typing import Dict, Iterable, Set

from .core import Block, Operator, Program


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
    roots (feeds, fetches, persistables, data vars) live across the whole
    block regardless of their last textual use."""

    __slots__ = ("name", "def_idx", "last_use", "pinned", "def_op")

    def __init__(self, name, def_idx=None, last_use=-1, pinned=False,
                 def_op=None):
        self.name = name
        self.def_idx = def_idx
        self.last_use = last_use
        self.pinned = pinned
        self.def_op = def_op           # Operator, for creation-site anchors

    def live_at(self, idx: int, end: int) -> bool:
        if self.pinned:
            return True
        lo = self.def_idx if self.def_idx is not None else 0
        return lo <= idx <= (end if self.last_use < 0 else self.last_use)

    def __repr__(self):
        return (f"Interval({self.name!r}, def={self.def_idx}, "
                f"last_use={self.last_use}, pinned={self.pinned})")


def block_liveness(block: Block, feed_names: Iterable[str] = (),
                   fetch_names: Iterable[str] = (),
                   pinned_extra: Iterable[str] = ()) -> Dict[str, Interval]:
    """Def/last-use intervals for every name touched in ``block``.  A
    control-flow op reads, at its own index, every name its sub-blocks
    read; feed, fetch, persistable and data roots are pinned."""
    fetch = set(fetch_names)
    pinned = set(feed_names) | set(pinned_extra)
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
                iv.def_op = op
    for n, iv in out.items():
        v = block._find_var_recursive(n)
        if n in pinned or n in fetch or (
                v is not None and (v.persistable or v.is_data)):
            iv.pinned = True
    return out


def program_liveness(program: Program, feed_names: Iterable[str] = (),
                     fetch_names: Iterable[str] = ()
                     ) -> Dict[int, Dict[str, Interval]]:
    """Liveness per block index, sub-blocks included (each sub-block gets
    its own interval table; its closure reads also appear as uses in the
    parent table at the owning op's index)."""
    tables: Dict[int, Dict[str, Interval]] = {}

    def walk(block, feeds, fetches):
        tables[block.idx] = block_liveness(block, feeds, fetches)
        for op in block.ops:
            for sub in _iter_sub_blocks(op):
                if sub.idx not in tables:
                    walk(sub, (), ())
    walk(program.global_block(), feed_names, fetch_names)
    return tables


__all__ = ["Interval", "block_liveness", "program_liveness",
           "op_reads_recursive"]
