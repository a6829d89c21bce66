"""Named-axis mesh layout — the port of paddle_tpu/framework/mesh_layout.py.

* :class:`ShardSpec` — a PartitionSpec over named axes, one entry per
  tensor dim (``None``, an axis name, or a tuple of axis names).  It
  subclasses ``tuple``, so every ``dist_attr`` consumer keeps working;
  ``Variable.dist_attr``'s setter coerces a bare tuple to it.
* :class:`MeshLayout` — the named axes with their sizes (``data × fsdp ×
  tp`` and extras), device-free; it serializes with the program
  (``mesh_layout`` in the desc) exactly as the JAX package writes it.

The JAX package turns a layout into a ``jax.sharding.Mesh``; the port runs
one process per rank, so :meth:`MeshLayout.build_mesh` returns a
:class:`ProcessMesh`: the squeezed axis names and sizes over the
``torch.distributed`` process group, each rank at its coordinates
(row-major over the squeezed axes, as the JAX package reshapes its
devices), with one process group per line of the grid.  This port takes
the data and the fsdp axes — ``data=n`` (data parallelism, ZeRO-1),
``fsdp=n`` (ZeRO-3) and both (HSDP) — with the tensor axis and one
extra sequence axis ``sp`` beside them (Megatron tensor parallelism and
ring attention; ZeRO-3 shards what the tp layers did not stamp, and the
fsdp axis runs beside any two of data, tp and sp), the pipeline axis
``pp`` beside the data axis (dp x pp), and the expert axis ``ep`` beside
the data and the fsdp axes (dp x ep, fsdp x ep, dp x fsdp x ep); a
layout with another extra axis above size 1, data, fsdp, tp and sp all
at once, pp beside fsdp, tp or sp, or ep beside tp, sp or pp, raises
:class:`UnimplementedError` naming it."""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .errors import UnimplementedError

DATA_AXIS = "dp"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"
PIPE_AXIS = "pp"
EXPERT_AXIS = "ep"
#: the sequence-parallel axis (an extra axis of the layout, as the JAX
#: package spells it: ``MeshLayout(tp=2, extra_axes={"sp": 2})``)
SEQ_AXIS = "sp"
#: the mesh axes the port runs: data parallelism, ZeRO / HSDP, Megatron
#: tensor parallelism, ring attention, pipeline and expert parallelism
PORTED_AXES = (DATA_AXIS, FSDP_AXIS, TP_AXIS, SEQ_AXIS, PIPE_AXIS,
               EXPERT_AXIS)


def check_ported_axes(sizes: Dict[str, int], what: str,
                      ported: Tuple[str, ...] = PORTED_AXES):
    """Raise :class:`UnimplementedError` naming each axis of ``sizes``
    ({axis: size}) above size 1 outside ``ported``; ``what`` names the
    caller."""
    other = {a: n for a, n in sizes.items() if n > 1 and a not in ported}
    if other:
        raise UnimplementedError(
            f"{what} over the axes {dict(sizes)}: the axes {other} are not "
            f"ported yet; the port takes the {', '.join(ported)} axes (data "
            f"parallelism, ZeRO, HSDP, Megatron tensor parallelism, ring "
            f"attention, pipeline and expert parallelism)")
    check_pipe_beside(sizes, what)
    check_expert_beside(sizes, what)
    check_fsdp_beside(sizes, what)


def check_fsdp_beside(sizes: Dict[str, int], what: str,
                      data_axis: str = DATA_AXIS, fsdp_axis: str = FSDP_AXIS,
                      tp_axis: str = TP_AXIS):
    """Raise :class:`UnimplementedError` when the data, fsdp, tensor and
    sequence axes are all above size 1: fsdp runs beside any two of the
    others (data x fsdp x tp, data x fsdp x sp, fsdp x tp x sp), and no
    run has trained the four at once yet."""
    four = {a: sizes.get(a, 1) for a in (data_axis, fsdp_axis, tp_axis,
                                         SEQ_AXIS)}
    if min(four.values()) > 1:
        raise UnimplementedError(
            f"{what} over the axes {dict(sizes)}: {fsdp_axis} beside "
            f"{data_axis}, {tp_axis} and {SEQ_AXIS} at once is not ported "
            f"yet; {fsdp_axis} runs beside any two of them")


def check_pipe_beside(sizes: Dict[str, int], what: str,
                      pipe_axis: str = PIPE_AXIS):
    """Raise :class:`UnimplementedError` when the pipe axis is above size 1
    beside a fsdp, tensor or sequence axis above size 1: the pipelined
    lowering runs over data x pp only (plain data parallelism or ZeRO-1
    beside it)."""
    if sizes.get(pipe_axis, 1) < 2:
        return
    beside = {a: n for a, n in sizes.items()
              if n > 1 and a in (FSDP_AXIS, TP_AXIS, SEQ_AXIS)}
    if beside:
        raise UnimplementedError(
            f"{what} over the axes {dict(sizes)}: the pipe axis beside "
            f"{beside} is not ported yet; pipeline parallelism runs over "
            f"{DATA_AXIS} x {pipe_axis} (with plain data parallelism or "
            f"ZeRO-1 over {DATA_AXIS})")


def check_expert_beside(sizes: Dict[str, int], what: str,
                        expert_axis: str = EXPERT_AXIS,
                        pipe_axis: str = PIPE_AXIS, tp_axis: str = TP_AXIS):
    """Raise :class:`UnimplementedError` when the expert axis is above size
    1 beside a tensor, sequence or pipe axis above size 1: expert
    parallelism runs over data x fsdp x ep (the expert exchange inside a
    tensor-parallel block, a ring-attention shard or a pipeline stage is
    not ported)."""
    if sizes.get(expert_axis, 1) < 2:
        return
    beside = {a: n for a, n in sizes.items()
              if n > 1 and a in (tp_axis, SEQ_AXIS, pipe_axis)}
    if beside:
        raise UnimplementedError(
            f"{what} over the axes {dict(sizes)}: the expert axis beside "
            f"{beside} is not ported yet; expert parallelism runs over "
            f"{DATA_AXIS} x {FSDP_AXIS} x {expert_axis}")


def _flat_axes(entries) -> Tuple[str, ...]:
    """Flatten spec entries / axis collections into a flat tuple of axis
    names (drops Nones, recurses into tuple entries)."""
    if entries is None:
        return ()
    if isinstance(entries, str):
        return (entries,)
    out = []
    for e in entries:
        if e is None:
            continue
        if isinstance(e, str):
            out.append(e)
        else:
            out.extend(_flat_axes(e))
    return tuple(out)


class ShardSpec(tuple):
    """PartitionSpec over named mesh axes, one entry per tensor dim:
    ``None`` (replicated), ``"axis"`` or ``("axis_a", "axis_b")``."""

    def __new__(cls, entries: Iterable = ()):
        norm = []
        for e in entries:
            if e is None or isinstance(e, str):
                norm.append(e)
            elif isinstance(e, (tuple, list)):
                sub = tuple(a for a in e if a is not None)
                for a in sub:
                    if not isinstance(a, str):
                        raise TypeError(
                            f"ShardSpec entry {e!r}: axis names must be "
                            f"strings")
                norm.append(sub if len(sub) > 1 else
                            (sub[0] if sub else None))
            else:
                raise TypeError(
                    f"ShardSpec entry {e!r} is not None/str/tuple-of-str")
        return super().__new__(cls, norm)

    @classmethod
    def coerce(cls, value) -> Optional["ShardSpec"]:
        """None-safe normalisation of any dist_attr spelling."""
        if value is None:
            return None
        if isinstance(value, ShardSpec):
            return value
        return cls(tuple(value))

    @property
    def axes(self) -> Tuple[str, ...]:
        """Flat tuple of every axis name the spec shards over."""
        return _flat_axes(self)

    def __repr__(self):
        return f"ShardSpec{tuple(self)!r}"


class ProcessMesh:
    """The port's mesh: the named axes of a layout that are above size 1,
    with their sizes, laid over the ``torch.distributed`` process group
    (one process per rank).  ``axis_names`` and ``shape`` ({axis: size})
    are what ``CompiledProgram.with_mesh`` reads.

    Rank ``r`` sits at the coordinates :meth:`coords` gives, row-major over
    the axes (the last axis varies fastest), as the JAX package reshapes
    its device list.  :meth:`line_group` is the process group of the ranks
    that differ only on some of the axes (a line of the grid for one
    axis); the groups are created the first time a mesh of this shape is
    asked for one, every line of every axis set in the same order on
    every rank, as ``torch.distributed.new_group`` needs."""

    def __init__(self, axis_names: Tuple[str, ...], sizes: Tuple[int, ...]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in sizes)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def coords(self, rank: int) -> Dict[str, int]:
        """{axis: coordinate} of ``rank``, row-major over the axes."""
        out, rest = {}, int(rank)
        for a in reversed(self.axis_names):
            out[a] = rest % self.shape[a]
            rest //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        """The rank at ``coords`` (row-major over the axes)."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + int(coords.get(a, 0))
        return r

    def line_ranks(self, rank: int, axes: Tuple[str, ...]) -> List[int]:
        """The ranks that share ``rank``'s coordinates on every axis not in
        ``axes``, in row-major order over ``axes`` (mesh order): the
        members of its group over ``axes``."""
        axes = tuple(a for a in self.axis_names if a in axes)
        base = self.coords(rank)
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(base)
            c.update(zip(axes, idx))
            out.append(self.rank_of(c))
        return out

    def line_group(self, rank: int, axes: Tuple[str, ...], tag: str = ""):
        """(the process group over ``axes`` that ``rank`` belongs to, its
        member ranks); the group is None (the default group) when
        ``axes`` covers the whole mesh.  Each ``tag`` names a set of
        groups of its own over the same lines (the gradient-sync
        workers' is ``"sync"``)."""
        axes = tuple(a for a in self.axis_names if a in axes)
        members = self.line_ranks(rank, axes)
        if len(axes) == len(self.axis_names):
            return None, members
        return _line_groups(self, tag)[axes][tuple(members)], members

    def __repr__(self):
        return f"ProcessMesh({self.shape})"


#: (default group, axis names, sizes, tag) -> {axes: {member ranks: group}}
_GROUPS: Dict[Any, Dict[Tuple[str, ...], Dict[Tuple[int, ...], Any]]] = {}


def _line_groups(mesh: ProcessMesh, tag: str = ""):
    """Every line group of ``mesh``'s shape, created once a process group
    and tag: for each proper subset of the axes (by size, in mesh order)
    each of its lines, in row-major order of the other axes'
    coordinates.  Every rank runs this same sequence of ``new_group``
    calls."""
    import torch.distributed as dist
    key = (id(dist.group.WORLD), mesh.axis_names,
           tuple(mesh.shape[a] for a in mesh.axis_names), tag)
    groups = _GROUPS.get(key)
    if groups is not None:
        return groups
    groups = {}
    names = mesh.axis_names
    for k in range(1, len(names)):
        for axes in itertools.combinations(names, k):
            others = [a for a in names if a not in axes]
            lines = {}
            for idx in itertools.product(*(range(mesh.shape[a])
                                           for a in others)):
                base = mesh.rank_of(dict(zip(others, idx)))
                members = tuple(mesh.line_ranks(base, axes))
                lines[members] = dist.new_group(list(members))
            groups[axes] = lines
    _GROUPS[key] = groups
    return groups


class MeshLayout:
    """Named mesh axes with sizes — data / fsdp / tp (+ extras): the
    canonical, device-free description of one sharding configuration."""

    def __init__(self, data: int = 1, fsdp: int = 1, tp: int = 1,
                 pipe: int = 1, expert: int = 1,
                 extra_axes: Optional[Dict[str, int]] = None,
                 data_axis: str = DATA_AXIS, fsdp_axis: str = FSDP_AXIS,
                 tp_axis: str = TP_AXIS, pipe_axis: str = PIPE_AXIS,
                 expert_axis: str = EXPERT_AXIS):
        self.data_axis, self.fsdp_axis, self.tp_axis = \
            data_axis, fsdp_axis, tp_axis
        self.pipe_axis = pipe_axis
        self.expert_axis = expert_axis
        self._sizes: Dict[str, int] = {data_axis: int(data),
                                       fsdp_axis: int(fsdp),
                                       tp_axis: int(tp)}
        # the pipe and expert axes join the layout only when real, so a
        # layout without them keeps the (data, fsdp, tp) sizes dict
        if int(pipe) != 1:
            self._sizes[pipe_axis] = int(pipe)
        if int(expert) != 1:
            self._sizes[expert_axis] = int(expert)
        for k, v in (extra_axes or {}).items():
            self._sizes[str(k)] = int(v)
        for name, size in self._sizes.items():
            if size < 1:
                raise ValueError(f"MeshLayout axis {name!r}: size {size} < 1")

    # -- queries ---------------------------------------------------------
    @property
    def data(self) -> int:
        return self._sizes[self.data_axis]

    @property
    def fsdp(self) -> int:
        return self._sizes[self.fsdp_axis]

    @property
    def tp(self) -> int:
        return self._sizes[self.tp_axis]

    @property
    def pipe(self) -> int:
        return self._sizes.get(self.pipe_axis, 1)

    @property
    def expert(self) -> int:
        return self._sizes.get(self.expert_axis, 1)

    @property
    def sizes(self) -> Dict[str, int]:
        """{axis name: size} — every axis, size-1 included."""
        return dict(self._sizes)

    @property
    def mesh_axes(self) -> Dict[str, int]:
        """{axis name: size} of the axes that physically exist (> 1)."""
        return {a: n for a, n in self._sizes.items() if n > 1}

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self._sizes.values():
            n *= s
        return n

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._sizes)

    def __contains__(self, axis: str) -> bool:
        return axis in self._sizes

    def size(self, axis: str) -> int:
        return int(self._sizes.get(axis, 1))

    @property
    def batch_axes(self):
        """The axes the global batch shards over (data + fsdp + expert),
        squeezed: a plain string when one axis is real, a tuple when
        several, None when there is none."""
        axes = tuple(a for a in (self.data_axis, self.fsdp_axis,
                                 self.expert_axis)
                     if self._sizes.get(a, 1) > 1)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes

    # -- spec construction ----------------------------------------------
    def spec(self, *entries) -> ShardSpec:
        """A :class:`ShardSpec` validated against this layout's axes."""
        s = ShardSpec(entries)
        for a in s.axes:
            if a not in self._sizes:
                raise ValueError(
                    f"spec axis {a!r} is not in mesh layout "
                    f"{self.axis_names}")
        return s

    def spec_shards(self, spec, ndim: Optional[int] = None
                    ) -> Tuple[int, ...]:
        """Per-dim shard counts a :class:`ShardSpec` induces under this
        layout (axes absent from the layout, or at size 1, do not shard):
        the geometry the resharding planner (framework/reshard.py) diffs
        between a checkpoint's layout and the restore's."""
        entries = tuple(spec) if spec is not None else ()
        n = len(entries) if ndim is None else int(ndim)
        out = [1] * n
        for d, entry in enumerate(entries[:n]):
            parts = 1
            for a in _flat_axes((entry,)):
                parts *= self._sizes.get(a, 1)
            out[d] = parts
        return tuple(out)

    # -- materialisation -------------------------------------------------
    def check_ported(self):
        """Raise :class:`UnimplementedError` naming each axis above size 1
        that the port has not: any extra axis but :data:`SEQ_AXIS`, the
        pipe axis beside the fsdp, tensor or sequence axis, or the expert
        axis beside the tensor, sequence or pipe axis, or the data,
        fsdp, tensor and sequence axes all at once.  The data, fsdp,
        tensor, sequence, pipe and expert axes pass, and so does fsdp
        beside any two of data, tensor and sequence."""
        axes = self.mesh_axes
        check_ported_axes(axes, "mesh layout",
                          (self.data_axis, self.fsdp_axis, self.tp_axis,
                           SEQ_AXIS, self.pipe_axis, self.expert_axis))
        check_pipe_beside(axes, "mesh layout", self.pipe_axis)
        check_expert_beside(axes, "mesh layout", self.expert_axis,
                            self.pipe_axis, self.tp_axis)
        check_fsdp_beside(axes, "mesh layout", self.data_axis,
                          self.fsdp_axis, self.tp_axis)

    def build_mesh(self, devices=None) -> Optional[ProcessMesh]:
        """The :class:`ProcessMesh` over the squeezed axes (size-1 axes
        dropped), or None for a single-device layout.  The process group
        must have as many ranks as the layout has devices (``devices``
        is the JAX package's keyword; one process drives one device, so
        it is not read)."""
        self.check_ported()
        real = [(a, n) for a, n in self._sizes.items() if n > 1]
        if not real:
            return None
        import torch.distributed as dist
        world = dist.get_world_size() if dist.is_available() and \
            dist.is_initialized() else 1
        if world != self.num_devices:
            raise ValueError(
                f"mesh layout {self.sizes} needs {self.num_devices} "
                f"ranks, the process group has {world}")
        return ProcessMesh(tuple(a for a, _ in real),
                           tuple(n for _, n in real))

    # -- serialization ---------------------------------------------------
    def to_desc(self) -> Dict[str, Any]:
        return {"axes": [[a, int(n)] for a, n in self._sizes.items()],
                "data_axis": self.data_axis, "fsdp_axis": self.fsdp_axis,
                "tp_axis": self.tp_axis, "pipe_axis": self.pipe_axis,
                "expert_axis": self.expert_axis}

    @classmethod
    def from_desc(cls, d) -> Optional["MeshLayout"]:
        if d is None:
            return None
        axes = dict((a, int(n)) for a, n in d.get("axes", []))
        da = d.get("data_axis", DATA_AXIS)
        fa = d.get("fsdp_axis", FSDP_AXIS)
        ta = d.get("tp_axis", TP_AXIS)
        pa = d.get("pipe_axis", PIPE_AXIS)
        ea = d.get("expert_axis", EXPERT_AXIS)
        extra = {a: n for a, n in axes.items()
                 if a not in (da, fa, ta, pa, ea)}
        return cls(data=axes.get(da, 1), fsdp=axes.get(fa, 1),
                   tp=axes.get(ta, 1), pipe=axes.get(pa, 1),
                   expert=axes.get(ea, 1), extra_axes=extra,
                   data_axis=da, fsdp_axis=fa, tp_axis=ta, pipe_axis=pa,
                   expert_axis=ea)

    def __eq__(self, other):
        return isinstance(other, MeshLayout) and \
            self._sizes == other._sizes and \
            (self.data_axis, self.fsdp_axis, self.tp_axis,
             self.pipe_axis, self.expert_axis) == \
            (other.data_axis, other.fsdp_axis, other.tp_axis,
             other.pipe_axis, other.expert_axis)

    def __hash__(self):
        return hash((tuple(self._sizes.items()), self.data_axis,
                     self.fsdp_axis, self.tp_axis, self.pipe_axis,
                     self.expert_axis))

    def __repr__(self):
        return f"MeshLayout({self._sizes})"


__all__ = ["ShardSpec", "MeshLayout", "ProcessMesh", "DATA_AXIS",
           "FSDP_AXIS", "TP_AXIS", "PIPE_AXIS", "EXPERT_AXIS", "SEQ_AXIS",
           "PORTED_AXES", "check_ported_axes", "check_pipe_beside",
           "check_expert_beside", "check_fsdp_beside",
           "_flat_axes"]
