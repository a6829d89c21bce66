"""Persistence — the port of paddle_tpu/io.py, on the same on-disk format:
a saved inference model is a directory holding ``__model__`` (JSON: the
versioned program desc + feed/fetch names) and ``params.npz`` (every
persistable as a numpy array), and a checkpoint (format v2) is a
``checkpoint_<epoch>`` directory holding ``params.npz``,
``train_status.json`` and ``ckpt_manifest.json`` (the format version, the
source layout and a sha256 per file, written last).  A directory written
by either package loads in the other.

:func:`convert_params` is the one door by which parameters enter the
port from numpy — the arrays the JAX package keeps in its scope or writes
to ``params.npz`` — and every load goes through it.

Random state stays with its package.  The JAX package writes its key to
``rng.npy``; the port writes the states of its scope's
``torch.Generator`` objects to ``torch_rng.npz`` and never writes ``rng.npy``.
Each loader reads only its own file, so a resumed port run continues its
own random stream exactly, and one resumed from a JAX checkpoint keeps
the program-seeded generator.

ZeRO and HSDP state (a program whose persistables carry a ``dist_attr``
over the run's axes: ZeRO-1's flat optimizer shards, ZeRO-3's and HSDP's
parameters and moments) saves two ways.  Whole (``save_checkpoint``):
every rank calls the saver, the blocks are gathered
(``collective_ops.whole_of``), and rank 0 writes the global arrays.
Sharded (``save_checkpoint(sharded=True)``, ``save_persistables_sharded``,
``AsyncCheckpointer``): nothing is gathered, each rank writes the blocks it
holds with their global offsets (a block replicated over an axis once).
Both carry the JAX package's v2 manifest (the layout, per-var
``ShardSpec``, ZeRO-1 flat-shard metadata from
``framework/reshard.flat_shard_meta``), so either package loads the
other's checkpoints.  A restore onto another layout is planned, verified
and executed on the host (``framework/reshard.py``), and under a process
group each rank reads only the rows of the blocks it keeps
(``collective_ops.block_of``); an expert-sharded state (``ep``) saves
each expert block once and restores onto another expert layout through
the same dim-0 plan.  A restore that changes a tensor, sequence or pipe
layout, and a layout the port does not run, raise
``UnimplementedError``.  The JAX loader's
flight-recorder and ``monitor.stat`` hooks wait for the port's
observability layer."""

from __future__ import annotations

import hashlib
import io as _io
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .flags import flag
from .framework.core import Program, Variable, default_main_program
from .framework.errors import InvalidArgumentError, UnimplementedError
from .framework.executor import (Scope, global_scope, _RNG_VAR,
                                 sync_prepared_state)
from .framework.analysis import verify_reshard
from .framework.mesh_layout import (MeshLayout, ProcessMesh, ShardSpec,
                                    _flat_axes)
from .framework.reshard import execute_reshard, flat_shard_meta, plan_reshard
from .ops.collective_ops import (MeshGroups, _sharding, block_of,
                                 sharded_group, whole_of)

#: checkpoint format v2: content-hashed manifests (``ckpt_manifest.json``)
#: detect a corrupt or partial checkpoint; the layout stamp is one device's
CKPT_FORMAT_VERSION = 2
MANIFEST_FILE = "ckpt_manifest.json"
#: the port's random state in a checkpoint: every generator of the scope
#: (``_RNG_VAR`` and a data-parallel rank's), ``get_state()`` bytes by name
TORCH_RNG_FILE = "torch_rng.npz"


def _is_two_byte_record(a: np.ndarray) -> bool:
    """A ``|V2`` array: how ``np.load`` returns a bfloat16 array that the
    JAX package (or :func:`save_persistables`) wrote to an npz file."""
    return a.dtype.kind == "V" and a.dtype.itemsize == 2 and \
        a.dtype.name != "bfloat16"


def convert_params(arrays: Dict[str, np.ndarray], device,
                   dtypes: Optional[Dict[str, str]] = None
                   ) -> Dict[str, torch.Tensor]:
    """numpy arrays → tensors on ``device``, values and dtypes unchanged
    (int64 stays int64; a bfloat16 array, as JAX keeps it, becomes
    torch.bfloat16 bit for bit).  A ``|V2`` record array, as ``np.load``
    returns a bfloat16 array from an npz file, becomes torch.bfloat16 when
    ``dtypes`` (var name → the program's dtype) says the var is
    bfloat16, and raises TypeError otherwise."""
    device = torch.device(device)
    dtypes = dtypes or {}
    out = {}
    for name, a in arrays.items():
        # a private copy: the array may be read-only (JAX's are), and a CPU
        # tensor would otherwise alias it
        a = np.array(a, order="C")
        if _is_two_byte_record(a) and dtypes.get(name) != "bfloat16":
            raise TypeError(
                f"convert_params: {name!r} is a 2-byte record array "
                f"({a.dtype.str}) but the program declares it "
                f"{dtypes.get(name, 'nothing')}; only a bfloat16 var is "
                f"read from 2-byte records")
        if a.dtype.name == "bfloat16" or _is_two_byte_record(a):
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[name] = t.to(device)
    return out


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return "sha256:" + h.hexdigest()


class ChecksumMismatchError(OSError):
    """A just-written checkpoint file read back with the wrong content hash
    (bit rot, a torn write).  An OSError, so :func:`_retry_io` retries the
    write like any transient IO fault."""


def _retry_io(what: str, fn):
    """Run a checkpoint file operation, retrying a transient OSError with
    bounded exponential backoff (``flag("checkpoint_retries")`` attempts
    after the first, ``flag("checkpoint_retry_backoff_s")`` doubling up
    to 2 s).  Any other error propagates at once."""
    retries = int(flag("checkpoint_retries") or 0)
    base = float(flag("checkpoint_retry_backoff_s") or 0.05)
    attempt = 0
    while True:
        try:
            return fn()
        except OSError:
            attempt += 1
            if attempt > retries:
                raise
            time.sleep(min(base * (2 ** (attempt - 1)), 2.0))


def _verified_write(what: str, path: str, data):
    """Write ``data`` (bytes, or a callable that makes them anew for each
    attempt) to ``path`` and read the file back: a content hash other than
    the bytes' raises :class:`ChecksumMismatchError`, which
    :func:`_retry_io` turns into another attempt."""
    data_fn = data if callable(data) else (lambda: data)

    def w():
        payload = data_fn()
        expect = "sha256:" + hashlib.sha256(payload).hexdigest()
        with open(path, "wb") as f:
            f.write(payload)
        got = _sha256(path)
        if got != expect:
            raise ChecksumMismatchError(
                f"checkpoint file {path!r} ({what}) failed readback "
                f"verification: wrote {expect}, read {got}")

    _retry_io(what, w)


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _to_numpy(v) -> np.ndarray:
    """A scope value as the npz file holds it: a bfloat16 tensor as 2-byte
    records (``|V2``, its bits unchanged), as the JAX package writes one."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view("V2")
        return v.numpy()
    return np.asarray(v)


def _persistable_names(program: Program) -> List[str]:
    return [v.name for v in program.list_vars()
            if v.persistable and v.name != _RNG_VAR]


def _group(program):
    """The process group ``program``'s sharded persistables live over, or
    None: a program of replicated persistables saves and loads on each
    rank alone, as without a group (``if rank == 0: save(...)``)."""
    return sharded_group(program) if program is not None else None


def _is_writer(dp) -> bool:
    return dp is None or dp.rank == 0


def _barrier(dp):
    """Under a sharded program's group, every rank waits for rank 0's
    files before it returns."""
    if dp is not None:
        import torch.distributed as dist
        dist.barrier(group=dp.group)


def save_persistables(executor, dirname,
                      main_program: Optional[Program] = None,
                      filename: Optional[str] = None,
                      scope: Optional[Scope] = None):
    """Save every persistable var of the program to one npz file (the
    current values: a donated prepared step's state is synced first).
    When the program holds sharded persistables every rank calls it (a
    collective): their blocks are gathered to the global values, and rank
    0 writes.  Any other program saves from whichever rank calls it."""
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    sync_prepared_state(scope)
    dp = _group(main_program)
    block = main_program.global_block()
    arrays = {}
    for name in _persistable_names(main_program):
        v = scope.find_var(name)
        if v is not None:
            arrays[name] = _to_numpy(whole_of(
                dp, block._find_var_recursive(name), v))
    if _is_writer(dp):
        os.makedirs(dirname, exist_ok=True)
        _verified_write("params", os.path.join(dirname,
                                               filename or "params.npz"),
                        lambda: _npz_bytes(arrays))
    _barrier(dp)


def _set_loaded(scope: Scope, program: Optional[Program],
                tensors: Dict[str, torch.Tensor], device=None):
    """Loaded global values into ``scope`` on ``device`` (where they are,
    when None), each sharded persistable as this rank's block, cut before
    it moves."""
    dp = _group(program)
    block = program.global_block() if program is not None else None
    for name, t in tensors.items():
        var = block._find_var_recursive(name) if block is not None else None
        t = block_of(dp, var, t)
        scope.set_var(name, t if device is None else t.to(device))


def load_persistables(executor, dirname,
                      main_program: Optional[Program] = None,
                      filename: Optional[str] = None,
                      scope: Optional[Scope] = None):
    """Load the program's persistables from an npz file onto the
    executor's device; a bfloat16 var's 2-byte records come back as
    torch.bfloat16."""
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    path = os.path.join(dirname, filename or "params.npz")
    wanted = set(_persistable_names(main_program))
    with np.load(path) as data:
        arrays = {n: data[n] for n in data.files if n in wanted}
    dtypes = {v.name: v.dtype for v in main_program.list_vars()
              if v.name in arrays}
    _set_loaded(scope, main_program, convert_params(arrays, "cpu", dtypes),
                executor.device)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program: Optional[Program] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         scope: Optional[Scope] = None):
    """Prune the program to the inference subgraph and save program +
    params (ref: io.py save_inference_model)."""
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    pruned = main_program.clone(for_test=True)._prune(target_vars)
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "feed_names": list(feeded_var_names),
        "fetch_names": [v.name if isinstance(v, Variable) else str(v)
                        for v in target_vars],
    }
    from .framework.serialization import program_to_desc
    payload = {"program_desc": program_to_desc(pruned), "meta": meta}
    with open(os.path.join(dirname, model_filename or "__model__"),
              "w") as f:
        json.dump(payload, f)
    save_persistables(executor, dirname, pruned,
                      params_filename or "params.npz", scope)
    return meta["fetch_names"]


def load_inference_model(dirname, executor,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         scope: Optional[Scope] = None):
    """Returns (program, feed_names, fetch_vars); the parameters land in
    ``scope`` on the executor's device."""
    scope = scope or global_scope()
    with open(os.path.join(dirname, model_filename or "__model__")) as f:
        payload = json.load(f)
    from .framework.serialization import desc_to_program
    program = desc_to_program(payload["program_desc"])
    meta = payload["meta"]
    load_persistables(executor, dirname, program,
                      params_filename or "params.npz", scope)
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


# aliases of the reference's finer-grained savers (parameters and
# persistables differ only by the optimizer's accumulators; both live in
# the scope)
def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    save_persistables(executor, dirname, main_program, filename, scope)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    load_persistables(executor, dirname, main_program, filename, scope)


# ---------------------------------------------------------------------------
# checkpoint v2 with TrainStatus (ref: incubate/fleet/collective:49,236)
# ---------------------------------------------------------------------------


def _refuse_unported_layout(what: str, layout):
    """A layout (a ``MeshLayout`` or its desc) the port does not run (an
    unknown extra axis above size 1, or axes beside each other the port
    does not combine) is refused by name (``MeshLayout.check_ported``)."""
    if isinstance(layout, dict):
        layout = MeshLayout.from_desc(layout)
    if isinstance(layout, MeshLayout):
        try:
            layout.check_ported()
        except UnimplementedError as e:
            raise UnimplementedError(f"{what}: {e}") from None


def _spec_desc(da) -> List:
    """JSON-able spelling of a dist_attr (tuples -> lists)."""
    return [list(e) if isinstance(e, (tuple, list)) else e
            for e in tuple(da)]


def _layout_view(main_program: Optional[Program], layout=None):
    """(mesh layout, per-var shard specs, ZeRO-1 flat metadata): the
    layout stamp of the v2 manifest, as the JAX package writes it."""
    specs: Dict[str, List] = {}
    flat: Dict[str, Dict] = {}
    if main_program is not None:
        layout = layout or getattr(main_program, "_mesh_layout", None)
        if not isinstance(layout, MeshLayout):
            layout = None
        block = main_program.global_block()
        for v in main_program.list_vars():
            if v.persistable and getattr(v, "dist_attr", None):
                specs[v.name] = _spec_desc(v.dist_attr)
        for name, rec in flat_shard_meta(main_program).items():
            rec = dict(rec)
            v = block.vars.get(name)
            if v is not None and len(tuple(v.shape)) == 1:
                rec["pad"] = int(v.shape[0])
            if layout is not None:
                n = 1
                for a in rec.get("axes") or ():
                    n *= layout.size(a)
                rec["n"] = max(int(n), 1)
            flat[name] = rec
    return layout, specs, flat


def _manifest_dict(layout=None, specs=None, flat=None) -> Dict[str, Any]:
    """The JAX package's v2 manifest keys: the layout stamp, the shard
    specs and the ZeRO flat metadata."""
    return {"format_version": CKPT_FORMAT_VERSION,
            "mesh_layout": layout.to_desc() if layout is not None else None,
            "shard_specs": dict(specs or {}), "flat_meta": dict(flat or {}),
            "rng_vars": [_RNG_VAR], "files": {}}


def _write_manifest(d: str, main_program: Optional[Program] = None,
                    layout=None, manifest: Optional[Dict] = None):
    """Write ``ckpt_manifest.json`` last (a temporary file, then an atomic
    rename), with a content hash per file of the checkpoint: a torn save is
    detectable, and restore falls back to the newest checkpoint whose
    hashes verify."""
    if manifest is None:
        manifest = _manifest_dict(*_layout_view(main_program, layout))
    manifest = dict(manifest)
    files = {}
    for fn in sorted(os.listdir(d)):
        p = os.path.join(d, fn)
        if fn == MANIFEST_FILE or fn.startswith(".") or \
                not os.path.isfile(p):
            continue
        files[fn] = _retry_io("hash", lambda p=p: _sha256(p))
    manifest["files"] = files
    tmp = os.path.join(d, "." + MANIFEST_FILE + ".tmp")
    _verified_write("manifest", tmp, json.dumps(manifest).encode())
    _retry_io("manifest",
              lambda: os.replace(tmp, os.path.join(d, MANIFEST_FILE)))
    return manifest


def _read_manifest(d: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(d, MANIFEST_FILE)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def validate_checkpoint_dir(d: str) -> Tuple[bool, str]:
    """(loadable, reason): every file the v2 manifest lists exists and has
    its content hash; a checkpoint without a manifest (v1) is loadable but
    unverifiable as long as its core files exist."""
    man = _read_manifest(d)
    if man is None:
        if not os.path.exists(os.path.join(d, "train_status.json")):
            return False, "missing:train_status.json"
        has_params = os.path.exists(os.path.join(d, "params.npz")) or \
            any(n.startswith("shard_manifest_") for n in os.listdir(d))
        return (True, "no-manifest") if has_params \
            else (False, "missing:params")
    for fn, want in (man.get("files") or {}).items():
        p = os.path.join(d, fn)
        if not os.path.exists(p):
            return False, f"missing:{fn}"
        try:
            got = _sha256(p)
        except OSError as e:
            return False, f"unreadable:{fn}:{e!r}"
        if got != want:
            return False, f"hash-mismatch:{fn}"
    return True, "ok"


class TrainStatus:
    def __init__(self, epoch_no: int = -1, step: int = 0):
        self.epoch_no = epoch_no
        self.step = step

    def next(self):
        return self.epoch_no + 1

    def to_dict(self):
        return {"epoch_no": self.epoch_no, "step": self.step}

    @staticmethod
    def from_dict(d):
        return TrainStatus(d.get("epoch_no", -1), d.get("step", 0))

    def __eq__(self, other):
        return isinstance(other, TrainStatus) and \
            self.to_dict() == other.to_dict()


def _generator_states(scope: Scope) -> Dict[str, np.ndarray]:
    """The scope's random streams (``_RNG_VAR``, and a data-parallel
    rank's ``_RNG_VAR/rank<r>``) as ``get_state()`` bytes."""
    return {n: g.get_state().numpy().copy() for n, g in scope.vars.items()
            if n.startswith(_RNG_VAR) and isinstance(g, torch.Generator)}


def _all_generator_states(scope: Scope, dp=None) -> Dict[str, np.ndarray]:
    """:func:`_generator_states`; under a process group every rank's (a
    collective: every rank calls it)."""
    states = _generator_states(scope)
    if dp is None:
        return states
    import torch.distributed as dist
    every = [None] * dp.world
    dist.all_gather_object(every, states, group=dp.group)
    merged: Dict[str, np.ndarray] = {}
    for r in every:
        merged.update(r)
    return merged


def _rank(dp) -> int:
    """This process's global rank under the groups ``dp`` (0 without)."""
    return dp.rank if dp is not None else 0


def _rng_file(dp) -> str:
    """The generator-state file of this rank: one a rank in a sharded
    checkpoint written under a group."""
    return TORCH_RNG_FILE if dp is None else f"torch_rng_{dp.rank}.npz"


def save_checkpoint(executor, path, train_status: TrainStatus,
                    main_program: Optional[Program] = None,
                    scope: Optional[Scope] = None,
                    remain_all_checkpoint=False, max_checkpoints: int = 3,
                    sharded: bool = False, layout=None):
    """Checkpoint ``checkpoint_<epoch_no>`` under ``path``: the program's
    persistables (a live donated prepared step's current state, synced
    first), the port's generator states, the TrainStatus and the v2
    manifest, written last; keeps the newest ``max_checkpoints`` unless
    ``remain_all_checkpoint``.  ``layout`` overrides the program's
    ``_mesh_layout`` as the recorded source layout.  Returns the
    directory.

    Whole (``sharded=False``): when the program holds sharded persistables
    every rank calls it, the blocks are gathered, and rank 0 writes the
    global arrays and every rank's generator states
    (:data:`TORCH_RNG_FILE`); any other program saves from whichever rank
    calls it.  ``sharded=True`` writes per-process shard files
    (:func:`save_persistables_sharded`): nothing is gathered, each rank
    writes its own blocks and its generators (``torch_rng_<rank>.npz``),
    and rank 0 writes the TrainStatus and the manifest once every rank's
    files are down."""
    scope = scope or global_scope()
    main_program = main_program or default_main_program()
    _refuse_unported_layout("save_checkpoint", layout)
    sync_prepared_state(scope)
    dp = _group(main_program)
    d = os.path.join(path, f"checkpoint_{train_status.epoch_no}")
    if sharded:
        if _is_writer(dp):
            _clear_shard_files(d)
        _barrier(dp)
        _write_shards(d, main_program, scope, dp, layout)
        _verified_write("rng", os.path.join(d, _rng_file(dp)),
                        lambda: _npz_bytes(_generator_states(scope)))
        _barrier(dp)
    else:
        save_persistables(executor, d, main_program, scope=scope)
        states = _all_generator_states(scope, dp)
        if _is_writer(dp) and states:
            _verified_write("rng", os.path.join(d, TORCH_RNG_FILE),
                            lambda: _npz_bytes(states))
    if _is_writer(dp):
        _verified_write("train_status",
                        os.path.join(d, "train_status.json"),
                        json.dumps(train_status.to_dict()).encode())
        _write_manifest(d, main_program, layout=layout)
        if not remain_all_checkpoint:
            _cleanup_stale(path, max_checkpoints)
    _barrier(dp)
    return d


def _clear_shard_files(d: str):
    """Drop an earlier save's per-process files and manifest from ``d``
    (a re-save of the same id by another number of ranks must not leave a
    rank's stale blocks behind)."""
    if not os.path.isdir(d):
        os.makedirs(d, exist_ok=True)
        return
    for fn in os.listdir(d):
        if fn.startswith(("shard_data_", "shard_manifest_", "torch_rng")) \
                or fn == MANIFEST_FILE:
            os.remove(os.path.join(d, fn))


def _list_checkpoints(path):
    """[(epoch, dir)] of ``path``'s checkpoints, oldest first; a
    ``checkpoint_<n>.old`` staging dir of an interrupted same-id re-save
    stands in for ``checkpoint_<n>`` when that one is missing."""
    if not os.path.isdir(path):
        return []
    out, aside = {}, {}
    for n in os.listdir(path):
        if not n.startswith("checkpoint_"):
            continue
        tail = n.split("_")[1]
        if tail.endswith(".old"):
            try:
                aside[int(tail[:-4])] = os.path.join(path, n)
            except ValueError:
                pass
            continue
        try:
            out[int(tail)] = os.path.join(path, n)
        except ValueError:
            pass
    for cid, d in aside.items():
        out.setdefault(cid, d)
    return sorted(out.items())


def _cleanup_stale(path, keep):
    for _, d in _list_checkpoints(path)[:-keep] if keep else []:
        shutil.rmtree(d, ignore_errors=True)
    # staging dirs whose final checkpoint landed
    for n in os.listdir(path) if os.path.isdir(path) else []:
        if n.startswith("checkpoint_") and n.endswith(".old") and \
                os.path.isdir(os.path.join(path, n[:-4])):
            shutil.rmtree(os.path.join(path, n), ignore_errors=True)


def _check_restore_shapes(program: Program, arrays: Dict[str, np.ndarray]):
    """A restored array whose shape is not the program's declared one fails
    here, naming the var, not deep in the executor."""
    block = program.global_block()
    for name, arr in arrays.items():
        v = block._find_var_recursive(name)
        if v is None:
            continue
        want = tuple(int(n) for n in v.shape)
        got = tuple(int(n) for n in np.shape(arr))
        if want and -1 not in want and want != got:
            raise InvalidArgumentError(
                f"load_checkpoint: restored persistable {name!r} has shape "
                f"{got} but the program declares {want}")


def _layout_name(layout) -> str:
    return repr(dict(layout.sizes)) if layout is not None else "<unstamped>"


def _spec_from_desc(d):
    if d is None:
        return None
    return ShardSpec(tuple(tuple(e) if isinstance(e, list) else e
                           for e in d))


def _dst_layout(program: Optional[Program], dst_layout=None):
    """The layout a restore lands on: ``dst_layout``, else the program's
    ``_mesh_layout``."""
    if dst_layout is None and program is not None:
        dst_layout = getattr(program, "_mesh_layout", None)
    return dst_layout


def _refuse_pipe_reshard(manifest: Optional[Dict],
                         program: Optional[Program], dst_layout):
    """A restore onto another layout than the checkpoint's that changes
    the pipe axis is refused by name: the reshard of pipe-sharded blocks
    is not ported yet (restore onto the same (dp, pp) layout).  A change
    of the data, fsdp, tensor or sequence layout reshards."""
    src = MeshLayout.from_desc((manifest or {}).get("mesh_layout"))
    dst = _dst_layout(program, dst_layout)
    if isinstance(dst, dict):
        dst = MeshLayout.from_desc(dst)
    if src is None or dst is None or src.pipe == dst.pipe:
        return
    raise UnimplementedError(
        f"load_checkpoint: restoring a checkpoint written under "
        f"{_layout_name(src)} onto {_layout_name(dst)} changes the "
        f"pipe layout (pp {src.pipe} -> {dst.pipe}); a restore across "
        f"pipe layouts is not ported yet — restore onto the same "
        f"(dp, pp) layout")


def _maybe_reshard(arrays: Dict[str, np.ndarray], manifest: Optional[Dict],
                   program: Optional[Program], dst_layout, reshard: bool
                   ) -> Tuple[Dict[str, np.ndarray], Optional[Dict]]:
    """Reshard restored host arrays onto the destination layout when the
    checkpoint was written under another one (framework/reshard.py: plan,
    verify, execute; no device work) — the JAX package's rule: the layouts
    differ, or a ZeRO-1 flat state's pad differs from the program's."""
    manifest = manifest or {}
    src_layout = MeshLayout.from_desc(manifest.get("mesh_layout"))
    dst_layout = _dst_layout(program, dst_layout)
    src_specs = {k: _spec_from_desc(v)
                 for k, v in (manifest.get("shard_specs") or {}).items()}
    src_flat = manifest.get("flat_meta") or {}
    dst_specs: Dict[str, Any] = {}
    dst_flat: Dict[str, Dict] = {}
    block = program.global_block() if program is not None else None
    if program is not None:
        for v in program.list_vars():
            if v.persistable and getattr(v, "dist_attr", None):
                dst_specs[v.name] = v.dist_attr
        dst_flat = flat_shard_meta(program)
    flat_meta: Dict[str, Dict] = {}
    for name, rec in src_flat.items():
        if name not in arrays:
            continue
        dv = block.vars.get(name) if block is not None else None
        dst_pad = int(dv.shape[0]) if dv is not None and \
            len(tuple(dv.shape)) == 1 else None
        dst_rec = dst_flat.get(name) or {}
        n_dst = None
        if dst_layout is not None:
            n_dst = 1
            for a in (dst_rec.get("axes") or rec.get("axes") or ()):
                n_dst *= dst_layout.size(a)
            n_dst = max(int(n_dst), 1)
        if dst_pad is None:
            continue             # not a var of the program: passes through
        flat_meta[name] = {
            "numel": rec["numel"],
            "align": dst_rec.get("align", rec.get("align", 1)),
            "axes": rec.get("axes"),
            "src_pad": rec.get("pad") or int(arrays[name].shape[0]),
            "n_src": rec.get("n"), "dst_pad": dst_pad, "n_dst": n_dst}
    layouts_differ = (src_layout is not None and dst_layout is not None
                      and src_layout.sizes != dst_layout.sizes)
    flat_differs = any(f["src_pad"] != f["dst_pad"]
                       for f in flat_meta.values())
    if not layouts_differ and not flat_differs:
        return arrays, None
    if not reshard:
        raise InvalidArgumentError(
            f"load_checkpoint: checkpoint layout "
            f"{_layout_name(src_layout)} does not match the program's "
            f"layout {_layout_name(dst_layout)} and resharding is "
            f"disabled — restore onto the identical mesh or pass "
            f"reshard=True")
    var_sigs = {name: (tuple(int(n) for n in arr.shape), str(arr.dtype))
                for name, arr in arrays.items()}
    plan = plan_reshard(src_layout, dst_layout, var_sigs=var_sigs,
                        src_specs=src_specs,
                        dst_specs=dst_specs if dst_specs else None,
                        flat_meta=flat_meta, validate=False)
    res = verify_reshard(plan)
    if not res.ok:
        raise InvalidArgumentError(
            f"load_checkpoint: cannot reshard checkpoint layout "
            f"{_layout_name(src_layout)} onto program layout "
            f"{_layout_name(dst_layout)}:\n" + res.report())
    t0 = time.perf_counter_ns()
    out, stats = execute_reshard(plan, arrays)
    info = {"src_layout": src_layout.sizes if src_layout else None,
            "dst_layout": dst_layout.sizes if dst_layout else None,
            "wire_bytes": int(stats["wire_bytes"]),
            "vars_moved": int(stats["vars_moved"]),
            "steps_by_kind": plan.steps_by_kind(),
            "candidates_rejected": plan.candidates_rejected(),
            "compiles_attempted": plan.compiles_attempted,
            "execute_ns": time.perf_counter_ns() - t0,
            "plan": plan}
    return out, info


def _check_restore_shapes(program: Program, arrays: Dict[str, np.ndarray],
                          manifest: Optional[Dict] = None, dst_layout=None):
    """A restored array whose shape is not the program's declared one fails
    here, naming the var and both layouts, not deep in the executor."""
    src_layout = MeshLayout.from_desc((manifest or {}).get("mesh_layout"))
    dst_layout = _dst_layout(program, dst_layout)
    block = program.global_block()
    for name, arr in arrays.items():
        v = block._find_var_recursive(name)
        if v is None:
            continue
        want = tuple(int(n) for n in v.shape)
        got = tuple(int(n) for n in np.shape(arr))
        if want and -1 not in want and want != got:
            raise InvalidArgumentError(
                f"load_checkpoint: restored persistable {name!r} has shape "
                f"{got} but the program declares {want} — the checkpoint "
                f"was written under layout {_layout_name(src_layout)} and "
                f"does not fit the program's layout "
                f"{_layout_name(dst_layout)}")


def load_checkpoint(executor, path, trainer_id=0,
                    main_program: Optional[Program] = None,
                    scope: Optional[Scope] = None, dst_layout=None,
                    reshard: bool = True) -> TrainStatus:
    """Load the newest valid checkpoint under ``path`` onto the executor's
    device and return its TrainStatus (epoch -1 when there is none: a cold
    start).  A checkpoint whose manifest hashes do not verify is skipped,
    and the newest older valid one loads; the skipped ones are listed on
    the status as ``skipped_checkpoints`` (dir, reason) and the loaded one
    is ``restored_from``.  The scope's version moves, so a live prepared
    step pulls the restored state before its next run.  The port's
    generators continue from their saved states; a JAX checkpoint's
    ``rng.npy`` (a JAX key) is ignored and the scope keeps its
    program-seeded generator.

    A checkpoint written under another layout than the program's
    (``dst_layout``, else the program's ``_mesh_layout``) — another mesh,
    a ZeRO-1 flat pad of
    another world size — is resharded on the host (``st.reshard``: the
    plan's wire bytes and steps); with ``reshard=False`` it raises
    ``InvalidArgumentError``.  A sharded (per-process) checkpoint is
    reassembled by global offsets; under a process group each rank reads
    only the rows of the blocks it holds under the destination layout
    (``st.read_stats``: ``bytes_read`` against ``planned_bytes``).  Each
    rank keeps its block of every sharded persistable.  A layout the port
    does not run raises ``UnimplementedError``, and so does a restore
    that changes the pipe layout (one across data, fsdp, tensor and
    sequence layouts reshards)."""
    _refuse_unported_layout("load_checkpoint", dst_layout)
    scope = scope or global_scope()
    program = main_program if main_program is not None \
        else default_main_program()
    cks = _list_checkpoints(path)
    if not cks:
        st = TrainStatus(-1)
        st.skipped_checkpoints = []
        return st
    skipped: List[Dict[str, str]] = []
    chosen = None
    for _, d in reversed(cks):
        ok, reason = validate_checkpoint_dir(d)
        if ok:
            chosen = d
            break
        skipped.append({"dir": d, "reason": reason})
    if chosen is None:
        raise InvalidArgumentError(
            f"load_checkpoint: no valid checkpoint under {path!r} — "
            f"skipped {[(s['dir'], s['reason']) for s in skipped]}")
    st = _restore_dir(chosen, program, scope, dst_layout=dst_layout,
                      reshard=reshard, device=executor.device)
    st.skipped_checkpoints = skipped
    st.restored_from = chosen
    return st


def _restore_dir(d: str, program: Optional[Program], scope: Scope,
                 dst_layout=None, reshard: bool = True,
                 device=None) -> TrainStatus:
    """Set the checkpoint in ``d`` into ``scope`` on ``device``: its
    persistables (those of ``program``, all when None), resharded onto
    the program's layout where it differs, and the port's generator
    states; returns its TrainStatus."""
    manifest = _read_manifest(d) or {}
    _refuse_unported_layout("load_checkpoint (the checkpoint's stamp)",
                            manifest.get("mesh_layout"))
    _refuse_pipe_reshard(manifest, program, dst_layout)
    device = torch.device(device if device is not None else "cpu")
    wanted = set(_persistable_names(program)) if program is not None \
        else None
    sharded = any(n.startswith("shard_manifest_") for n in os.listdir(d))
    read_stats = None
    if sharded:
        read_stats = _new_read_stats()
        ranges = _planned_read_ranges(d, manifest, program, dst_layout,
                                      reshard)
        arrays = _read_sharded_arrays(d, wanted, row_ranges=ranges,
                                      read_stats=read_stats)
        read_stats["planned_bytes"] = _planned_bytes(d, wanted, ranges)
    else:
        arrays = _read_whole_arrays(d, wanted)
    arrays, info = _maybe_reshard(arrays, manifest, program, dst_layout,
                                  reshard)
    if program is not None:
        _check_restore_shapes(program, arrays, manifest, dst_layout)
        dtypes = {v.name: v.dtype for v in program.list_vars()
                  if v.name in arrays}
    else:
        dtypes = {}
    _set_loaded(scope, program, convert_params(arrays, "cpu", dtypes),
                device)
    for fn in sorted(os.listdir(d)):
        if fn == TORCH_RNG_FILE or (fn.startswith("torch_rng_") and
                                    fn.endswith(".npz")):
            with np.load(os.path.join(d, fn)) as data:
                for name in data.files:
                    g = torch.Generator(device=device)
                    g.set_state(torch.from_numpy(np.array(data[name])))
                    scope.vars[name] = g
    with open(os.path.join(d, "train_status.json")) as f:
        st = TrainStatus.from_dict(json.load(f))
    st.reshard = info
    st.read_stats = read_stats
    return st


def _read_whole_arrays(d: str, wanted=None,
                       filename: str = "params.npz"
                       ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    with np.load(os.path.join(d, filename)) as data:
        for name in data.files:
            if wanted is None or name in wanted:
                out[name] = np.array(data[name])
    return out


# ---------------------------------------------------------------------------
# per-process sharded checkpoints and the background writer
# ---------------------------------------------------------------------------


def _coords(dp) -> Dict[str, int]:
    """{axis: this rank's coordinate} under the groups ``dp``."""
    if isinstance(dp, MeshGroups):
        return dict(dp.coords)
    return {dp.axis_name: dp.rank}


def _dtype_name(t) -> str:
    """The manifest's dtype of a value (``bfloat16`` for a bfloat16
    tensor, whose npz member is 2-byte records)."""
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(_to_numpy(t).dtype) if isinstance(t, torch.Tensor) \
        else str(np.asarray(t).dtype)


def _rank_blocks(main_program: Program, scope: Scope, dp, copy=False):
    """(npz members, the manifest's ``vars``) of what this rank writes to
    its shard file: each block it holds of a sharded persistable (key
    ``<name>@<block>``, its global offsets), written by the ranks at
    coordinate 0 on the axes the block is replicated over; and each
    replicated persistable whole (``<name>@full``), written by rank 0.
    Without groups every persistable is written whole.  ``copy`` takes
    host copies a later in-place update cannot reach."""
    block = main_program.global_block()
    coords = _coords(dp) if dp is not None else {}
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {}
    for name in _persistable_names(main_program):
        t = scope.find_var(name)
        if t is None:
            continue
        var = block._find_var_recursive(name)
        sh = _sharding(dp, var)
        axes = _flat_axes(sh[1].axis_name) if sh is not None else ()
        if any(c for a, c in coords.items() if a not in axes):
            continue             # another rank writes this copy
        if sh is not None:
            t = block_of(dp, var, t)
        a = _to_numpy(t)
        if copy and (not isinstance(t, torch.Tensor) or
                     t.device.type == "cpu"):
            a = np.array(a)
        if sh is None:
            key, index = f"{name}@full", None
            shape = list(a.shape)
        else:
            d, g = sh
            rows = int(a.shape[d])
            key = f"{name}@{g.rank}"
            index = [[0, int(n)] for n in a.shape]
            index[d] = [g.rank * rows, (g.rank + 1) * rows]
            shape = [int(n) for n in a.shape]
            shape[d] = rows * g.world
        arrays[key] = a
        manifest[name] = {"shape": shape, "dtype": _dtype_name(t),
                          "shards": [{"key": key, "index": index}]}
    return arrays, manifest


def _shard_payload(main_program, manifest, layout=None) -> bytes:
    lay, specs, flat = _layout_view(main_program, layout)
    return json.dumps({"format_version": CKPT_FORMAT_VERSION,
                       "mesh_layout": lay.to_desc() if lay is not None
                       else None,
                       "shard_specs": specs, "flat_meta": flat,
                       "vars": manifest}).encode()


def _write_shards(dirname, main_program, scope, dp, layout=None):
    """This rank's ``shard_data_<rank>.npz`` and
    ``shard_manifest_<rank>.json`` (manifest schema v2: the layout stamp,
    the specs, ``flat_meta`` and the global offsets of each block)."""
    os.makedirs(dirname, exist_ok=True)
    p = _rank(dp)
    arrays, manifest = _rank_blocks(main_program, scope, dp)
    _verified_write("shard_data",
                    os.path.join(dirname, f"shard_data_{p}.npz"),
                    lambda: _npz_bytes(arrays))
    _verified_write("shard_manifest",
                    os.path.join(dirname, f"shard_manifest_{p}.json"),
                    _shard_payload(main_program, manifest, layout))


def save_persistables_sharded(executor, dirname,
                              main_program: Optional[Program] = None,
                              scope: Optional[Scope] = None, layout=None):
    """Each process writes only the blocks it holds, with their global
    offsets — nothing is gathered: ``shard_data_<rank>.npz`` and
    ``shard_manifest_<rank>.json`` (format v2: the source ``MeshLayout``,
    the per-var ``ShardSpec`` and the ZeRO-1 flat metadata, so a restore
    onto another layout can plan the reshard).  A block replicated over
    an axis is written once, by the ranks at coordinate 0 on it; a
    replicated persistable by rank 0.  Under the groups of a sharded
    program every rank calls it and it returns once every rank's files
    are down; any other program writes everything from the calling rank
    as process 0."""
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    _refuse_unported_layout("save_persistables_sharded", layout)
    sync_prepared_state(scope)
    dp = _group(main_program)
    _write_shards(dirname, main_program, scope, dp, layout)
    _barrier(dp)


def _manifest_var_sigs(d: str) -> Dict[str, Any]:
    """Global (shape, dtype) per persistable from the shard manifests —
    what a resharding restore plans from before it reads any array."""
    sigs: Dict[str, Any] = {}
    for fn in sorted(os.listdir(d)):
        if not fn.startswith("shard_manifest_"):
            continue
        with open(os.path.join(d, fn)) as f:
            m = json.load(f)
        for name, rec in (m.get("vars") or m).items():
            if isinstance(rec, dict) and "shape" in rec:
                sigs[name] = (tuple(int(n) for n in rec["shape"]),
                              str(rec["dtype"]))
    return sigs


def _rank_dst_blocks(plan, rank: int) -> Dict[str, list]:
    """{var: the dim-0 destination block} rank ``rank`` holds under the
    plan's destination layout: its row-major index over the axes that
    shard the var's dim 0 there (the flat axes of a ZeRO-1 state)."""
    layout = plan.dst_layout
    real = [(a, n) for a, n in (layout.sizes.items() if layout else ())
            if n > 1]
    if not real:
        return {}
    mesh = ProcessMesh(tuple(a for a, _ in real), tuple(n for _, n in real))
    coords = mesh.coords(rank)
    blocks: Dict[str, list] = {}
    for name, t in plan.transfers.items():
        if t.flat:
            dim0 = [a for a in (t.flat.get("axes") or ()) if a in coords]
        elif t.dst_spec is not None and tuple(t.dst_spec):
            dim0 = [a for a in _flat_axes((tuple(t.dst_spec)[0],))
                    if a in coords]
        else:
            continue
        if not dim0:
            continue
        b = 0
        for a in dim0:
            b = b * mesh.shape[a] + coords[a]
        blocks[name] = [b]
    return blocks


def _planned_read_ranges(d: str, manifest, program, dst_layout,
                         reshard: bool):
    """The global dim-0 rows this rank reads of each var: the rows of the
    blocks it holds under the destination layout, from the reshard plan
    (``ReshardPlan.dst_read_ranges``).  None (read everything) outside a
    process group of more than one rank, and whenever planning fails (a
    whole read costs bytes, never correctness)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() < 2 or not reshard or not manifest or \
            program is None:
        return None
    try:
        src_layout = MeshLayout.from_desc(manifest.get("mesh_layout"))
        dst = _dst_layout(program, dst_layout)
        if src_layout is None or dst is None:
            return None
        src_specs = {k: _spec_from_desc(v) for k, v in
                     (manifest.get("shard_specs") or {}).items()}
        dst_specs = {v.name: v.dist_attr for v in program.list_vars()
                     if v.persistable and getattr(v, "dist_attr", None)}
        plan = plan_reshard(src_layout, dst, var_sigs=_manifest_var_sigs(d),
                            src_specs=src_specs,
                            dst_specs=dst_specs or None,
                            flat_meta=flat_shard_meta(program) or None,
                            validate=False)
        return plan.dst_read_ranges(
            _rank_dst_blocks(plan, dist.get_rank())) or None
    except Exception:
        return None


def _planned_bytes(d: str, wanted, ranges) -> int:
    """The payload bytes a restore with ``ranges`` must read: the planned
    rows of each ranged var, every other wanted var whole."""
    total = 0
    for name, (shape, dtype) in _manifest_var_sigs(d).items():
        if wanted is not None and name not in wanted:
            continue
        item = _np_dtype(dtype).itemsize
        row = item * int(np.prod(shape[1:] or (1,)))
        want = (ranges or {}).get(name)
        if want is None:
            total += row * (int(shape[0]) if shape else 1)
        else:
            total += row * sum(hi - lo for lo, hi in want)
    return total


def _np_dtype(name: str) -> np.dtype:
    """A manifest dtype as numpy holds it (bfloat16 as 2-byte records)."""
    return np.dtype("V2") if name == "bfloat16" else np.dtype(name)


def _npz_member_meta(path: str) -> Dict[str, Any]:
    """{member: (data offset, dtype, shape, fortran)} for the byte-range
    reader: ``np.savez`` stores members uncompressed, so a member's data
    is one contiguous span of the file and a dim-0 row range is one seek
    and read.  A compressed or unreadable member maps to None (read
    whole)."""
    import struct
    import zipfile
    from numpy.lib import format as npy_format
    out: Dict[str, Any] = {}
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        for zi in z.infolist():
            name = zi.filename
            key = name[:-4] if name.endswith(".npy") else name
            if zi.compress_type != zipfile.ZIP_STORED:
                out[key] = None
                continue
            f.seek(zi.header_offset)
            hdr = f.read(30)
            if len(hdr) < 30 or hdr[:4] != b"PK\x03\x04":
                out[key] = None
                continue
            n, m = struct.unpack("<HH", hdr[26:30])
            f.seek(zi.header_offset + 30 + n + m)
            try:
                version = npy_format.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = \
                        npy_format.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, fortran, dtype = \
                        npy_format.read_array_header_2_0(f)
                else:
                    out[key] = None
                    continue
            except Exception:
                out[key] = None
                continue
            out[key] = (f.tell(), dtype, tuple(int(n) for n in shape),
                        bool(fortran))
    return out


def _intersect_rows(ranges, lo, hi):
    """``ranges`` ∩ [lo, hi): the wanted global rows inside one stored
    block's dim-0 extent."""
    out = []
    for a, b in ranges:
        a2, b2 = max(a, lo), min(b, hi)
        if b2 > a2:
            out.append((a2, b2))
    return out


def _new_read_stats() -> Dict[str, int]:
    return {"bytes_read": 0, "bytes_skipped": 0, "members_read": 0,
            "members_partial": 0, "members_skipped": 0}


def _read_sharded_arrays(dirname, wanted=None, row_ranges=None,
                         read_stats=None) -> Dict[str, np.ndarray]:
    """Reassemble global arrays from every process's shard files, by
    global offsets (a restore may run on another number of ranks), from
    the v1 flat manifest schema or the v2 one.

    ``row_ranges`` ({var: global dim-0 row intervals}, from
    ``ReshardPlan.dst_read_ranges``) restricts the read: a stored block
    outside them is skipped, one partly inside is read by seek and read
    over exactly its wanted rows, one wholly inside is read whole; rows
    not read stay zero.  ``read_stats`` adds up the payload
    ``bytes_read`` / ``bytes_skipped``."""
    stats = read_stats if read_stats is not None else _new_read_stats()
    for k, v in _new_read_stats().items():
        stats.setdefault(k, v)
    full: Dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(dirname)):
        if not fn.startswith("shard_manifest_"):
            continue
        pid = fn[len("shard_manifest_"):-len(".json")]
        with open(os.path.join(dirname, fn)) as f:
            manifest = json.load(f)
        if "format_version" in manifest and "vars" in manifest:
            manifest = manifest["vars"]
        data_path = os.path.join(dirname, f"shard_data_{pid}.npz")
        meta = _npz_member_meta(data_path) if row_ranges else {}
        raw = open(data_path, "rb") if row_ranges else None
        try:
            with np.load(data_path) as data:
                for name, rec in manifest.items():
                    if wanted is not None and name not in wanted:
                        continue
                    dst = full.setdefault(name, np.zeros(
                        rec["shape"], _np_dtype(rec["dtype"])))
                    want = (row_ranges or {}).get(name)
                    for e in rec["shards"]:
                        if e["key"] not in data:
                            continue
                        idx = e["index"]
                        sel = tuple(slice(a, b) for a, b in idx) \
                            if idx is not None else Ellipsis
                        lo, hi = (idx[0] if idx is not None
                                  else (0, int(rec["shape"][0])
                                        if rec["shape"] else 1))
                        row_nbytes = int(
                            _np_dtype(rec["dtype"]).itemsize *
                            np.prod([b - a for a, b in (idx or [])][1:]
                                    or [int(n) for n in
                                        rec["shape"][1:]] or [1]))
                        if want is None:
                            arr = data[e["key"]]
                            stats["bytes_read"] += int(arr.nbytes)
                            stats["members_read"] += 1
                            dst[sel] = arr
                            continue
                        inter = _intersect_rows(want, lo, hi)
                        if not inter:
                            stats["members_skipped"] += 1
                            stats["bytes_skipped"] += (hi - lo) * row_nbytes
                            continue
                        mm = meta.get(e["key"])
                        if inter == [(lo, hi)] or mm is None or mm[3] \
                                or idx is None:
                            arr = data[e["key"]]
                            stats["bytes_read"] += int(arr.nbytes)
                            stats["members_read"] += 1
                            dst[sel] = arr
                            continue
                        # a seek and a read over exactly the wanted rows
                        off, dtype, shape, _ = mm
                        tail = shape[1:]
                        rb = int(dtype.itemsize *
                                 int(np.prod(tail or (1,))))
                        stats["members_partial"] += 1
                        for a, b in inter:
                            raw.seek(off + (a - lo) * rb)
                            buf = raw.read((b - a) * rb)
                            stats["bytes_read"] += len(buf)
                            rows = np.frombuffer(
                                buf, dtype=dtype).reshape((b - a,) + tail)
                            dsel = (slice(a, b),) + tuple(
                                slice(c, d) for c, d in idx[1:])
                            dst[dsel] = rows
                        stats["bytes_skipped"] += \
                            (hi - lo) * row_nbytes - sum(
                                (b - a) * rb for a, b in inter)
        finally:
            if raw is not None:
                raw.close()
    return full


def load_persistables_sharded(executor, dirname,
                              main_program: Optional[Program] = None,
                              scope: Optional[Scope] = None):
    """Load a per-process sharded save (every process's files, reassembled
    by global offsets) onto the executor's device, each rank keeping its
    block of every sharded persistable."""
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    arrays = _read_sharded_arrays(dirname,
                                  set(_persistable_names(main_program)))
    dtypes = {v.name: v.dtype for v in main_program.list_vars()
              if v.name in arrays}
    _set_loaded(scope, main_program, convert_params(arrays, "cpu", dtypes),
                executor.device)


#: seconds rank 0's background write waits for every rank's shard files
ASYNC_GATHER_TIMEOUT_S = 600.0


class AsyncCheckpointer:
    """Background checkpoint writer (the JAX package's): ``save()``
    snapshots the state to host memory on the calling thread and returns
    while a thread writes it; the next ``save()`` or ``wait()`` joins the
    previous write first, so at most one write is in flight and a crash
    loses at most the newest checkpoint, never corrupts one: the write
    lands in ``checkpoint_<id>`` only by ``os.replace`` of a temporary
    directory.  A final write that fails after the loop exits without
    ``wait()`` is reported on stderr at interpreter exit.

    Under the groups of a sharded program every rank calls ``save()`` and
    snapshots only its own blocks; the threads write the per-process
    files of :func:`save_persistables_sharded` into one temporary
    directory, and rank 0's publishes it (TrainStatus, manifest, rename)
    once every rank's files are down; ``wait()`` then holds every rank
    until it is published.  Any other program writes the whole-array
    layout of :func:`save_checkpoint` from the calling rank.  The JAX
    package also starts its hang watchdog here
    (``observability/watchdog``); the port's waits for the observability
    layer."""

    def __init__(self, max_checkpoints: int = 3):
        import atexit
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._max = max_checkpoints
        self._dp = None
        atexit.register(self._drain_at_exit)

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        dp, self._dp = self._dp, None
        return dp

    def _drain_at_exit(self):
        self._join()
        if self._error is not None:
            import sys
            print(f"paddle_tpu_torch.AsyncCheckpointer: final checkpoint "
                  f"write failed: {self._error!r} — the newest checkpoint "
                  f"is missing; resume will use an older one",
                  file=sys.stderr)

    def wait(self):
        """Join the write in flight (under groups, every rank's: a
        collective), raising its failure."""
        _barrier(self._join())
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from e

    @property
    def in_flight(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def drain(self) -> bool:
        """Join the write in flight, reporting (not raising) a failure:
        True when it finished clean."""
        try:
            self.wait()
            return True
        except Exception as e:      # noqa: BLE001 — an exit path: report
            import sys
            print(f"paddle_tpu_torch.AsyncCheckpointer: in-flight "
                  f"checkpoint write failed during drain: {e!r}",
                  file=sys.stderr)
            return False

    def save(self, executor, path, train_status: TrainStatus,
             main_program: Optional[Program] = None,
             scope: Optional[Scope] = None):
        self.wait()
        main_program = main_program or default_main_program()
        scope = scope or global_scope()
        sync_prepared_state(scope)
        dp = _group(main_program)
        # the snapshot, on this thread: the values at this step
        if dp is None:
            snap = {}
            for name in _persistable_names(main_program):
                v = scope.find_var(name)
                if v is not None:
                    a = _to_numpy(v)
                    snap[name] = np.array(a) if not isinstance(
                        v, torch.Tensor) or v.device.type == "cpu" else a
            shard_bytes = None
        else:
            arrays, vars_ = _rank_blocks(main_program, scope, dp, copy=True)
            shard_bytes = _shard_payload(main_program, vars_)
        states = _generator_states(scope)
        status = json.dumps(train_status.to_dict()).encode()
        manifest = _manifest_dict(*_layout_view(main_program))
        ckpt_id = train_status.epoch_no
        final = os.path.join(path, f"checkpoint_{ckpt_id}")
        keep = self._max
        rank = _rank(dp)
        if dp is None:
            tmp = os.path.join(path,
                               f".tmp_checkpoint_{ckpt_id}_{os.getpid()}")
        else:
            tmp = os.path.join(path, f".tmp_checkpoint_{ckpt_id}_sharded")
            if _is_writer(dp):
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
            _barrier(dp)
        world = dp.world if dp is not None else 1

        def write_files():
            os.makedirs(tmp, exist_ok=True)
            if dp is None:
                _verified_write("params", os.path.join(tmp, "params.npz"),
                                lambda: _npz_bytes(snap))
            else:
                _verified_write(
                    "shard_data",
                    os.path.join(tmp, f"shard_data_{rank}.npz"),
                    lambda: _npz_bytes(arrays))
                _verified_write(
                    "shard_manifest",
                    os.path.join(tmp, f"shard_manifest_{rank}.json"),
                    shard_bytes)
            if states:
                _verified_write("rng", os.path.join(tmp, _rng_file(dp)),
                                lambda: _npz_bytes(states))

        def publish():
            if dp is not None:
                _await_markers(tmp, world)
            _verified_write("train_status",
                            os.path.join(tmp, "train_status.json"), status)
            # the manifest (with the content hashes) lands inside the
            # temporary directory: the rename publishes a checkpoint that
            # verifies, or nothing
            _write_manifest(tmp, manifest=manifest)
            if os.path.isdir(final):
                # aside, in, then delete: a crash between two steps leaves
                # the old or the new directory under a loadable name
                old = final + ".old"
                if os.path.isdir(old):
                    shutil.rmtree(old)
                os.replace(final, old)
                os.replace(tmp, final)
                shutil.rmtree(old)
            else:
                os.replace(tmp, final)
            _cleanup_stale(path, keep)

        def write():
            try:
                write_files()
            except BaseException as e:   # noqa: BLE001 — raised on wait
                self._error = e
                if dp is not None:
                    _touch(tmp, f".failed_{rank}")
                return
            try:
                if dp is not None:
                    _touch(tmp, f".written_{rank}")
                if _is_writer(dp):
                    publish()
            except BaseException as e:   # noqa: BLE001 — raised on wait
                self._error = e

        os.makedirs(path, exist_ok=True)
        self._dp = dp
        self._thread = threading.Thread(target=write, daemon=False)
        self._thread.start()
        return final


def _touch(d: str, name: str):
    with open(os.path.join(d, name), "wb"):
        pass


def _await_markers(tmp: str, world: int):
    """Wait until every rank has marked its files written in ``tmp``;
    raise if one marked a failure or the wait passes
    :data:`ASYNC_GATHER_TIMEOUT_S`.  The markers are dot files, which the
    manifest leaves out; they are removed here."""
    deadline = time.monotonic() + ASYNC_GATHER_TIMEOUT_S
    while True:
        names = set(os.listdir(tmp))
        failed = sorted(n for n in names if n.startswith(".failed_"))
        if failed:
            raise RuntimeError(
                f"AsyncCheckpointer: rank(s) "
                f"{[n[len('.failed_'):] for n in failed]} failed to write "
                f"their shard files")
        done = [r for r in range(world) if f".written_{r}" in names]
        if len(done) == world:
            break
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"AsyncCheckpointer: {world - len(done)} rank(s) did not "
                f"write their shard files within "
                f"{ASYNC_GATHER_TIMEOUT_S:.0f} s")
        time.sleep(0.01)
    for r in range(world):
        os.remove(os.path.join(tmp, f".written_{r}"))
