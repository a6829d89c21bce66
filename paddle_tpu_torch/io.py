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

Sharded checkpoints, a layout other than one device's, resharding and
``AsyncCheckpointer`` need ZeRO and meshes, which are not ported: they
raise ``UnimplementedError``.  The JAX loader's flight-recorder and
``monitor.stat`` hooks wait for the port's observability layer."""

from __future__ import annotations

import hashlib
import io as _io
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .flags import flag
from .framework.core import Program, Variable, default_main_program
from .framework.errors import InvalidArgumentError, UnimplementedError
from .framework.executor import (Scope, global_scope, _RNG_VAR,
                                 sync_prepared_state)

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


def save_persistables(executor, dirname,
                      main_program: Optional[Program] = None,
                      filename: Optional[str] = None,
                      scope: Optional[Scope] = None):
    """Save every persistable var of the program to one npz file (the
    current values: a donated prepared step's state is synced first)."""
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    sync_prepared_state(scope)
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for name in _persistable_names(main_program):
        v = scope.find_var(name)
        if v is not None:
            arrays[name] = _to_numpy(v)
    _verified_write("params", os.path.join(dirname,
                                           filename or "params.npz"),
                    lambda: _npz_bytes(arrays))


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
    for name, t in convert_params(arrays, executor.device, dtypes).items():
        scope.set_var(name, t)


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


def _one_device(sizes) -> bool:
    return all(int(n) == 1 for n in dict(sizes).values())


def _refuse_layout(what: str, layout):
    """A layout other than one device's needs meshes and resharding."""
    if layout is None:
        return
    sizes = getattr(layout, "sizes", None)
    if isinstance(layout, dict):
        sizes = dict((a, n) for a, n in layout.get("axes", []))
    if sizes is None or not _one_device(sizes):
        raise UnimplementedError(
            f"{what}: the layout {sizes!r} is not one device's; meshes and "
            f"resharded checkpoints are not ported yet")


def _manifest_dict() -> Dict[str, Any]:
    """The JAX package's v2 manifest keys for an unsharded program on one
    device: no layout stamp, no shard specs, no ZeRO flat metadata."""
    return {"format_version": CKPT_FORMAT_VERSION, "mesh_layout": None,
            "shard_specs": {}, "flat_meta": {}, "rng_vars": [_RNG_VAR],
            "files": {}}


def _write_manifest(d: str, main_program: Optional[Program] = None,
                    layout=None, manifest: Optional[Dict] = None):
    """Write ``ckpt_manifest.json`` last (a temporary file, then an atomic
    rename), with a content hash per file of the checkpoint: a torn save is
    detectable, and restore falls back to the newest checkpoint whose
    hashes verify."""
    _refuse_layout("save_checkpoint", layout)
    manifest = dict(manifest if manifest is not None else _manifest_dict())
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
    return {n: g.get_state().numpy() for n, g in scope.vars.items()
            if n.startswith(_RNG_VAR) and isinstance(g, torch.Generator)}


def save_checkpoint(executor, path, train_status: TrainStatus,
                    main_program: Optional[Program] = None,
                    scope: Optional[Scope] = None,
                    remain_all_checkpoint=False, max_checkpoints: int = 3,
                    sharded: bool = False, layout=None):
    """Checkpoint ``checkpoint_<epoch_no>`` under ``path``: the program's
    persistables (a live donated prepared step's current state, synced
    first), the port's generator states (:data:`TORCH_RNG_FILE`), the
    TrainStatus and the v2 manifest, written last; keeps the newest
    ``max_checkpoints`` unless ``remain_all_checkpoint``.  Returns the
    directory.  ``sharded=True`` and a layout other than one device's are
    not ported (UnimplementedError)."""
    if sharded:
        raise UnimplementedError(
            "save_checkpoint(sharded=True): per-process shard files need "
            "ZeRO and meshes, which are not ported yet")
    _refuse_layout("save_checkpoint", layout)
    scope = scope or global_scope()
    main_program = main_program or default_main_program()
    sync_prepared_state(scope)
    d = os.path.join(path, f"checkpoint_{train_status.epoch_no}")
    os.makedirs(d, exist_ok=True)
    save_persistables(executor, d, main_program, scope=scope)
    states = _generator_states(scope)
    if states:
        _verified_write("rng", os.path.join(d, TORCH_RNG_FILE),
                        lambda: _npz_bytes(states))
    _verified_write("train_status", os.path.join(d, "train_status.json"),
                    json.dumps(train_status.to_dict()).encode())
    _write_manifest(d, main_program)
    if not remain_all_checkpoint:
        _cleanup_stale(path, max_checkpoints)
    return d


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
    program-seeded generator.  A checkpoint written under another layout,
    a sharded one and ``dst_layout`` other than one device's raise
    UnimplementedError."""
    _refuse_layout("load_checkpoint", dst_layout)
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
    persistables (those of ``program``, all when None) and the port's
    generator states; returns its TrainStatus."""
    manifest = _read_manifest(d) or {}
    _refuse_layout("load_checkpoint (the checkpoint's stamp)",
                   manifest.get("mesh_layout"))
    if manifest.get("flat_meta") or \
            any(n.startswith("shard_manifest_") for n in os.listdir(d)):
        raise UnimplementedError(
            f"load_checkpoint: {d!r} is a sharded or ZeRO checkpoint; "
            f"restoring one needs meshes and resharding, which are not "
            f"ported yet")
    device = torch.device(device if device is not None else "cpu")
    wanted = set(_persistable_names(program)) if program is not None \
        else None
    arrays = _read_whole_arrays(d, wanted)
    if program is not None:
        _check_restore_shapes(program, arrays)
        dtypes = {v.name: v.dtype for v in program.list_vars()
                  if v.name in arrays}
    else:
        dtypes = {}
    for name, t in convert_params(arrays, device, dtypes).items():
        scope.set_var(name, t)
    rng_path = os.path.join(d, TORCH_RNG_FILE)
    if os.path.exists(rng_path):
        with np.load(rng_path) as data:
            for name in data.files:
                g = torch.Generator(device=device)
                g.set_state(torch.from_numpy(np.array(data[name])))
                scope.vars[name] = g
    with open(os.path.join(d, "train_status.json")) as f:
        st = TrainStatus.from_dict(json.load(f))
    st.reshard = None
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


def save_persistables_sharded(executor, dirname,
                              main_program: Optional[Program] = None,
                              scope: Optional[Scope] = None, layout=None):
    """Not ported: per-process shard files need ZeRO and meshes."""
    raise UnimplementedError(
        "save_persistables_sharded: sharded checkpoints need ZeRO and "
        "meshes, which are not ported yet")


class AsyncCheckpointer:
    """Not ported: the background checkpoint writer comes with the
    observability layer (its hang watchdog) and sharded saves."""

    def __init__(self, max_checkpoints: int = 3):
        raise UnimplementedError(
            "AsyncCheckpointer: the background checkpoint writer is not "
            "ported yet; call save_checkpoint")
