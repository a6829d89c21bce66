"""Persistence — the port of the inference half of paddle_tpu/io.py, on the
same on-disk format: a saved inference model is a directory holding
``__model__`` (JSON: the versioned program desc + feed/fetch names) and
``params.npz`` (every persistable as a numpy array).  A directory written
by either package loads in the other.

:func:`convert_params` is the one door by which parameters enter the
port from numpy — the arrays the JAX package keeps in its scope or writes
to ``params.npz`` — and every load goes through it.  Checkpoints (format
v2, manifests, resharding) are a later item of the port."""

from __future__ import annotations

import io as _io
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .framework.core import Program, Variable, default_main_program
from .framework.executor import (Scope, global_scope, _RNG_VAR,
                                 sync_prepared_state)


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
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    with open(os.path.join(dirname, filename or "params.npz"), "wb") as f:
        f.write(buf.getvalue())


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
