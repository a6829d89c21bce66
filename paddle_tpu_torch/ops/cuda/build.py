"""Build the CUDA sources in ``csrc/`` into shared libraries and load them.

One ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` call per source, all started together, each into
``paddle_tpu_torch/_build/lib<name>-<hash>.so``; the hash covers the
source, the shared headers and the flags, so an edited kernel rebuilds and
an unchanged one is reused.  The libraries expose plain C entry points
(no PyTorch headers), which keeps a build to seconds.  Building happens at
first use, never at import.

    python -m paddle_tpu_torch.ops.cuda.build      # build all, print times
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "_build")

#: kernel library name -> its source in csrc/
SOURCES = {
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "layer_norm": "layer_norm.cu",
    "bias_gelu": "bias_gelu.cu",
    "adam": "adam.cu",
    "quant_accumulate": "quant_accumulate.cu",
}
HEADERS = ("common.cuh", "flash_common.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, object] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels are built "
            "from source at first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in (SOURCES[name],) + HEADERS:
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(fn.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None, verbose: bool = False
          ) -> Dict[str, object]:
    """Compile every library in ``names`` (default: all) that is not built
    yet, one ``nvcc`` per source, in parallel.  Returns ``{"seconds":
    wall time, "built": [names], "ptxas": {name: compiler stderr}}`` —
    with ``verbose`` the compiler's per-kernel register/shared-memory
    report (``-Xptxas -v``) lands in ``ptxas``.  Raises RuntimeError
    naming the source and quoting nvcc's output on a failed build."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    report = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        report[name] = (stdout + stderr).strip()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {SOURCES[name]} "
                          f"(rc {proc.returncode}):\n{report[name]}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)      # atomic: a concurrent build is safe
    if errors:
        raise RuntimeError("\n".join(errors))
    return {"seconds": time.perf_counter() - t0, "built": list(procs),
            "ptxas": report}


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``name``, built and loaded
    on first use, with ``argtypes`` set (pointers as c_void_p, so ctypes
    never truncates them) and an int return code."""
    fn = _FUNCS.get((name, symbol))
    if fn is not None:
        return fn
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


if __name__ == "__main__":
    rep = build(verbose=True)
    for lib, text in rep["ptxas"].items():
        print(f"== {lib}\n{text}")
    print(f"built {rep['built']} in {rep['seconds']:.1f} s")
