#!/usr/bin/env python3
"""Opcode census of the kernels in a built CUDA library, from its SASS.

    python3 tools/sass_census.py LIB.so [--ops I2F,F2I,MUFU,...]

Runs ``cuobjdump -sass`` (from PATH or ``$CUDA_HOME/bin``, default
``/usr/local/cuda/bin``) on LIB and prints, for each kernel, its
instruction count and how many of them are each of the opcodes asked for
(by default the conversion and special-function ones: I2F, I2FP, F2I,
FRND, MUFU, FCHK, and the calls, PRMT, FADD, FMUL, FFMA, SHFL, LDG, STG).
A count is static — instructions in the code, not executed — so a branch
that runs only for some inputs still counts.  Needs the CUDA toolkit;
imports nothing of the repository."""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

DEFAULT_OPS = ("I2F", "I2FP", "F2I", "FRND", "MUFU", "FCHK", "CALL", "PRMT",
               "FADD", "FMUL", "FFMA", "SHFL", "LDG", "STG")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "cuobjdump")


def census(lib: str, ops=DEFAULT_OPS):
    """{kernel: (instructions, Counter of the opcodes in ``ops``)}."""
    sass = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            out[kernel] = [0, collections.Counter()]
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if m and kernel:
            out[kernel][0] += 1
            if m.group(2) in ops:
                out[kernel][1][m.group(2)] += 1
    return {k: (n, c) for k, (n, c) in out.items()}


def main(argv):
    if not argv or argv[0].startswith("-"):
        print(__doc__)
        return 2
    ops = DEFAULT_OPS
    if "--ops" in argv:
        ops = tuple(argv[argv.index("--ops") + 1].split(","))
    for kernel, (n, counts) in sorted(census(argv[0], ops).items()):
        print(f"{kernel}: {n} instructions; " +
              ", ".join(f"{op} {counts[op]}" for op in ops if counts[op]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
