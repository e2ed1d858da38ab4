"""Builds one C++ or CUDA source of the port into a shared library at first use.

The library goes into ``semadb_tpu_torch/_build/`` (ignored by git) as
``<stem>-<hash>.so``, the hash covering the source, the headers it names as
dependencies and the compiler's flags: an edited source, header or flag
builds anew, an unchanged one is found built. The
compiler writes a temporary file that is renamed into place, so processes
that build the same library at once never load a partial one and never
share an output with the JAX package's own build (``native/build/``).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import List, Sequence, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
# The CUDA kernels' flags: Hopper's sm_90a (wgmma and setmaxnreg need the
# "a"), a shared library with a plain C interface, and ptxas's register and
# spill report in the build log.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Seconds this process has spent in the compilers (the bench's
# ``build_compile_s``: an engine's first use builds its kernels)
BUILD_SECONDS = 0.0


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` (default
    ``/usr/local/cuda``). Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")


def build_library(
    stem: str, source: str, compiler: str, flags: List[str], deps: Sequence[str] = ()
) -> Tuple[str, str]:
    """Build ``source`` with ``compiler flags -o <lib> source`` unless a
    library of this source, these headers (``deps``) and these flags exists.
    Returns the library's path and the compiler's output ("" when it was
    found built). Raises ``RuntimeError`` when the compiler fails,
    ``OSError`` when it cannot run."""
    src = b""
    for path in (source, *deps):
        with open(path, "rb") as f:
            src += f.read()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"{stem}-{key}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    global BUILD_SECONDS
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, source], capture_output=True, text=True)
        BUILD_SECONDS += time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"{compiler} failed ({proc.returncode}) building {source}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, proc.stdout + proc.stderr
