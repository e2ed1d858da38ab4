"""Hand-written CUDA kernel K2: row gather ``vectors[ids]``.

Replaces ``semadb_tpu/ops/pallas/gather.py`` · ``gather_rows`` /
``gather_rows_padded`` (``_gather_kernel``, per-row DMAs with 16 in flight).
The kernel source is ``semadb_tpu_torch/csrc/gather.cu``; it is bound by
bytes (it reads each id once, the rows they name, and writes each output
row once), and its header says what the design does about that. It is built
like K1: ``nvcc`` for ``sm_90a`` into ``semadb_tpu_torch/_build/`` at first
use, loaded with ``ctypes``.

The only caller is the microbenchmark ``semadb_tpu_torch/tools/gatherbench.py``,
as in the JAX package; no search path gathers through it.

For CPU tensors the functions run :func:`gather_rows_plain`, the plain
PyTorch version; for CUDA tensors they launch the kernel or raise — they
never fall back. ``LAUNCHES`` counts kernel launches.

The JAX contract leaves clipping ids to the caller. The kernel never reads
outside ``[0, cap)``: it zeroes the output row of such an id and counts it
in a device flag, which ``check=True`` reads (one synchronisation) to raise
``IndexError``. Nothing is clamped.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from semadb_tpu_torch.utils.build import CSRC_DIR, NVCC_FLAGS, build_library, nvcc

SOURCE = os.path.join(CSRC_DIR, "gather.cu")
TILE = 1024  # ids per program of the JAX kernel: gather_rows takes whole tiles
DTYPES = (torch.float32,)

LAUNCHES = 0
BUILD_LOG = ""  # nvcc's output of the build this process did (ptxas -v)

_LIB = None
_LOCK = threading.Lock()


def gather_rows_plain(vectors: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``vectors[ids]`` after a range check that raises."""
    _check_operands(vectors, ids)
    _check_range(ids, vectors.shape[0])
    return vectors.index_select(0, ids.long())


def gather_rows(vectors: torch.Tensor, ids: torch.Tensor, check: bool = False) -> torch.Tensor:
    """``vectors[ids]`` for ``n`` a multiple of ``TILE``, as the JAX function
    asserts. ``vectors`` f32[cap, D], ``ids`` i32[n]; returns f32[n, D]."""
    if ids.shape[0] % TILE:
        raise ValueError(f"gather_rows takes a multiple of {TILE} ids, got {ids.shape[0]}")
    return gather_rows_padded(vectors, ids, check)


def gather_rows_padded(vectors: torch.Tensor, ids: torch.Tensor, check: bool = False) -> torch.Tensor:
    """``vectors[ids]`` for any ``n``: the kernel for CUDA tensors (it masks
    the ragged edge itself, so nothing is padded), the plain version for CPU
    tensors. ``check=True`` raises ``IndexError`` when an id lies outside
    ``[0, cap)``; without it such rows come back zero."""
    if vectors.device.type == "cpu" and ids.device.type == "cpu":
        return gather_rows_plain(vectors, ids)
    _check_operands(vectors, ids)
    _check_devices(vectors, ids)
    cap, d = vectors.shape
    n = ids.shape[0]
    out = torch.empty((n, d), dtype=vectors.dtype, device=vectors.device)
    if n == 0 or d == 0:
        return out
    bad = torch.zeros(1, dtype=torch.int32, device=vectors.device) if check else None
    lib = _library()
    global LAUNCHES
    with torch.cuda.device(vectors.device):
        stream = torch.cuda.current_stream(vectors.device).cuda_stream
        rc = lib.semadb_gather_rows(
            vectors.data_ptr(), ids.data_ptr(), out.data_ptr(), n, cap,
            d * vectors.element_size(), None if bad is None else bad.data_ptr(), stream,
        )
        if rc != 0:
            msg = lib.semadb_gather_error_string(rc).decode()
            raise RuntimeError(f"gather kernel launch failed ({rc}: {msg}) at cap={cap} D={d} n={n}")
        with _LOCK:
            LAUNCHES += 1
    if bad is not None and bad.item():
        _check_range(ids, cap)
        raise RuntimeError("the gather kernel flagged ids that the range check finds in range")
    return out


def _check_operands(vectors: torch.Tensor, ids: torch.Tensor) -> None:
    if vectors.dtype not in DTYPES:
        raise TypeError(f"vectors must be one of {DTYPES}, got {vectors.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if vectors.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"vectors must be 2-D and ids 1-D, got {tuple(vectors.shape)} and {tuple(ids.shape)}")
    if not (vectors.is_contiguous() and ids.is_contiguous()):
        raise ValueError("vectors and ids must be contiguous")


def _check_devices(vectors: torch.Tensor, ids: torch.Tensor) -> None:
    for name, t in (("vectors", vectors), ("ids", ids)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the other operand on a CUDA device")
    if vectors.device != ids.device:
        raise ValueError(f"vectors on {vectors.device}, ids on {ids.device}")


def _check_range(ids: torch.Tensor, cap: int) -> None:
    bad = (ids < 0) | (ids >= cap)
    if bool(bad.any()):
        where = bad.nonzero()[:5, 0].tolist()
        raise IndexError(
            f"{int(bad.sum())} ids outside [0, {cap}), e.g. at {where}: {ids[where].tolist()}"
        )


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path, BUILD_LOG = build_library("gather", SOURCE, nvcc(), NVCC_FLAGS)
        lib = ctypes.CDLL(path)
        lib.semadb_gather_rows.restype = ctypes.c_int
        lib.semadb_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.semadb_gather_error_string.restype = ctypes.c_char_p
        lib.semadb_gather_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
        return lib
