"""Hand-written CUDA kernel K4: the IVF exact rerank of the coarse pool.

Replaces the XLA program of ``semadb_tpu/index/ivf.py`` · ``_ivf_query`` that
reranks the pool (``:517-543``). The kernel source is
``semadb_tpu_torch/csrc/ivf_rerank.cu`` (with ``csrc/ivf_common.cuh``); it is
bound by bytes, and its header says what the design does about that. It is
built like K1 and K2: ``nvcc`` for ``sm_90a`` into ``semadb_tpu_torch/_build/``
at first use, loaded with ``ctypes``.

:func:`ivf_exact_rerank` computes the exact metric distance (squared
euclidean, taken directly as ``sum (x - q)^2``; ``-dot``; ``1 - dot``)
between each query and the rows of its pool, and returns the ``k``
smallest, ascending, with ``(inf, -1)`` for empty places. A pool slot is
empty when its coarse score is not finite or its id lies outside
``[0, cap)``. Equal distances may come in any order. For CPU tensors it runs
:func:`ivf_exact_rerank_plain`, the plain PyTorch version (the JAX program's
gather, in chunks of 64 pool slots past 2^27 gathered elements); for CUDA
tensors it launches the kernel or raises — it never falls back. ``LAUNCHES``
counts kernel launches.

Tolerance against the JAX program (``Precision.HIGHEST``, f32): the sums run
in another order, so distances agree to about 1e-6 relative to the summed
terms; the tests hold them to 1e-5.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.utils.build import CSRC_DIR, NVCC_FLAGS, build_library, nvcc

SOURCE = os.path.join(CSRC_DIR, "ivf_rerank.cu")
HEADERS = (os.path.join(CSRC_DIR, "ivf_common.cuh"),)
METRIC_FLAGS = {C.DISTANCE_EUCLIDEAN: 0, C.DISTANCE_DOT: 1, C.DISTANCE_COSINE: 2}
MAX_POOL = 2048
MAX_D = 4096
NIL = -1
RCH = 64  # pool slots per step of the plain version's chunked gather

LAUNCHES = 0
BUILD_LOG = ""  # nvcc's output of the build this process did (ptxas -v)

_LIB = None
_LOCK = threading.Lock()


def ivf_exact_rerank_plain(
    vectors: torch.Tensor, queries: torch.Tensor, pool: torch.Tensor, coarse: torch.Tensor,
    k: int, metric: str,
):
    """Plain PyTorch version: gather ``vectors[pool]``, exact distances,
    ``topk``; as the JAX program, but ids outside ``[0, cap)`` are empty."""
    _check_operands(vectors, queries, pool, coarse, k, metric)
    cap = vectors.shape[0]
    B, rr = pool.shape
    D = queries.shape[1]
    valid = (pool >= 0) & (pool < cap) & torch.isfinite(coarse)
    pc = pool.clamp(0, cap - 1).long()

    def exact(cols: torch.Tensor) -> torch.Tensor:
        pv = vectors[cols]  # [B, chunk, D]
        if metric == C.DISTANCE_EUCLIDEAN:
            return ((pv - queries[:, None, :]) ** 2).sum(-1)
        cross = torch.einsum("brd,bd->br", pv, queries)
        return (1.0 - cross) if metric == C.DISTANCE_COSINE else -cross

    if B * rr * D > 2**27:
        rd = torch.cat([exact(pc[:, j : j + RCH]) for j in range(0, rr, RCH)], dim=1)
    else:
        rd = exact(pc)
    rd = rd.masked_fill(~valid, float("inf"))
    kk = min(k, rr)
    vals, pos = torch.topk(rd, kk, dim=1, largest=False, sorted=True)
    ids = torch.gather(pool, 1, pos)
    ok = torch.isfinite(vals)
    vals = vals.masked_fill(~ok, float("inf"))
    ids = ids.masked_fill(~ok, NIL)
    if kk < k:
        vals = torch.cat([vals, vals.new_full((B, k - kk), float("inf"))], dim=1)
        ids = torch.cat([ids, ids.new_full((B, k - kk), NIL)], dim=1)
    return vals, ids


def ivf_exact_rerank(
    vectors: torch.Tensor, queries: torch.Tensor, pool: torch.Tensor, coarse: torch.Tensor,
    k: int, metric: str,
):
    """``vectors`` f32[cap, D], ``queries`` f32[B, D], ``pool`` i32[B, rr],
    ``coarse`` f32[B, rr] → (f32[B, k], i32[B, k]): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    tensors = (vectors, queries, pool, coarse)
    if all(t.device.type == "cpu" for t in tensors):
        return ivf_exact_rerank_plain(vectors, queries, pool, coarse, k, metric)
    _check_operands(vectors, queries, pool, coarse, k, metric)
    dev = queries.device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"K4 operands must all lie on one CUDA device; got {[str(x.device) for x in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K4 operands must be contiguous")
    cap, D = vectors.shape
    B, rr = pool.shape
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out_d, out_i
    lib = _library()
    global LAUNCHES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.semadb_ivf_exact_rerank(
            vectors.data_ptr(), cap, D, queries.data_ptr(), pool.data_ptr(), coarse.data_ptr(),
            B, rr, k, METRIC_FLAGS[metric], out_d.data_ptr(), out_i.data_ptr(), stream,
        )
        if rc != 0:
            msg = lib.semadb_ivf_rerank_error_string(rc).decode()
            raise RuntimeError(f"K4 launch failed ({rc}: {msg}) at cap={cap} D={D} B={B} rr={rr} k={k}")
        with _LOCK:
            LAUNCHES += 1
    return out_d, out_i


def _check_operands(vectors, queries, pool, coarse, k, metric) -> None:
    if metric not in METRIC_FLAGS:
        raise ValueError(f"K4 takes the metrics {sorted(METRIC_FLAGS)}, got {metric}")
    if vectors.dtype != torch.float32 or queries.dtype != torch.float32 or coarse.dtype != torch.float32:
        raise TypeError("vectors, queries and coarse must be float32")
    if pool.dtype != torch.int32:
        raise TypeError(f"pool must be int32, got {pool.dtype}")
    if vectors.dim() != 2 or queries.dim() != 2 or pool.dim() != 2 or pool.shape != coarse.shape:
        raise ValueError(
            f"shapes do not fit: vectors {tuple(vectors.shape)} queries {tuple(queries.shape)} "
            f"pool {tuple(pool.shape)} coarse {tuple(coarse.shape)}"
        )
    if queries.shape[1] != vectors.shape[1] or pool.shape[0] != queries.shape[0]:
        raise ValueError(f"queries {tuple(queries.shape)} do not fit vectors {tuple(vectors.shape)} or pool {tuple(pool.shape)}")
    if not (1 <= pool.shape[1] <= MAX_POOL and 1 <= vectors.shape[1] <= MAX_D and k >= 1 and vectors.shape[0] >= 1):
        raise ValueError(f"need 1 <= rr <= {MAX_POOL}, 1 <= D <= {MAX_D}, k >= 1 and a non-empty vectors matrix")


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path, BUILD_LOG = build_library("ivf_rerank", SOURCE, nvcc(), NVCC_FLAGS, HEADERS)
        lib = ctypes.CDLL(path)
        lib.semadb_ivf_exact_rerank.restype = ctypes.c_int
        lib.semadb_ivf_exact_rerank.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.semadb_ivf_rerank_error_string.restype = ctypes.c_char_p
        lib.semadb_ivf_rerank_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
        return lib
