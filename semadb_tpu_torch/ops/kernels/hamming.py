"""Hand-written CUDA kernel K1: blocked hamming/jaccard distance scan.

Replaces ``semadb_tpu/ops/pallas/hamming.py`` · ``pairwise_bit_distance_pallas``,
the scan of the binary-quantized flat index. The kernel source is
``semadb_tpu_torch/csrc/hamming.cu`` (its header says what bounds it on the
H100 and what the design does about that). It is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at first use, into
``semadb_tpu_torch/_build/`` under a name keyed by a hash of the source and
flags, and loaded with ``ctypes``.

The source holds two routes of the one kernel: ``tensor_core`` counts
``|q AND x|`` with the single-bit MMA and derives hamming and jaccard from it
and the row popcounts; ``cuda_core`` is the first version, one code row a
thread and ``__popc`` on the integer pipe. :func:`route_for` picks by B alone
(``TENSOR_MIN_B``, set from the card's timings in ``PERF.md``), except that
codes wider than ``TENSOR_MAX_W`` words (the schema's 4096 bits) take the
CUDA-core route, whose shared memory holds them. A failure never picks a
route: either route raises when it cannot launch.

:func:`pairwise_bit_distance_kernel` is the wrapper the flat index calls. For
CPU tensors it runs :func:`pairwise_bit_distance_plain`, the plain PyTorch
version of the same function; for CUDA tensors it launches the kernel or
raises — it never falls back. ``LAUNCHES`` counts kernel launches and
``LAUNCHES_BY`` splits them by ``(route, B == 1)``.

Codes are ``int32`` tensors holding the JAX package's ``uint32`` words (the
same bits): torch's ``uint32`` has too few operators to compute with.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading

import torch

from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.utils.build import CSRC_DIR, NVCC_FLAGS, build_library, nvcc

SOURCE = os.path.join(CSRC_DIR, "hamming.cu")
METRIC_FLAGS = {C.DISTANCE_HAMMING: 0, C.DISTANCE_JACCARD: 1}
ROUTES = {"cuda_core": 0, "tensor_core": 1}
MAX_B_PER_LAUNCH = 65535  # grid.y limit at one query per block row
TENSOR_MIN_B = 2  # the smallest B that takes the tensor-core route (PERF.md §6)
TENSOR_MAX_W = 128  # the widest codes the tensor-core route takes (4096 bits)

LAUNCHES = 0
LAUNCHES_BY: collections.Counter = collections.Counter()  # (route, B == 1) -> launches
BUILD_LOG = ""  # nvcc's output of the build this process did (ptxas -v)

_LIB = None
_LOCK = threading.Lock()

# popcount of every byte value, for the plain version
_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)
# Bytes of the int32 [B, rows, W] intermediate per step of the plain version
_PLAIN_BLOCK_BYTES = 1 << 26


def popcount_sum(words: torch.Tensor) -> torch.Tensor:
    """The set bits of the words ``[..., W]`` summed over the last axis →
    i32[...]: a 256-entry byte table over a ``uint8`` view."""
    nbytes = words.contiguous().view(torch.uint8).to(torch.int64)
    return _POPCOUNT8.to(words.device)[nbytes].sum(-1, dtype=torch.int32)


def pairwise_bit_distance_plain(
    queries: torch.Tensor, corpus: torch.Tensor, metric: str
) -> torch.Tensor:
    """Plain PyTorch version: ``i32[B, W]`` x ``i32[N, W]`` → ``f32[B, N]``.

    popcount is a 256-entry byte table over a ``uint8`` view. The
    ``[B, n, W]`` intermediate is built block by block over N so its size
    stays bounded."""
    if metric not in METRIC_FLAGS:
        raise ValueError(f"unknown bit distance function: {metric}")
    B, W = queries.shape
    N = corpus.shape[0]
    out = torch.empty((B, N), dtype=torch.float32, device=queries.device)
    step = max(1, _PLAIN_BLOCK_BYTES // max(B * W * 4, 1))
    q = queries[:, None, :]
    for lo in range(0, N, step):
        x = corpus[None, lo : lo + step, :]
        if metric == C.DISTANCE_HAMMING:
            out[:, lo : lo + step] = popcount_sum(q ^ x).to(torch.float32)
        else:
            inter = popcount_sum(q & x)
            union = popcount_sum(q | x)
            d = 1.0 - inter.to(torch.float32) / union.clamp(min=1).to(torch.float32)
            out[:, lo : lo + step] = torch.where(union == 0, 0.0, d)
    return out


def route_for(b: int, w: int) -> str:
    """The route the wrapper takes for ``b`` queries of ``w`` words."""
    return "tensor_core" if b >= TENSOR_MIN_B and w <= TENSOR_MAX_W else "cuda_core"


def pairwise_bit_distance_kernel(
    queries: torch.Tensor, corpus: torch.Tensor, metric: str, route: str | None = None
) -> torch.Tensor:
    """All-pairs bit distance: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``queries`` i32[B, W], ``corpus`` i32[N, W].
    ``route`` forces one of ``ROUTES`` (tests and timing); by default
    :func:`route_for` picks it."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; one of {sorted(ROUTES)}")
    if queries.device.type == "cpu" and corpus.device.type == "cpu":
        return pairwise_bit_distance_plain(queries, corpus, metric)
    _check(queries, corpus, metric)
    B, W = queries.shape
    N = corpus.shape[0]
    out = torch.empty((B, N), dtype=torch.float32, device=queries.device)
    if B == 0 or N == 0:
        return out
    lib = _library()
    global LAUNCHES
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        for lo in range(0, B, MAX_B_PER_LAUNCH):
            nb = min(MAX_B_PER_LAUNCH, B - lo)
            r = route or route_for(nb, W)
            rc = lib.semadb_bit_distance(
                queries[lo].data_ptr(), corpus.data_ptr(), out[lo].data_ptr(),
                nb, N, W, METRIC_FLAGS[metric], ROUTES[r], stream,
            )
            if rc != 0:
                msg = lib.semadb_cuda_error_string(rc).decode()
                raise RuntimeError(
                    f"bit distance kernel launch failed ({rc}: {msg}) on the {r} route "
                    f"at B={nb} N={N} W={W}"
                )
            with _LOCK:
                LAUNCHES += 1
                LAUNCHES_BY[r, nb == 1] += 1
    return out


def _check(queries: torch.Tensor, corpus: torch.Tensor, metric: str) -> None:
    if metric not in METRIC_FLAGS:
        raise ValueError(f"unknown bit distance function: {metric}")
    for name, t in (("queries", queries), ("corpus", corpus)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the other operand on a CUDA device")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 packed codes, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.device != corpus.device:
        raise ValueError(f"queries on {queries.device}, corpus on {corpus.device}")
    if queries.shape[1] != corpus.shape[1]:
        raise ValueError(
            f"word counts differ: queries W={queries.shape[1]}, corpus W={corpus.shape[1]}"
        )


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path, BUILD_LOG = build_library("hamming", SOURCE, nvcc(), NVCC_FLAGS)
        lib = ctypes.CDLL(path)
        lib.semadb_bit_distance.restype = ctypes.c_int
        lib.semadb_bit_distance.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.semadb_cuda_error_string.restype = ctypes.c_char_p
        lib.semadb_cuda_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
        return lib
