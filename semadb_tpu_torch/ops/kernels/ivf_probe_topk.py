"""Hand-written CUDA kernel K5: IVF probe selection, score tile and top-p in one pass.

Replaces ``semadb_tpu/index/ivf.py:340`` · ``_select_probes``, an XLA
contraction of the queries against every centroid and a top-k over the
[B, C] scores. The kernel source is ``semadb_tpu_torch/csrc/ivf_probe_topk.cu``;
it is bound by operations, and its header says what the design does about
that. It is built like K3: ``nvcc`` for ``sm_90a`` into
``semadb_tpu_torch/_build/`` at first use, loaded with ``ctypes``.

A block scores a tile of 64 or 128 queries against one slice of the
centroids with three TF32 products a pair on Hopper's wgmma (float32
accuracy), while warps of its own keep each query's running top-p in a heap
in shared memory, into which only the scores that reach the p-th best so far
go; it writes each heap's sorted keys to a partial ``[B, slices, p]``, and a
second kernel merges the slices' lists into the ids. The ``[B, C]`` score
matrix is never stored, and nothing is memset. :func:`plan` picks the query
tile and the slices from B, C and p.

:func:`ivf_probe_topk` returns i32[B, p]: each query's p clusters of
smallest ``cent_sq - 2 <qp, centroid>``, nearest first, equal scores by the
lower id. For CPU tensors it runs :func:`ivf_probe_topk_plain`, the plain
PyTorch version (the dense product, the scale and shift, ``topk``, chunked
over C past ``PROBE_CHUNK_BYTES``); for CUDA tensors it launches the kernels
or raises — it never falls back. p above ``MAX_P`` takes
:func:`ivf_probe_topk_library`, the same torch calls as the plain version.
``LAUNCHES`` counts the kernel's calls; ``LAUNCHES_BY`` counts the calls on a
CUDA device by ``(route, B == 1)``, route ``"kernel"`` or ``"library"``.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading

import torch

from semadb_tpu_torch.utils.build import CSRC_DIR, NVCC_FLAGS, build_library, nvcc

SOURCE = os.path.join(CSRC_DIR, "ivf_probe_topk.cu")
HEADERS = (os.path.join(CSRC_DIR, "smem_optin.cuh"),)
MAX_P = 256  # the largest p the kernel's heaps take; above it, the library route
TILE_C = 128  # centroids a tile (the source's kBN)
TILE_BS = (64, 128)  # the query tiles a block may take (one or two wgmma warpgroups)
MAX_SLICES = 64  # a query's lists in the partial, one a slice
SMEM_BLOCK = 232448  # the shared memory an H100 block may opt in to
# Full [B, C] probe-selection matrix cap of the plain version before it
# chunks over C, and the clusters a chunk
PROBE_CHUNK_BYTES = 2**30
PROBE_CHUNK_C = 16384
# The device kernels of one call
KERNELS = ("ivf_probe_topk_tile", "ivf_probe_topk_merge")

LAUNCHES = 0
LAUNCHES_BY: collections.Counter = collections.Counter()  # (route, B == 1) -> calls on a CUDA device
BUILD_LOG = ""  # nvcc's output of the build this process did (ptxas -v)

_LIB = None
_LOCK = threading.Lock()


def ivf_probe_topk_plain(qp: torch.Tensor, centroids: torch.Tensor, cent_sq: torch.Tensor, p: int) -> torch.Tensor:
    """Plain PyTorch version: one dense [B, C] ``torch.matmul``, the scale
    and shift, and ``topk``, chunked over C past PROBE_CHUNK_BYTES with a
    per-chunk top-p carry. The top-p is exact; equal scores come in
    ``topk``'s order. The JAX package takes ``approx_max_k`` from C = 2^17
    and inside chunks."""
    B = qp.shape[0]
    Cn = centroids.shape[0]
    p = min(p, Cn)
    if B * Cn * 4 <= PROBE_CHUNK_BYTES:
        cd = cent_sq[None, :] - 2.0 * (qp @ centroids.T)
        return torch.topk(cd, p, dim=1, largest=False, sorted=True).indices.to(torch.int32)
    cb = min(PROBE_CHUNK_C, Cn)
    dists, ids = [], []
    for c0 in range(0, Cn, cb):
        dd = cent_sq[None, c0 : c0 + cb] - 2.0 * (qp @ centroids[c0 : c0 + cb].T)
        v, i = torch.topk(dd, min(p, dd.shape[1]), dim=1, largest=False)
        dists.append(v)
        ids.append(i + c0)
    d, i = torch.cat(dists, dim=1), torch.cat(ids, dim=1)
    sel = torch.topk(d, p, dim=1, largest=False, sorted=True).indices
    return torch.gather(i, 1, sel).to(torch.int32)


def ivf_probe_topk_library(qp: torch.Tensor, centroids: torch.Tensor, cent_sq: torch.Tensor, p: int) -> torch.Tensor:
    """The route for p above MAX_P: the plain version's torch calls on any
    device, counted in ``LAUNCHES_BY`` on a CUDA device."""
    out = ivf_probe_topk_plain(qp, centroids, cent_sq, p)
    if qp.device.type == "cuda":
        with _LOCK:
            LAUNCHES_BY["library", qp.shape[0] == 1] += 1
    return out


def tile_smem_bytes(bm: int, p: int) -> int:
    """Shared memory of the tile kernel (the source's ``tile_smem_bytes``):
    a ring of 3 stages of a query chunk (bm rows of 20 floats) and a centroid
    chunk's hi and lo parts (128 rows of 2 x 16), the [128, bm + 4] score
    tile and bm heaps of p 8-byte keys."""
    return 3 * (bm * 20 + TILE_C * 32) * 4 + TILE_C * (bm + 4) * 4 + bm * p * 8


def plan(b: int, c: int, p: int, sms: int) -> tuple:
    """(query tile, slices, centroid tiles a slice) for B = b, C = c and p on
    a card of ``sms`` SMs. The tile is the least of TILE_BS that holds b,
    halved while its shared memory would pass SMEM_BLOCK. The slices split C
    in whole tiles so that one wave of blocks (one a SM) fills the card, up
    to MAX_SLICES."""
    bm = next((t for t in TILE_BS if t >= b), TILE_BS[-1])
    while bm > TILE_BS[0] and tile_smem_bytes(bm, p) > SMEM_BLOCK:
        bm //= 2
    tiles = -(-c // TILE_C)
    slices = max(1, min(sms // -(-b // bm), tiles, MAX_SLICES))
    slice_tiles = -(-tiles // slices)
    slices = -(-tiles // slice_tiles)
    return bm, slices, slice_tiles


def ivf_probe_topk(qp: torch.Tensor, centroids: torch.Tensor, cent_sq: torch.Tensor, p: int) -> torch.Tensor:
    """``qp`` f32[B, D], ``centroids`` f32[C, D], ``cent_sq`` f32[C] (zeros
    for dot and cosine), 0 <= p <= min(C, MAX_P) → i32[B, p]: the kernels for
    CUDA tensors, the plain version for CPU tensors."""
    tensors = (qp, centroids, cent_sq)
    if all(t.device.type == "cpu" for t in tensors):
        return ivf_probe_topk_plain(qp, centroids, cent_sq, p)
    _check_operands(qp, centroids, cent_sq, p)
    dev = qp.device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"K5 operands must all lie on one CUDA device; got {[str(x.device) for x in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K5 operands must be contiguous")
    B, D = qp.shape
    C = centroids.shape[0]
    out = torch.empty((B, p), dtype=torch.int32, device=dev)
    if B == 0 or p == 0:
        return out
    lib = _library()
    global LAUNCHES
    with torch.cuda.device(dev):
        bm, slices, slice_tiles = plan(B, C, p, torch.cuda.get_device_properties(dev).multi_processor_count)
        part = torch.empty((B, slices, p), dtype=torch.int64, device=dev)
        rc = lib.semadb_ivf_probe_topk(
            qp.data_ptr(), centroids.data_ptr(), cent_sq.data_ptr(), B, C, D, p, bm, slices, slice_tiles,
            part.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            msg = lib.semadb_ivf_probe_topk_error_string(rc).decode()
            raise RuntimeError(f"K5 launch failed ({rc}: {msg}) at B={B} C={C} D={D} p={p} "
                               f"plan={bm, slices, slice_tiles}")
        with _LOCK:
            LAUNCHES += 1
            LAUNCHES_BY["kernel", B == 1] += 1
    return out


def _check_operands(qp, centroids, cent_sq, p) -> None:
    if any(t.dtype != torch.float32 for t in (qp, centroids, cent_sq)):
        raise TypeError(f"K5 operands must be float32, got {qp.dtype}, {centroids.dtype}, {cent_sq.dtype}")
    if qp.dim() != 2 or centroids.dim() != 2 or qp.shape[1] != centroids.shape[1] or qp.shape[1] == 0:
        raise ValueError(f"qp {tuple(qp.shape)} and centroids {tuple(centroids.shape)} must be [B, D] and [C, D]")
    if cent_sq.shape != (centroids.shape[0],):
        raise ValueError(f"cent_sq {tuple(cent_sq.shape)} must be [{centroids.shape[0]}]")
    if not 0 <= p <= min(centroids.shape[0], MAX_P):
        raise ValueError(f"p must lie in [0, min(C, {MAX_P})], got p={p} with C={centroids.shape[0]}")


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path, BUILD_LOG = build_library("ivf_probe_topk", SOURCE, nvcc(), NVCC_FLAGS, HEADERS)
        lib = ctypes.CDLL(path)
        lib.semadb_ivf_probe_topk.restype = ctypes.c_int
        lib.semadb_ivf_probe_topk.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
        lib.semadb_ivf_probe_topk_error_string.restype = ctypes.c_char_p
        lib.semadb_ivf_probe_topk_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
        return lib
