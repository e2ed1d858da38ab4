"""Hand-written CUDA kernel K11: the Vamana robust prune, one block a node.

Replaces the XLA programs of ``semadb_tpu/index/vamana/build.py`` ·
``robust_prune_batch`` (``:97-156``) and ``_pairwise_among`` (``:72-94``): the
greedy alpha prune of each node's sorted candidate pool into at most R edges.
The kernel source is ``semadb_tpu_torch/csrc/vamana_prune.cu``: a block a
node stages its live candidates' rows in shared memory (as many as fit),
computes panel by panel the distances from the next 32 live candidates to
the later ones (a register-tiled FFMA product) and lets one warp run the greedy over the panel from kill masks, so the JAX program's
f32[B, P, P] matrix is never written. It is bound by bytes at the build's
shapes, and its header says what the design does about that.
Built like K10: ``nvcc`` for ``sm_90a`` into ``semadb_tpu_torch/_build/`` at
first use, loaded with ``ctypes``.

:func:`vamana_robust_prune` takes the pools (f32, i32)[B, P] sorted by
distance to their node, the nodes' own ids i32[B], the graph's vectors, R,
``r_stop`` (``max(R - FWD_SLACK, 8)``) and ``alpha``, and returns the rows
i32[B, R]. For CPU tensors it runs :func:`robust_prune_plain` (the JAX
programs in torch: the pairwise matrix, then the loop); for CUDA tensors it
launches the kernel or raises, it never falls back. ``LAUNCHES`` counts
launches.

The pairwise distance is ``_pairwise_among``'s formula (euclidean
sq_i + sq_j − 2⟨i, j⟩ clamped at 0; cosine 1 − ⟨⟩; dot −⟨⟩; haversine), so on
integer-valued vectors (|x| ≤ 8, D ≤ 128), where every term is exact in f32,
kernel and plain version keep the same edges bit for bit. On real-valued data
the sums run in another order and a decision at a near-tie may differ.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.ops.distance import _haversine_pair
from semadb_tpu_torch.utils.build import CSRC_DIR, NVCC_FLAGS, build_library, nvcc

SOURCE = os.path.join(CSRC_DIR, "vamana_prune.cu")
HEADERS = (os.path.join(CSRC_DIR, "vamana_common.cuh"), os.path.join(CSRC_DIR, "smem_optin.cuh"))
METRIC_FLAGS = {C.DISTANCE_EUCLIDEAN: 0, C.DISTANCE_DOT: 1, C.DISTANCE_COSINE: 2, C.DISTANCE_HAVERSINE: 3}
MAX_P = 2048
MAX_D = 4096
NIL = -1
KERNELS = ("vamana_robust_prune_kernel",)

LAUNCHES = 0
BUILD_LOG = ""

_LIB = None
_LOCK = threading.Lock()


def pairwise_among(vectors: torch.Tensor, cand_ids: torch.Tensor, metric: str) -> torch.Tensor:
    """``_pairwise_among``: distances among each row's candidates,
    ids i32[B, P] → f32[B, P, P]."""
    cap = vectors.shape[0]
    cv = vectors[cand_ids.clamp(0, cap - 1).long()]  # [B, P, D]
    if metric == C.DISTANCE_HAVERSINE:
        return _haversine_pair(cv[:, :, None, :], cv[:, None, :, :])
    cross = torch.bmm(cv, cv.transpose(1, 2))
    if metric == C.DISTANCE_EUCLIDEAN:
        sq = (cv * cv).sum(-1)
        return (sq[:, :, None] - 2.0 * cross + sq[:, None, :]).clamp(min=0.0)
    if metric == C.DISTANCE_COSINE:
        return 1.0 - cross
    return -cross


def robust_prune_plain(
    cand_d: torch.Tensor, cand_i: torch.Tensor, self_ids: torch.Tensor, vectors: torch.Tensor, degree: int,
    r_stop: int, alpha: float, metric: str,
) -> torch.Tensor:
    """Plain PyTorch version: ``_pairwise_among`` then ``robust_prune_batch``'s
    loop, one kept candidate a step for every row at once."""
    _check(cand_d, cand_i, self_ids, vectors, degree, metric)
    B, P = cand_i.shape
    dev = cand_i.device
    pd = pairwise_among(vectors, cand_i, metric)
    alpha = torch.tensor(alpha, dtype=torch.float32, device=dev)
    jidx = torch.arange(P, device=dev)
    dead = (cand_i == NIL) | (cand_i == self_ids[:, None]) | ~torch.isfinite(cand_d)
    count = torch.zeros(B, dtype=torch.long, device=dev)
    adj = torch.full((B, degree), NIL, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    while True:
        live = ~dead & (count < r_stop)[:, None]
        sel = live.any(-1)
        if not bool(sel.any()):
            break
        pos = live.to(torch.uint8).argmax(-1)  # the first live candidate
        cid = cand_i[rows, pos]
        write = sel & (count < degree)
        adj[rows[write], count[write]] = cid[write]
        count = count + sel.long()
        pruned = (alpha * pd[rows, pos] < cand_d) & (jidx[None, :] > pos[:, None])
        dead = dead | (sel[:, None] & pruned)
        dead[rows[sel], pos[sel]] = True
    return adj


def vamana_robust_prune(
    cand_d: torch.Tensor, cand_i: torch.Tensor, self_ids: torch.Tensor, vectors: torch.Tensor, degree: int,
    r_stop: int, alpha: float, metric: str,
) -> torch.Tensor:
    """``cand_d`` f32[B, P] (sorted ascending), ``cand_i`` i32[B, P],
    ``self_ids`` i32[B], ``vectors`` f32[cap, D] → adjacency rows i32[B, R]:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    tensors = (cand_d, cand_i, self_ids, vectors)
    if all(t.device.type == "cpu" for t in tensors):
        return robust_prune_plain(cand_d, cand_i, self_ids, vectors, degree, r_stop, alpha, metric)
    _check(cand_d, cand_i, self_ids, vectors, degree, metric)
    dev = cand_i.device
    if any(t.device != dev for t in tensors) or dev.type != "cuda":
        raise ValueError(f"K11 operands must all lie on one CUDA device; got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K11 operands must be contiguous")
    lib = _library() if cand_i.shape[0] else None
    out = launch(lib, cand_d, cand_i, self_ids, vectors, degree, r_stop, alpha, metric)
    if cand_i.shape[0]:
        global LAUNCHES
        with _LOCK:
            LAUNCHES += 1
    return out


def launch(lib, cand_d, cand_i, self_ids, vectors, degree: int, r_stop: int, alpha: float, metric: str):
    """One launch of a K11 library (:func:`bind`) on checked, contiguous
    operands on one CUDA device (none for an empty batch); counts nothing.
    Raises if it is refused."""
    B, P = cand_i.shape
    cap, D = vectors.shape
    out = torch.empty((B, degree), dtype=torch.int32, device=cand_i.device)
    if B == 0:
        return out
    with torch.cuda.device(cand_i.device):
        stream = torch.cuda.current_stream(cand_i.device).cuda_stream
        rc = lib.semadb_vamana_robust_prune(
            vectors.data_ptr(), cap, D, cand_d.data_ptr(), cand_i.data_ptr(), self_ids.data_ptr(), B, P,
            degree, r_stop, float(alpha), METRIC_FLAGS[metric], out.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.semadb_vamana_prune_error_string(rc).decode()
        raise RuntimeError(f"K11 launch failed ({rc}: {msg}) at cap={cap} D={D} B={B} P={P} R={degree}")
    return out


def _check(cand_d, cand_i, self_ids, vectors, degree, metric) -> None:
    if metric not in METRIC_FLAGS:
        raise ValueError(f"K11 takes the metrics {sorted(METRIC_FLAGS)}, got {metric}")
    if cand_d.dtype != torch.float32 or vectors.dtype != torch.float32:
        raise TypeError("cand_d and vectors must be float32")
    if cand_i.dtype != torch.int32 or self_ids.dtype != torch.int32:
        raise TypeError("cand_i and self_ids must be int32")
    if cand_d.shape != cand_i.shape or cand_i.dim() != 2 or self_ids.shape != (cand_i.shape[0],):
        raise ValueError(f"shapes do not fit: cand_d {tuple(cand_d.shape)} cand_i {tuple(cand_i.shape)} "
                         f"self_ids {tuple(self_ids.shape)}")
    if vectors.dim() != 2 or not (1 <= cand_i.shape[1] <= MAX_P and 1 <= vectors.shape[1] <= MAX_D):
        raise ValueError(f"K11 needs 1 <= P <= {MAX_P} and vectors f32[cap, D <= {MAX_D}]")
    if degree < 1:
        raise ValueError(f"degree bound must be positive, got {degree}")
    if metric == C.DISTANCE_HAVERSINE and vectors.shape[1] != 2:
        raise ValueError(f"haversine takes 2-d points, got D={vectors.shape[1]}")


def bind(path: str):
    """Load a library built from a K11 source with this C interface."""
    lib = ctypes.CDLL(path)
    lib.semadb_vamana_robust_prune.restype = ctypes.c_int
    lib.semadb_vamana_robust_prune.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.semadb_vamana_prune_error_string.restype = ctypes.c_char_p
    lib.semadb_vamana_prune_error_string.argtypes = [ctypes.c_int]
    return lib


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is None:
            path, BUILD_LOG = build_library("vamana_prune", SOURCE, nvcc(), NVCC_FLAGS, HEADERS)
            _LIB = bind(path)
        return _LIB
