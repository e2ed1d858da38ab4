"""Hand-written CUDA kernel K10: the Vamana beam search, one launch a batch.

Replaces the XLA program of ``semadb_tpu/index/vamana/search.py`` ·
``beam_search`` (``:123-246``): a ``lax.while_loop`` of hops, each taking the
W earliest unexpanded entries of every query's sorted candidate list, scoring
their neighbours and merging them in (``_merge_sorted``, ``:76-113``). The
kernel source is ``semadb_tpu_torch/csrc/vamana_search.cu``; a team of warps
a query runs the whole walk with its list, its visited ring and its survivors
in shared memory (one warp a query at the query walk's shape, a block of 4 or
8 warps at the build's: the kernel picks its geometry from the sizes), and
merges by sorting only the new entries that can enter the list. It is bound
by bytes, and its header says what the design does about that. Built like
K3, K4 and K9: ``nvcc`` for ``sm_90a`` into ``semadb_tpu_torch/_build/`` at
first use, loaded with ``ctypes``.

The scoring is the JAX ``_make_gd``'s (``search.py:47-65``), one route a
template instance of the walk, picked by ``codes`` (:class:`Codes`):

  - ``f32``: the rows ``vectors`` f32[cap, D] by the metric
    (``ops/distance.py:96-123`` ``gather_distance``), 8 lanes a row, 16-byte
    loads;
  - ``bit`` (a binary quantizer): packed codes i32[cap, W] against each
    query's code, hamming or jaccard (``gather_bit_distance``,
    ``ops/distance.py:154-171``), one lane a row, a whole row in one
    16-byte load at D <= 128;
  - ``adc`` (a product quantizer): PQ codes u8[cap, M] summed through each
    query's ADC table f32[M, K] (``pq_gather_distance``,
    ``vectorstore/store.py:316-326``), one lane a row; the table is staged
    in shared memory when it holds at most 32 KB (M <= 32 at K = 256) and
    read through L2 when it is larger (e.g. D = 1536, M = 96): a route chosen
    by size.

:func:`vamana_beam_search` returns :class:`BeamOut`: the candidate list
(f32, i32)[B, L], the visited ring (f32, i32)[B, V] sorted by (distance,
id), V = ⌈2L/W⌉·W, the hops each query took i32[B] and its counts i32[B, 2]
(nodes expanded, neighbour and seed rows scored). For CPU tensors it runs
:func:`beam_search_plain`; for CUDA tensors it launches the kernel or raises,
it never falls back. ``LAUNCHES`` counts launches, ``LAUNCHES_BY`` by route.

The walk is the JAX program's, with one difference that changes no result a
caller reads: the JAX loop runs while any query of the batch has a pending
entry, where here each query stops when it has none. A query with nothing
pending is left as it was by a JAX step, except that an uncompacted list
(a walk without the ring, the plain query walk) has its holes moved to the tail;
``search`` drops the holes, so its results are the same. Ties: the merge
sorts by (distance, id) with the list's incumbent entry first, as the stable
``jax.lax.sort`` does; -0.0 and 0.0 are equal there, as in ``lax.sort``.
Quantized distances tie constantly across ids, and the (d, id) key orders
them.

Tolerance: on integer-valued vectors (|x| ≤ 8, D ≤ 128) every distance is
exact in f32 and the kernel's outputs equal the plain version's bit for bit;
on real-valued data the sums run in another order, so distances agree to
about 1e-6 of the summed terms' magnitude, and walks may part at a near-tie.
The bit route equals the plain version bit for bit (integer distances, and
jaccard's one IEEE division); the ADC route does on integer-valued tables,
and on real-valued ones agrees to 1e-6 of the summed terms.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading
from typing import NamedTuple, Optional

import torch

from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.ops.distance import gather_bit_distance, gather_distance
from semadb_tpu_torch.ops.topk import sort_by_distance
from semadb_tpu_torch.utils.build import CSRC_DIR, NVCC_FLAGS, build_library, nvcc
from semadb_tpu_torch.vectorstore.store import pq_gather_distance

SOURCE = os.path.join(CSRC_DIR, "vamana_search.cu")
HEADERS = (os.path.join(CSRC_DIR, "vamana_common.cuh"), os.path.join(CSRC_DIR, "smem_optin.cuh"))
METRIC_FLAGS = {C.DISTANCE_EUCLIDEAN: 0, C.DISTANCE_DOT: 1, C.DISTANCE_COSINE: 2, C.DISTANCE_HAVERSINE: 3}
MAX_L = 512
MAX_WR = 512
MAX_M = 2048  # the merge buffer's longest padded length
MAX_D = 4096
NIL = -1
START_ID = C.START_NODE_ID
BIT_FLAGS = {C.DISTANCE_HAMMING: 0, C.DISTANCE_JACCARD: 1}
ROUTE_FLAGS = {"bit": 1, "adc": 2}
MAX_K = 256  # centroids a subvector
KERNELS = ("vamana_beam_search_kernel",)  # the name inside every instance of the template

LAUNCHES = 0
LAUNCHES_BY: collections.Counter = collections.Counter()  # route -> launches
BUILD_LOG = ""

_LIB = None
_LOCK = threading.Lock()


class BeamOut(NamedTuple):
    cand_dists: torch.Tensor  # f32[B, L]
    cand_ids: torch.Tensor  # i32[B, L]
    visited_dists: torch.Tensor  # f32[B, V], sorted by (d, id)
    visited_ids: torch.Tensor  # i32[B, V]
    hops: torch.Tensor  # i32[B]: hops each query took
    counts: torch.Tensor  # i32[B, 2]: nodes expanded, rows scored


class Codes(NamedTuple):
    """A quantized walk's operands: ``kind`` "binary" (``codes`` i32[cap, W]
    packed bits, ``prepared`` i32[B, W] the queries' codes, ``bit_metric``
    hamming or jaccard) or "product" (``codes`` u8[cap, M], ``prepared``
    f32[B, M, K] the queries' ADC tables)."""

    kind: str
    codes: torch.Tensor
    prepared: torch.Tensor
    bit_metric: str = C.DISTANCE_HAMMING


def route_of(codes: Optional[Codes]) -> str:
    """The scoring route of a walk: "f32", "bit" or "adc"."""
    if codes is None:
        return "f32"
    return "bit" if codes.kind == "binary" else "adc"


def ring_size(search_size: int, expand_width: int) -> int:
    """V: about 2L visited slots, a multiple of W (search.py:170-173)."""
    return ((2 * search_size + expand_width - 1) // expand_width) * expand_width


def default_max_hops(search_size: int, expand_width: int) -> int:
    return (3 * search_size + expand_width - 1) // expand_width


def merge_sorted(dists, ids, exp, new_d, new_i, L: int, compact: bool = True):
    """``_merge_sorted``: the list and the new entries sorted by (d, id), the
    list's entry first among equal keys; an id equal to its predecessor's
    becomes (inf, -1); with ``compact`` sorted again; the first L."""
    md = torch.cat([dists, new_d], dim=-1)
    mi = torch.cat([ids, new_i], dim=-1)
    me = torch.cat([exp, torch.zeros_like(new_i, dtype=torch.bool)], dim=-1)
    md, mi, me = sort_by_distance(md, mi, me)
    dup = torch.zeros_like(me)
    dup[..., 1:] = mi[..., 1:] == mi[..., :-1]
    dup &= mi != NIL
    md = md.masked_fill(dup, float("inf"))
    mi = mi.masked_fill(dup, NIL)
    me = me & ~dup
    if compact:
        md, mi, me = sort_by_distance(md, mi, me)
    return md[..., :L], mi[..., :L], me[..., :L]


def beam_search_plain(
    vectors: torch.Tensor, adjacency: torch.Tensor, queries: torch.Tensor, search_size: int,
    expand_width: int, max_hops: int, metric: str, seeds: Optional[torch.Tensor] = None,
    track_visited: bool = True, codes: Optional[Codes] = None,
) -> BeamOut:
    """Plain PyTorch version: the JAX loop hop by hop, a query updated only
    while it has a pending entry. With ``track_visited`` the hops' merges
    compact (``compact_merge``'s JAX default). ``codes`` scores by the
    quantized route (the JAX ``_make_gd``)."""
    _check(vectors, adjacency, queries, search_size, expand_width, metric, seeds, codes)
    B = queries.shape[0]
    cap, R = adjacency.shape
    L, W = search_size, expand_width
    V = ring_size(L, W)
    max_hops = max_hops if max_hops > 0 else default_max_hops(L, W)
    dev = queries.device
    inf = float("inf")

    def gd(ids):
        ids = ids.clamp(0, cap - 1)
        if codes is None:
            return gather_distance(vectors, ids, queries, metric)
        if codes.kind == "binary":
            return gather_bit_distance(codes.codes, ids, codes.prepared, codes.bit_metric)
        return pq_gather_distance(codes.codes, ids, codes.prepared, codes.prepared.shape[2])

    cand_d = torch.full((B, L), inf, dtype=torch.float32, device=dev)
    cand_i = torch.full((B, L), NIL, dtype=torch.int32, device=dev)
    cand_d[:, 0] = gd(torch.full((B, 1), START_ID, dtype=torch.int32, device=dev))[:, 0]
    cand_i[:, 0] = START_ID
    cand_e = torch.zeros((B, L), dtype=torch.bool, device=dev)
    counts = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    if seeds is not None and seeds.shape[1] > 0:
        ok = (seeds != NIL) & (seeds != START_ID)
        sd = gd(seeds).masked_fill(~ok, inf)
        si = seeds.masked_fill(~ok, NIL)
        cand_d, cand_i, cand_e = merge_sorted(cand_d, cand_i, cand_e, sd, si, L, compact=True)
        counts[:, 1] += ok.sum(-1, dtype=torch.int32)
    vis_d = torch.full((B, V), inf, dtype=torch.float32, device=dev)
    vis_i = torch.full((B, V), NIL, dtype=torch.int32, device=dev)
    hops = torch.zeros(B, dtype=torch.int32, device=dev)
    pos_l = torch.arange(L, device=dev)
    for hop in range(max_hops):
        unexp = (cand_i != NIL) & ~cand_e & torch.isfinite(cand_d)
        active = unexp.any(-1)
        if not bool(active.any()):
            break
        # The W earliest unexpanded positions (then, past those, the earliest
        # others, which are not selected)
        pos = torch.sort(torch.where(unexp, pos_l, pos_l + L), dim=-1).values[:, :W] % L
        sel_ok = torch.gather(unexp, 1, pos)
        cur = torch.gather(cand_i, 1, pos)
        cur_d = torch.gather(cand_d, 1, pos)
        cand_e = cand_e.clone()
        cand_e.scatter_(1, pos, torch.gather(cand_e, 1, pos) | sel_ok)
        if track_visited:
            slot = (hop % (V // W)) * W
            vis_i[:, slot : slot + W] = torch.where(sel_ok, cur, vis_i[:, slot : slot + W])
            vis_d[:, slot : slot + W] = torch.where(sel_ok, cur_d, vis_d[:, slot : slot + W])
        nbr = adjacency[cur.clamp(0, cap - 1).long()].reshape(B, W * R)
        nbr_ok = (nbr != NIL) & sel_ok.repeat_interleave(R, dim=-1)
        nd = gd(nbr).masked_fill(~nbr_ok, inf)
        ni = nbr.masked_fill(~nbr_ok, NIL)
        md, mi, me = merge_sorted(cand_d, cand_i, cand_e, nd, ni, L, compact=track_visited)
        a = active[:, None]
        cand_d = torch.where(a, md, cand_d)
        cand_i = torch.where(a, mi, cand_i)
        cand_e = torch.where(a, me, cand_e)
        hops += active.to(torch.int32)
        counts[:, 0] += sel_ok.sum(-1, dtype=torch.int32)
        counts[:, 1] += nbr_ok.sum(-1, dtype=torch.int32)
    vis_d, vis_i = sort_by_distance(vis_d, vis_i)
    return BeamOut(cand_d, cand_i, vis_d, vis_i, hops, counts)


def vamana_beam_search(
    vectors: torch.Tensor, adjacency: torch.Tensor, queries: torch.Tensor, search_size: int,
    expand_width: int, max_hops: int, metric: str, seeds: Optional[torch.Tensor] = None,
    track_visited: bool = True, codes: Optional[Codes] = None,
) -> BeamOut:
    """``vectors`` f32[cap, D], ``adjacency`` i32[cap, R], ``queries`` f32[B, D],
    ``seeds`` i32[B, S] or None, ``codes`` the quantized route's operands or
    None → :class:`BeamOut`: the kernel for CUDA tensors, the plain version
    for CPU tensors. With ``codes`` the kernel reads no row of ``vectors``
    (it gives the capacity) and no query of ``queries`` (it gives B)."""
    tensors = [vectors, adjacency, queries] + ([seeds] if seeds is not None else [])
    if codes is not None:
        tensors += [codes.codes, codes.prepared]
    if all(t.device.type == "cpu" for t in tensors):
        return beam_search_plain(vectors, adjacency, queries, search_size, expand_width, max_hops, metric,
                                 seeds, track_visited, codes)
    _check(vectors, adjacency, queries, search_size, expand_width, metric, seeds, codes)
    dev = queries.device
    if any(t.device != dev for t in tensors) or dev.type != "cuda":
        raise ValueError(f"K10 operands must all lie on one CUDA device; got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K10 operands must be contiguous")
    lib = _library() if queries.shape[0] else None
    out = launch(lib, vectors, adjacency, queries, search_size, expand_width, max_hops, metric, seeds,
                 track_visited, codes)
    if queries.shape[0]:
        global LAUNCHES
        with _LOCK:
            LAUNCHES += 1
            LAUNCHES_BY[route_of(codes)] += 1
    return out


def buffer_size(search_size: int, expand_width: int, degree: int, n_seeds: int) -> int:
    """M: the merge buffer's length, the power of two at or above the
    longest of L + W·R, L + S and V."""
    need = max(search_size + expand_width * degree, search_size + n_seeds, ring_size(search_size, expand_width))
    m = 1
    while m < need:
        m <<= 1
    return m


def launch(lib, vectors, adjacency, queries, search_size: int, expand_width: int, max_hops: int, metric: str,
           seeds, track_visited: bool, codes: Optional[Codes] = None) -> BeamOut:
    """One launch of a K10 library (:func:`bind`) on checked, contiguous
    operands on one CUDA device (none for an empty batch); counts nothing.
    Raises if it is refused, or if ``codes`` is given to a library without
    the quantized routes."""
    cap, D = vectors.shape
    R = adjacency.shape[1]
    B = queries.shape[0]
    L, W = search_size, expand_width
    V = ring_size(L, W)
    S = 0 if seeds is None else seeds.shape[1]
    dev = queries.device
    out = BeamOut(
        torch.empty((B, L), dtype=torch.float32, device=dev), torch.empty((B, L), dtype=torch.int32, device=dev),
        torch.empty((B, V), dtype=torch.float32, device=dev), torch.empty((B, V), dtype=torch.int32, device=dev),
        torch.empty((B,), dtype=torch.int32, device=dev), torch.empty((B, 2), dtype=torch.int32, device=dev),
    )
    if B == 0:
        return out
    hops = max_hops if max_hops > 0 else default_max_hops(L, W)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if codes is None:
            rc = lib.semadb_vamana_beam_search(
                vectors.data_ptr(), cap, D, adjacency.data_ptr(), R, queries.data_ptr(), B,
                seeds.data_ptr() if S else None, S, L, W, buffer_size(L, W, R, S), hops, METRIC_FLAGS[metric],
                int(track_visited), *(t.data_ptr() for t in out), stream,
            )
        else:
            if not hasattr(lib, "semadb_vamana_beam_search_codes"):
                raise RuntimeError("this K10 library has no quantized routes")
            route = route_of(codes)
            K = codes.prepared.shape[2] if route == "adc" else 0
            rc = lib.semadb_vamana_beam_search_codes(
                codes.codes.data_ptr(), cap, ROUTE_FLAGS[route], codes.codes.shape[1], K,
                BIT_FLAGS.get(codes.bit_metric, 0), adjacency.data_ptr(), R, codes.prepared.data_ptr(), B,
                seeds.data_ptr() if S else None, S, L, W, hops, int(track_visited), *(t.data_ptr() for t in out),
                stream,
            )
    if rc != 0:
        msg = lib.semadb_vamana_search_error_string(rc).decode()
        raise RuntimeError(f"K10 launch failed ({rc}: {msg}) at cap={cap} D={D} R={R} B={B} L={L} W={W} S={S}")
    return out


def _check(vectors, adjacency, queries, L, W, metric, seeds, codes=None) -> None:
    if metric not in METRIC_FLAGS:
        raise ValueError(f"K10 takes the metrics {sorted(METRIC_FLAGS)}, got {metric}")
    if vectors.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("vectors and queries must be float32")
    if adjacency.dtype != torch.int32 or (seeds is not None and seeds.dtype != torch.int32):
        raise TypeError("adjacency and seeds must be int32")
    if vectors.dim() != 2 or adjacency.dim() != 2 or queries.dim() != 2:
        raise ValueError("vectors, adjacency and queries must be matrices")
    cap, D = vectors.shape
    R = adjacency.shape[1]
    if adjacency.shape[0] != cap or queries.shape[1] != D or cap < 2:
        raise ValueError(f"shapes do not fit: vectors {tuple(vectors.shape)} adjacency {tuple(adjacency.shape)} "
                         f"queries {tuple(queries.shape)}")
    if seeds is not None and (seeds.dim() != 2 or seeds.shape[0] != queries.shape[0]):
        raise ValueError(f"seeds {tuple(seeds.shape)} do not fit queries {tuple(queries.shape)}")
    S = 0 if seeds is None else seeds.shape[1]
    if not (1 <= L <= MAX_L and 1 <= W <= L and W * R <= MAX_WR and L + S <= MAX_M and D <= MAX_D):
        raise ValueError(f"K10 needs L <= {MAX_L}, 1 <= W <= L, W*R <= {MAX_WR}, L + S <= {MAX_M} and "
                         f"D <= {MAX_D}; got L={L} W={W} R={R} S={S} D={D}")
    if metric == C.DISTANCE_HAVERSINE and D != 2:
        raise ValueError(f"haversine takes 2-d points, got D={D}")
    if codes is not None:
        _check_codes(codes, cap, queries.shape[0])


def _check_codes(codes: Codes, cap: int, B: int) -> None:
    c, p = codes.codes, codes.prepared
    if codes.kind == "binary":
        if c.dtype != torch.int32 or p.dtype != torch.int32 or c.dim() != 2 or p.dim() != 2:
            raise TypeError("binary codes and query codes must be int32 matrices")
        if codes.bit_metric not in BIT_FLAGS:
            raise ValueError(f"K10's bit route takes {sorted(BIT_FLAGS)}, got {codes.bit_metric}")
        if p.shape != (B, c.shape[1]):
            raise ValueError(f"query codes {tuple(p.shape)} do not fit codes {tuple(c.shape)} and B={B}")
    elif codes.kind == "product":
        if c.dtype != torch.uint8 or p.dtype != torch.float32 or c.dim() != 2 or p.dim() != 3:
            raise TypeError("product codes must be uint8[cap, M] and the tables float32[B, M, K]")
        if p.shape[0] != B or p.shape[1] != c.shape[1] or not 1 <= p.shape[2] <= MAX_K:
            raise ValueError(f"tables {tuple(p.shape)} do not fit codes {tuple(c.shape)} and B={B}")
    else:
        raise ValueError(f"K10 takes binary or product codes, got {codes.kind!r}")
    if c.shape[0] != cap or not 1 <= c.shape[1] <= MAX_D:
        raise ValueError(f"the code table {tuple(c.shape)} must have the graph's {cap} rows and 1-{MAX_D} columns")


def bind(path: str):
    """Load a library built from a K10 source with this C interface."""
    lib = ctypes.CDLL(path)
    lib.semadb_vamana_beam_search.restype = ctypes.c_int
    lib.semadb_vamana_beam_search.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.semadb_vamana_search_error_string.restype = ctypes.c_char_p
    lib.semadb_vamana_search_error_string.argtypes = [ctypes.c_int]
    try:
        fn = lib.semadb_vamana_beam_search_codes
    except AttributeError:  # a source from before the quantized routes
        return lib
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return lib


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is None:
            path, BUILD_LOG = build_library("vamana_search", SOURCE, nvcc(), NVCC_FLAGS, HEADERS)
            _LIB = bind(path)
        return _LIB
