"""Operands for holding K10 and K11 against their plain versions, and their
least traffic.

K10's quantized routes take codes (:func:`bit_codes`, :func:`adc_codes`):
packed bits of a graph's vectors and its queries, or PQ codes with ADC
tables, integer-valued (every sum exact in f32, so a route must equal its
plain version bit for bit) or real-valued.

Random graphs, queries and prune pools made from a numpy seed, for the card
tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py``; the operands of
K10 and K11 at the Vamana cell's shapes on a built index (:func:`cell_walks`,
:func:`cell_pools`, for ``chip_smoke.py``); and the bytes each kernel must
move for given operands (:func:`k10_least_bytes`, :func:`k11_least_bytes`),
from which ``chip_smoke.py`` takes their bounds. With
``integer=True`` every coordinate is an integer in [-8, 8] (the start row
too), so that at D ≤ 128 every euclidean, dot and cosine term and sum is
exact in f32 and a kernel must equal its plain version bit for bit; haversine
points are then integer degrees, whose meters are not exact but are computed
by the same operations on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.ops.distance import gather_distance
from semadb_tpu_torch.ops.kernels import vamana_search
from semadb_tpu_torch.ops.topk import sort_by_distance

NIL = -1
START_ID = C.START_NODE_ID
CELL_PASS1_B = 512  # a pass-1 insert batch of the 1M cell (INSERT_CHUNK)
CELL_PASS2_B = 4096  # a pass-2 batch (PASS2_CHUNK)


def _points(rng, n: int, dim: int, integer: bool, metric: str) -> np.ndarray:
    if metric == C.DISTANCE_HAVERSINE:
        if integer:
            return rng.integers(-8, 9, (n, 2)).astype(np.float32)
        return np.stack([rng.uniform(-80, 80, n), rng.uniform(-180, 180, n)], 1).astype(np.float32)
    if integer:
        return rng.integers(-8, 9, (n, dim)).astype(np.float32)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    if metric in (C.DISTANCE_COSINE, C.DISTANCE_DOT):
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def random_graph(n: int, dim: int, degree: int, *, integer: bool, metric: str, seed: int, device,
                 nil_rows: float = 0.25):
    """A graph of ``n`` user points (ids 2..n+1) and the start node (id 1):
    vectors f32[n + 2, D] (row 0 zero) and adjacency i32[n + 2, R] of random
    edges to ids in [1, n + 2), a node's own id never among them; a share
    ``nil_rows`` of the rows keep a random number of edges, the rest -1."""
    rng = np.random.default_rng(seed)
    cap = n + 2
    vectors = np.zeros((cap, dim), np.float32)
    vectors[1:] = _points(rng, cap - 1, dim, integer, metric)
    adjacency = rng.integers(1, cap, (cap, degree)).astype(np.int32)
    own = np.arange(cap)[:, None]
    adjacency = np.where(adjacency == own, np.where(own == START_ID, NIL, START_ID), adjacency).astype(np.int32)
    short = rng.random(cap) < nil_rows
    keep = rng.integers(0, degree + 1, cap)
    adjacency[np.arange(degree)[None, :] >= np.where(short, keep, degree)[:, None]] = NIL
    adjacency[0] = NIL
    return (torch.from_numpy(vectors).to(device), torch.from_numpy(adjacency).to(device))


def random_queries(b: int, dim: int, *, integer: bool, metric: str, seed: int, device) -> torch.Tensor:
    return torch.from_numpy(_points(np.random.default_rng(seed), b, dim, integer, metric)).to(device)


def random_seeds(b: int, s: int, cap: int, *, seed: int, device) -> torch.Tensor:
    """Seed ids i32[B, S] in [1, cap) with a quarter of them -1."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(1, cap, (b, s)).astype(np.int32)
    seeds[rng.random((b, s)) < 0.25] = NIL
    return torch.from_numpy(seeds).to(device)


def prune_pools(vectors: torch.Tensor, b: int, p: int, metric: str, *, seed: int):
    """Pools for K11: self ids i32[B] and per node P candidates (random ids,
    repeats and the node's own id among them, a random tail of -1) with their
    distances to the node, sorted by (distance, id), (inf, -1) empty."""
    rng = np.random.default_rng(seed)
    cap = vectors.shape[0]
    dev = vectors.device
    self_ids = rng.integers(2, cap, b).astype(np.int32)
    cand = rng.integers(1, cap, (b, p)).astype(np.int32)
    cand[:, 0] = self_ids
    cand[rng.random((b, p)) < 0.05] = NIL
    cand[np.arange(p)[None, :] >= rng.integers(p // 2, p + 1, b)[:, None]] = NIL
    cand_t = torch.from_numpy(cand).to(dev)
    self_t = torch.from_numpy(self_ids).to(dev)
    d = gather_distance(vectors, cand_t.clamp(0, cap - 1), vectors[self_t.long()], metric)
    d = d.masked_fill(cand_t == NIL, float("inf"))
    d, i = sort_by_distance(d, cand_t)
    return d.contiguous(), i.contiguous(), self_t


def bit_codes(vectors: torch.Tensor, queries: torch.Tensor, *, zero_rows: float = 0.0, seed: int = 0):
    """K10's bit-route operands from a graph: the vectors' and the queries'
    signs packed (bit i set where x_i > 0; the JAX package's u32 words as
    int32), with a share ``zero_rows`` of the code rows and of the query
    codes all zero (jaccard's union == 0). Hamming distances are integers
    and tie across many ids. → (codes i32[cap, W], query codes i32[B, W])."""
    from semadb_tpu_torch.ops.bitops import binarize

    codes = binarize(vectors, torch.zeros((), device=vectors.device), vectors.shape[1]).contiguous()
    qcodes = binarize(queries, torch.zeros((), device=queries.device), queries.shape[1]).contiguous()
    if zero_rows:
        rng = np.random.default_rng(seed)
        codes[torch.from_numpy(rng.random(codes.shape[0]) < zero_rows).to(codes.device)] = 0
        qcodes[torch.from_numpy(rng.random(qcodes.shape[0]) < zero_rows).to(qcodes.device)] = 0
    return codes, qcodes


def adc_codes(cap: int, b: int, m: int, k: int, *, integer: bool, seed: int, device):
    """K10's ADC-route operands: PQ codes u8[cap, M] uniform in [0, k) and
    ADC tables f32[B, M, K], integer-valued in [0, 16] (every sum of M <= 96
    terms exact in f32; many ties) or uniform reals in [0, 4)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (cap, m)).astype(np.uint8)
    if integer:
        tables = rng.integers(0, 17, (b, m, k)).astype(np.float32)
    else:
        tables = (rng.random((b, m, k)) * 4).astype(np.float32)
    return torch.from_numpy(codes).to(device), torch.from_numpy(tables).to(device)


def k10_least_bytes(vectors, adjacency, queries, search_size: int, expand_width: int, max_hops: int, metric: str,
                    seeds=None, track_visited: bool = True, codes=None) -> dict:
    """The bytes a K10 call on these operands must move: each distinct row
    that the batch's walks score (the start node, the seeds, the neighbours
    of every expanded node: its f32 row, or with ``codes`` its code row) and
    each distinct adjacency row they read, once for the whole batch, plus
    the queries (or their codes or tables) and seeds read and the outputs
    written once. The rows come from a run of the plain version whose merges
    are watched: every id merged in was scored, every expanded id's row was
    read. Returns the bytes with the distinct and the total counts."""
    cap, dim = vectors.shape
    degree = adjacency.shape[1]
    scored = torch.zeros(cap, dtype=torch.bool, device=vectors.device)
    expanded = torch.zeros_like(scored)
    scored[START_ID] = True
    merge = vamana_search.merge_sorted

    def watched(dists, ids, exp, new_d, new_i, L, compact=True):
        scored[new_i[new_i != NIL].long()] = True
        expanded[ids[exp & (ids != NIL)].long()] = True
        return merge(dists, ids, exp, new_d, new_i, L, compact)

    vamana_search.merge_sorted = watched
    try:
        out = vamana_search.beam_search_plain(vectors, adjacency, queries, search_size, expand_width, max_hops,
                                              metric, seeds, track_visited, codes)
    finally:
        vamana_search.merge_sorted = merge
    b = queries.shape[0]
    v = vamana_search.ring_size(search_size, expand_width)
    rows, nodes = int(scored.sum()), int(expanded.sum())
    if codes is None:
        row_bytes, query_bytes = dim * 4, queries.numel() * 4
    else:
        row_bytes = codes.codes.shape[1] * codes.codes.element_size()
        query_bytes = codes.prepared.numel() * codes.prepared.element_size()
    io = query_bytes + (0 if seeds is None else seeds.numel() * 4) + b * (search_size + v) * 8 + b * 12
    total_nodes, total_rows = (int(x) for x in out.counts.sum(0).tolist())
    return {"bytes": rows * row_bytes + nodes * degree * 4 + io, "distinct_rows_scored": rows,
            "distinct_nodes_expanded": nodes, "rows_scored": total_rows + b, "nodes_expanded": total_nodes}


def k11_least_bytes(cand_d, cand_i, self_ids, dim: int, degree: int) -> dict:
    """The bytes a K11 call on these pools must move: each distinct live
    candidate's row once for the whole batch (a pool's live candidates are
    neither -1 nor the node itself, at a finite distance), the pools and
    self ids read and the rows written once."""
    live = (cand_i != NIL) & (cand_i != self_ids[:, None]) & torch.isfinite(cand_d)
    rows = int(torch.unique(cand_i[live]).numel())
    io = cand_i.numel() * 8 + self_ids.numel() * 4 + self_ids.numel() * degree * 4
    return {"bytes": rows * dim * 4 + io, "distinct_rows": rows, "live_rows": int(live.sum())}


def cell_walks(idx, queries: np.ndarray, batch: int, search_size: int) -> dict:
    """K10's operands on a built ``IndexVamana``: name → (arguments, shape).
    ``query``: the first ``batch`` queries at L = ``search_size``, W = 2,
    their entry seeds, no ring; ``pass1`` and ``pass2``: the index's first
    points as an insert batch walks them (L = its searchSize, W = BUILD_W,
    the ring, compacted)."""
    from semadb_tpu_torch.index.vamana import build

    st, cfg = idx.state, idx.config
    q = torch.from_numpy(np.ascontiguousarray(queries[:batch], np.float32)).to(idx.device)
    seeds = idx._seeds_for(q)
    walks = {"query": ((st.vectors, st.adjacency, q, search_size, 2, 0, cfg.metric, seeds, False),
                       f"the cell's query walk: B={batch}, L={search_size}, W=2, R={cfg.degree_bound}, "
                       f"D={cfg.dim}, {seeds.shape[1]} entry seeds, no ring")}
    for name, n in (("pass1", CELL_PASS1_B), ("pass2", CELL_PASS2_B)):
        walks[name] = ((st.vectors, st.adjacency, st.vectors[2 : 2 + n].contiguous(), cfg.search_size,
                        build.BUILD_W, 0, cfg.metric, None, True),
                       f"pass {name[-1]}'s walk: B={n}, L={cfg.search_size}, W={build.BUILD_W}, ring, compacted")
    return walks


def cell_pools(idx) -> dict:
    """K11's operands on a built ``IndexVamana``: name → (arguments, shape).
    ``pass2``: the pools an insert makes for the index's first 4,096 points
    (ring, 8 in-batch peers, current out-edges) at its alpha; ``pass1``: the
    first 512's (ring and peers) at alpha 1.0; ``overflow``: one overflow
    round, the first OVERFLOW_CHUNK targets that the backedges of those
    4,096 points' rows overflow (appended, where there is room, to a copy of
    the adjacency), each with its edges and pending sources (P = R + k_in)."""
    from semadb_tpu_torch.index.vamana import build
    from semadb_tpu_torch.index.vamana.graph import GraphState

    st, cfg = idx.state, idx.config
    R, r_stop = cfg.degree_bound, build.r_stop(cfg)
    pids = torch.arange(2, 2 + CELL_PASS2_B, device=idx.device, dtype=torch.int32)
    pv = st.vectors[pids.long()].contiguous()
    pd, pi = build.candidate_pools(st, pids, pv, cfg, cfg.search_size, 8, own_edges=st.adjacency[pids.long()],
                                   expand_width=build.BUILD_W)
    n1 = CELL_PASS1_B
    qd, qi = build.candidate_pools(st, pids[:n1], pv[:n1], cfg, cfg.search_size, 8, expand_width=build.BUILD_W)
    gs = GraphState(st.vectors, st.adjacency.clone(), st.exists)
    targets, sources, pending = build.backedges(gs, pids, gs.adjacency[pids.long()].clone(), cfg)
    pools = build.overflow_pools(gs, targets, sources, pending, cfg, build.OVERFLOW_CHUNK, R)
    if pools is None:
        raise ValueError("no backedge target of the index's graph overflowed")
    sel, od, oi = pools
    return {
        "pass2": ((pd.contiguous(), pi.to(torch.int32).contiguous(), pids, st.vectors, R, r_stop, cfg.alpha,
                   cfg.metric),
                  f"pass 2's prune: B={CELL_PASS2_B}, P={pi.shape[1]} (ring + 8 peers + {R} own edges), R={R}, "
                  f"alpha {cfg.alpha}, the cell's own pools"),
        "pass1": ((qd.contiguous(), qi.to(torch.int32).contiguous(), pids[:n1], st.vectors, R, r_stop, 1.0,
                   cfg.metric),
                  f"pass 1's prune: B={n1}, P={qi.shape[1]}, alpha 1.0"),
        "overflow": ((od.contiguous(), oi.to(torch.int32).contiguous(), sel.to(torch.int32), st.vectors, R, r_stop,
                      cfg.alpha, cfg.metric),
                     f"one overflow round: B={sel.shape[0]} targets, P={oi.shape[1]} (R + k_in), alpha {cfg.alpha}, "
                     f"{int(pending.sum())} pending backedges"),
    }
