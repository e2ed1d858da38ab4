"""Vamana bulk construction from per-cluster exact-kNN candidate pools.

Port of ``semadb_tpu/index/vamana/fastbuild.py``. The two-pass build
(insert.go:16-68: greedy-search every point, robust-prune its visited set)
spends its time in the walks; this build replaces them with dense products:

  1. k-means the batch into C ≈ N/256 clusters (``vectorstore.kmeans``
     ``kmeans_fit_large`` on a strided sample).
  2. Assign every point to its T nearest clusters (``kmeans_assign``).
  3. In each cluster, the exact pairwise distances among its members (one
     [m, m] product a cluster, G clusters a batched product) and each
     member's K nearest: a local kNN pool.
  4. ``N_RAND`` random far candidates a point, which the alpha prune keeps
     only where no kept edge dominates them: the long-range edges.
  5. The two-pass alpha schedule (pass 1 at alpha 1.0, pass 2 at the
     configured alpha, each node's current row in its pool) through
     ``build.insert_batch(pool_d=, pool_i=)``: K11's prune, the backedge
     scatter and the overflow rounds are the incremental path's, so every
     graph invariant holds by the same code. Pass 2 first merges each
     node's 2-hop neighbourhood into its pool (``_expand_pool``).
  6. The start node pointed at R spread points, and any node the start
     cannot reach attached to it (prune.go:115-151's rescue).

The k-means, the [G, m, m] products and the selections are library calls,
as they are XLA programs in the JAX package. Random candidates come from a
``torch.Generator`` seeded by the build's seed, so they are the JAX
package's in distribution, not in bits; every other piece is the JAX
package's function of the same inputs. Every ``SEMADB_VAMANA_FB_*`` knob of
the JAX module is read here, with its JAX default, except
``SEMADB_VAMANA_FB_LEAN_BYTES``, whose default is sized for an 80 GB card
(``LEAN_BYTES``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from semadb_tpu_torch.index.vamana.graph import NIL, START_ID, GraphConfig, GraphState
from semadb_tpu_torch.ops.distance import gather_distance
from semadb_tpu_torch.ops.kernels.vamana_search import merge_sorted
from semadb_tpu_torch.ops.topk import INF, smallest_k_stable

# Pool-shape knobs (the JAX package's defaults, measured at 1M x 128)
KNN_K = int(os.environ.get("SEMADB_VAMANA_FB_K", 64))  # kNN kept a cluster
ASSIGN_T = int(os.environ.get("SEMADB_VAMANA_FB_T", 2))  # clusters a point
N_RAND = int(os.environ.get("SEMADB_VAMANA_FB_RAND", 16))  # far candidates
MEMBER_TARGET = int(os.environ.get("SEMADB_VAMANA_FB_MEMBERS", 256))
KM_ITERS = int(os.environ.get("SEMADB_VAMANA_FB_KM_ITERS", 8))
# The [G, m, m] distance tensor of a group, in bytes
GROUP_BYTES = 1 << 28
# Rows a block of the random-candidate fill
RAND_BLOCK = 1 << 16
# The corpus size (n x D x 4 bytes) from which the memory-lean flow runs.
# Derivation (PERF.md §6; annbench --engine vamana --build pool at 1M x 128
# on an H100 80GB, both flows): the direct flow's peak, 5.37 GiB, is ~3.1
# GiB that does not grow with n (a chunk's pools and their dedup, k-means)
# and 2.4 KB a point (the graph's 768 B, the corpus copy's 512 B, the pools'
# 1,152 B); the lean flow drops the corpus copy (4.89 GiB) for +5% build
# time. The direct flow stays while its peak fits half the card (40 GB, the
# other half for the collections it serves): at D = 128 some 16M points, a
# corpus of 8 GiB. (The JAX package's 2 GiB was sized for a 16 GB chip.)
LEAN_BYTES = 8 << 30


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pool_group(pool_d, pool_i, member, slot, vecs, metric: str, k: int, row_off: int = 0):
    """Exact kNN within each of G clusters (``member`` i32[G, m] batch
    indices, -1 padded; ``slot`` i32[G, m] the assignment slot): each
    member's k nearest fill its pool columns [slot*k, slot*k + k), in place.

    ``row_off``: the memory-lean build gathers from the adopted graph matrix
    (batch index b at row b + row_off), and pool ids come out as node ids."""
    n = vecs.shape[0]
    G, m = member.shape
    ok = member != NIL
    mv = vecs[(member + row_off).clamp(0, n - 1).long()]  # [G, m, D]
    cross = torch.bmm(mv, mv.transpose(1, 2))
    if metric == "euclidean":
        sq = (mv * mv).sum(-1)
        pd = (sq[:, :, None] - 2.0 * cross + sq[:, None, :]).clamp(min=0.0)
    elif metric == "cosine":
        pd = 1.0 - cross
    else:  # dot
        pd = -cross
    eye = torch.eye(m, dtype=torch.bool, device=pd.device)[None]
    pd = pd.masked_fill(eye | ~ok[:, :, None] | ~ok[:, None, :], INF)
    nd, nj = smallest_k_stable(pd, k)  # [G, m, k] nearest member positions
    cand = torch.gather(member[:, None, :].expand(G, m, m), 2, nj)
    cand = torch.where(torch.isfinite(nd), cand + row_off, NIL).to(torch.int32)
    valid = ok.reshape(-1)
    rows = member.reshape(-1)[valid].long()
    cols = (slot.reshape(-1)[valid] * k)[:, None] + torch.arange(k, device=pd.device)[None, :]
    pool_d[rows[:, None], cols] = nd.reshape(-1, k)[valid].to(pool_d.dtype)
    pool_i[rows[:, None], cols] = cand.reshape(-1, k)[valid]
    return pool_d, pool_i


def _pool_rand_blk(pool_d, pool_i, vecs, seed: int, b0: int, metric: str, blk: int, n: int, row_off: int):
    """The last N_RAND pool columns of batch rows [b0, b0 + blk): random
    candidates and their distances, gathered from ``vecs`` (batch row b at
    row b + row_off), a point's own index dropped. In place."""
    dev = vecs.device
    gen = torch.Generator(device=dev).manual_seed(int(seed) * (1 << 32) + int(b0))
    hi = min(b0 + blk, n)
    rows_b = torch.arange(b0, hi, device=dev)
    rand = torch.randint(0, n, (hi - b0, N_RAND), generator=gen, device=dev)
    cap = vecs.shape[0]
    q = vecs[(rows_b + row_off).clamp(0, cap - 1)]
    rd = gather_distance(vecs, (rand + row_off).clamp(0, cap - 1), q, metric)
    self_hit = rand == rows_b[:, None]
    P = pool_i.shape[1]
    pool_d[b0:hi, P - N_RAND :] = rd.masked_fill(self_hit, INF).to(pool_d.dtype)
    pool_i[b0:hi, P - N_RAND :] = torch.where(self_hit, NIL, rand + row_off).to(torch.int32)
    return pool_d, pool_i


def build_pools(vecs: torch.Tensor, metric: str, seed: int = 0, n_rows: int = 0, row_off: int = 0,
                seconds: dict | None = None):
    """→ (pool_d f32[N, P], pool_i i32[N, P], cents f32[C, D] | None (numpy),
    reps (numpy) i32[C] | None). Pool entries are batch indices (node ids
    when ``row_off`` > 0), -1 padded; ``reps[c]`` is one member batch index
    a cluster (the query-routing representative) or -1 for an empty one.

    Memory-lean mode (``row_off`` > 0, ``n_rows`` set): ``vecs`` is the
    adopted graph matrix (batch row b at vecs[b + row_off]), and every
    gather goes through the offset. P = ASSIGN_T·KNN_K + N_RAND. Runs on the
    device but for the member grouping (an [N, T] readback and numpy
    segment packing). ``seconds`` receives the k-means' and the pools'."""
    from semadb_tpu_torch.vectorstore.kmeans import kmeans_assign, kmeans_fit_large

    dev = vecs.device
    seconds = {} if seconds is None else seconds
    n = n_rows or vecs.shape[0]
    T, K = ASSIGN_T, KNN_K
    P = T * K + N_RAND
    # bf16 pool distances at rest (SEMADB_VAMANA_FB_POOL_BF16=1): distances
    # only rank here, and every merge promotes to f32
    pdt = torch.bfloat16 if os.environ.get("SEMADB_VAMANA_FB_POOL_BF16", "0") == "1" else torch.float32
    pool_d = torch.full((n, P), INF, dtype=pdt, device=dev)
    pool_i = torch.full((n, P), NIL, dtype=torch.int32, device=dev)
    direct = row_off == 0 and n == vecs.shape[0]

    def rand_fill():
        # In blocks of RAND_BLOCK rows on both flows (the JAX package's direct
        # flow, _pool_rand, fuses the [N, N_RAND, D] gather; a block bounds it)
        for b0 in range(0, n, RAND_BLOCK):
            _pool_rand_blk(pool_d, pool_i, vecs, seed, b0, metric, RAND_BLOCK, n, row_off)

    t0 = time.perf_counter()
    if n <= 4 * MEMBER_TARGET:
        # A small batch: one cluster holding everything
        member = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
        slot = torch.zeros((1, n), dtype=torch.int32, device=dev)
        _pool_group(pool_d, pool_i, member, slot, vecs, metric, min(K, n - 1), row_off=row_off)
        rand_fill()
        _sync(dev)
        seconds.update(kmeans_s=0.0, pools_s=time.perf_counter() - t0)
        return pool_d, pool_i, None, None

    C = max(16, n // MEMBER_TARGET)
    # Centroids from a strided sample: the pools need a reasonable partition,
    # not converged centroids
    km_cap = int(os.environ.get("SEMADB_VAMANA_FB_KM_SAMPLE", 1 << 18))
    km_cap = max(km_cap, 32 * C)
    stride = max(1, n // km_cap) if n > km_cap else 1
    fit_rows = vecs if stride == 1 and direct else vecs[row_off : row_off + n : stride]

    def assign(cents_t, t):
        if direct:
            return kmeans_assign(vecs, cents_t, t=t).cpu().numpy()  # [N, t]
        # The adopted matrix's rows gathered block by block: a whole-corpus
        # slice would be a corpus-sized transient
        rows = torch.arange(row_off, row_off + n, dtype=torch.int32, device=dev)
        return kmeans_assign(vecs, cents_t, t=t, row_ids=rows).cpu().numpy()

    # Cross-cluster pool mixing (SEMADB_VAMANA_FB_MIX=m): the last m of the T
    # assignment slots come from an independent partition (another seed)
    mix = max(min(int(os.environ.get("SEMADB_VAMANA_FB_MIX", 0)), T - 1), 0)
    cents, _ = kmeans_fit_large(fit_rows, C, seed=seed, iters=KM_ITERS)
    asn = assign(cents, T - mix)
    C_total = C
    if mix:
        cents_b, _ = kmeans_fit_large(fit_rows, C, seed=seed + 7919, iters=KM_ITERS)
        asn = np.concatenate([asn, assign(cents_b, mix) + C], axis=1)
        C_total = 2 * C
    t1 = time.perf_counter()
    seconds["kmeans_s"] = t1 - t0

    # Host segment packing: entries (cluster, point, slot) grouped by cluster
    flat_c = asn.reshape(-1).astype(np.int64)  # entry order: point-major
    flat_p = np.repeat(np.arange(n, dtype=np.int32), T)
    flat_t = np.tile(np.arange(T, dtype=np.int32), n)
    order = np.argsort(flat_c, kind="stable")
    counts = np.bincount(flat_c, minlength=C_total)
    # Members a cluster are capped: a heavy cluster's points past the cap
    # keep their other assignment's pool and random edges
    m_max = _round_up(min(int(counts.max()), 4 * MEMBER_TARGET * T), 128)
    starts = np.zeros(C_total + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    pos = np.arange(n * T, dtype=np.int64) - starts[flat_c[order]]
    keep = pos < m_max
    member = np.full((C_total, m_max), NIL, np.int32)
    slot = np.zeros((C_total, m_max), np.int32)
    member[flat_c[order][keep], pos[keep]] = flat_p[order][keep]
    slot[flat_c[order][keep], pos[keep]] = flat_t[order][keep]
    # Query-routing representatives: SEMADB_VAMANA_FB_REPS members a cluster
    # of the primary partition
    n_reps = max(1, int(os.environ.get("SEMADB_VAMANA_FB_REPS", 1)))
    reps = member[:C, 0].copy() if n_reps == 1 else member[:C, : min(n_reps, m_max)].copy()

    # Size-bucketed groups: clusters padded to power-of-two widths from 256,
    # so the padding wastes at most 2x of the product
    eff = np.minimum(counts, m_max).astype(np.int64)
    widths = []
    w = 256
    while w < m_max:
        widths.append(w)
        w *= 2
    widths.append(m_max)
    lo = 0
    for w in widths:
        sel = np.nonzero((eff > lo) & (eff <= w))[0]
        lo = w
        if len(sel) == 0:
            continue
        mb = member[sel, :w]
        sb = slot[sel, :w]
        G = max(8, min(len(sel), GROUP_BYTES // max(w * w * 4, 1)))
        Cp = _round_up(len(sel), G)
        if Cp != len(sel):
            mb = np.concatenate([mb, np.full((Cp - len(sel), w), NIL, np.int32)])
            sb = np.concatenate([sb, np.zeros((Cp - len(sel), w), np.int32)])
        for g0 in range(0, Cp, G):
            _pool_group(pool_d, pool_i, torch.from_numpy(mb[g0 : g0 + G]).to(dev),
                        torch.from_numpy(sb[g0 : g0 + G]).to(dev), vecs, metric,
                        min(K, w - 1) if w <= K else K, row_off=row_off)
    rand_fill()
    _sync(dev)
    seconds["pools_s"] = time.perf_counter() - t1
    return pool_d, pool_i, cents.cpu().numpy(), reps


def _truncate_pools(pool_d, pool_i, keep: int):
    """Each point's ``keep`` nearest kNN-pool candidates and the trailing
    N_RAND random columns: the insert passes cost about linearly in the pool
    width, so rich pools are cut back before inserting."""
    P = pool_i.shape[1]
    nr = N_RAND
    kd, kj = smallest_k_stable(pool_d[:, : P - nr].float(), keep)
    ki = torch.gather(pool_i[:, : P - nr], 1, kj)
    return (torch.cat([kd.to(pool_d.dtype), pool_d[:, P - nr :]], dim=1),
            torch.cat([ki, pool_i[:, P - nr :]], dim=1))


def _expand_pool(state: GraphState, ids, vecs, pool_d, pool_i, metric: str, e1: int = 16, e2: int = 16):
    """One NN-descent round: merge each node's 2-hop neighbourhood (its first
    ``e1`` edges × their first ``e2`` edges, which after pass 1 include
    backedges) into its pool, keep the best P, duplicates removed by the
    (distance, id) merge of the walk (``merge_sorted``)."""
    cap = state.capacity
    B, P = pool_i.shape
    R = state.adjacency.shape[1]
    e1, e2 = min(e1, R), min(e2, R)
    ids = ids.to(torch.int32)
    own = state.adjacency[ids.clamp(0, cap - 1).long()][:, :e1]  # [B, e1]
    own_ok = own != NIL
    nb2 = state.adjacency[own.clamp(0, cap - 1).long()][:, :, :e2].reshape(B, e1 * e2)
    ok = (nb2 != NIL) & own_ok.repeat_interleave(e2, dim=-1) & (nb2 != ids[:, None])
    d2 = gather_distance(state.vectors, nb2.clamp(0, cap - 1), vecs, metric).masked_fill(~ok, INF)
    ni = nb2.masked_fill(~ok, NIL)
    md, mi, _ = merge_sorted(pool_d.float(), pool_i, torch.zeros_like(pool_i, dtype=torch.bool), d2, ni, P)
    return md, mi


def _topup_chunk(adjacency, ids, pool_d, pool_i, exists):
    """Backedge top-up, in place: a chunk's empty adjacency slots filled
    with their nearest pool candidates not yet linked. The alpha prune can
    leave rows under-full, and extra near edges only densify local
    navigation."""
    ids = ids.long()
    rows = adjacency[ids]  # [m, R]
    cand = pool_i  # [m, P] node ids, -1 padded
    in_row = (cand[:, :, None] == rows[:, None, :]).any(2)
    ok = (cand != NIL) & (cand != ids[:, None]) & ~in_row & exists[cand.clamp(0, exists.shape[0] - 1).long()]
    key = pool_d.masked_fill(~ok, INF)
    order = torch.argsort(key, dim=1, stable=True)
    sc = torch.gather(cand, 1, order)
    sk = torch.gather(key, 1, order)
    sc = torch.where(torch.isfinite(sk), sc, NIL)
    # Adjacent dedup: an id in two assignment slots has one distance
    dup = torch.zeros_like(sc, dtype=torch.bool)
    dup[:, 1:] = sc[:, 1:] == sc[:, :-1]
    sk = sk.masked_fill(dup, INF)
    order2 = torch.argsort(sk, dim=1, stable=True)
    sc = torch.gather(sc.masked_fill(dup, NIL), 1, order2)
    nil_mask = rows == NIL
    nil_rank = (torch.cumsum(nil_mask.to(torch.int64), dim=1) - 1).clamp(0, sc.shape[1] - 1)
    fill = torch.gather(sc, 1, nil_rank)
    adjacency[ids] = torch.where(nil_mask, fill, rows)
    return adjacency


def _adopt_vectors(state: GraphState, ids: torch.Tensor, vecs: torch.Tensor) -> GraphState:
    """Every batch vector and existence bit written up front (pools reference
    rows across chunks, so the prune needs them all), in place (the JAX
    package's _adopt_arrays and _adopt_vectors, which donate the buffers)."""
    state.vectors[ids.long()] = vecs
    state.exists[ids.long()] = True
    return state


def _connect_start(state: GraphState, ids: np.ndarray, config: GraphConfig) -> GraphState:
    """The start node's row: R evenly spread batch points (the incremental
    build grows the start's edges by backedges; this build installs them)."""
    R = config.degree_bound
    sel = ids[np.linspace(0, len(ids) - 1, min(R, len(ids))).astype(int)]
    row = np.full(R, NIL, np.int32)
    row[: len(sel)] = np.unique(sel)[: len(sel)]
    state.adjacency[START_ID] = torch.from_numpy(row).to(state.adjacency.device)
    return state


def bulk_build_pools(index, ids32: np.ndarray, vecs: torch.Tensor, l2: int) -> dict:
    """The whole pool build on a fresh graph (``index`` an IndexVamana with no
    user point; ``vecs`` f32[n, D] on its device). Writes ``index.state`` in
    place; returns the seconds of each stage and the flow taken."""
    from semadb_tpu_torch.index.vamana.build import BUILD_TIMERS, _attach_representatives, insert_batch
    from semadb_tpu_torch.index.vamana.build import reachable_mask

    config: GraphConfig = index.config
    dev = index.device
    n = len(ids32)
    chunk = int(os.environ.get("SEMADB_VAMANA_FB_CHUNK", 8192))
    ids_t = torch.from_numpy(np.ascontiguousarray(ids32)).to(dev)
    seconds: dict = {}
    timers0 = dict(BUILD_TIMERS)
    t_all = time.perf_counter()

    # Memory-lean flow for contiguous id ranges: the corpus adopted into the
    # graph matrix first and every other reference dropped; pools gather from
    # the graph matrix with a row offset, so no second corpus copy lives next
    # to the pools and the graph. Gated on the corpus's size (LEAN_BYTES).
    off = int(ids32[0]) if n else 0
    lean_bytes = int(os.environ.get("SEMADB_VAMANA_FB_LEAN_BYTES", LEAN_BYTES))
    lean = bool(n and n * int(vecs.shape[1]) * 4 >= lean_bytes
                and np.array_equal(ids32, np.arange(off, off + n, dtype=np.int32)))
    seconds["lean"] = lean
    _adopt_vectors(index.state, ids_t, vecs)
    if lean:
        vecs = None  # the graph matrix is the corpus now
        pd_b, pi_b, cents, reps = build_pools(index.state.vectors, config.metric, n_rows=n, row_off=off,
                                              seconds=seconds)
    else:
        pd_b, pi_b, cents, reps = build_pools(vecs, config.metric, seconds=seconds)
        pi_b = torch.where(pi_b != NIL, ids_t[pi_b.clamp(0, n - 1).long()], NIL)
    if cents is not None:
        # Query-routed entry: the pool k-means is a coarse quantizer too
        rep_ids = np.where(reps != NIL, ids32[np.clip(reps, 0, n - 1)], NIL)
        index.set_query_routing(cents, rep_ids.astype(np.int32))
    trunc = int(os.environ.get("SEMADB_VAMANA_FB_TRUNC", 0))
    if trunc and trunc + N_RAND < pd_b.shape[1]:
        pd_b, pi_b = _truncate_pools(pd_b, pi_b, trunc)
    seconds["pool_width"] = int(pd_b.shape[1])

    # Pass-2 rounds that expand the pools through the current graph
    # (0 = one pass 2 from the raw pools; -1 = no pool pass 2, the refine
    # below is pass 2)
    n_expand = int(os.environ.get("SEMADB_VAMANA_FB_EXPAND", 1))
    passes = [(1.0, "pass1", False)]
    if n_expand > 0:
        passes += [(config.alpha, f"pass2.{e}", True) for e in range(n_expand)]
    elif n_expand == 0:
        passes += [(config.alpha, "pass2", False)]

    def chunk_vecs(i):
        # lean: the corpus lives only in the graph matrix
        if vecs is not None:
            return vecs[i : i + chunk]
        return index.state.vectors[ids_t[i : i + chunk].long()]

    for alpha, tag, expand in passes:
        t0 = time.perf_counter()
        for i in range(0, n, chunk):
            pd_c, pi_c = pd_b[i : i + chunk], pi_b[i : i + chunk]
            cv = chunk_vecs(i)
            if expand:
                # 2-hop pool expansion against the current graph (with pass
                # 1's backedges): the candidates a walk would have found
                pd_c, pi_c = _expand_pool(index.state, ids_t[i : i + chunk], cv, pd_c, pi_c, config.metric)
            insert_batch(index.state, ids32[i : i + chunk], cv, config, l2, intra_k=0, keep_current=True,
                         alpha=alpha, pool_d=pd_c, pool_i=pi_c)
        _sync(dev)
        seconds[f"{tag}_s"] = time.perf_counter() - t0
    # Backedge top-up (SEMADB_VAMANA_FB_TOPUP=1): under-full rows filled
    # with their nearest unused pool candidates
    t0 = time.perf_counter()
    if os.environ.get("SEMADB_VAMANA_FB_TOPUP", "0") == "1":
        for i in range(0, n, chunk):
            _topup_chunk(index.state.adjacency, ids_t[i : i + chunk], pd_b[i : i + chunk], pi_b[i : i + chunk],
                         index.state.exists)
    _connect_start(index.state, ids32, config)
    _sync(dev)
    seconds["topup_s"] = time.perf_counter() - t0
    del pd_b, pi_b

    # A beam-search polish (IndexVamana.refine: a keep_current pass at the
    # configured alpha), the knob that separates pool quality from navigation
    t0 = time.perf_counter()
    n_refine = int(os.environ.get("SEMADB_VAMANA_FB_REFINE", 0))
    if n_refine:
        refine_l = int(os.environ.get("SEMADB_VAMANA_FB_REFINE_L", 0))
        seed_own = os.environ.get("SEMADB_VAMANA_FB_SEED_OWN", "0") == "1"
        index.refine(passes=n_refine, search_size=refine_l, seed_own=seed_own)
    # The straggler rescue (prune.go:115-151): a node the start cannot reach
    # is attached to a spread representative set
    unreach = index.state.exists & ~reachable_mask(index.state)
    if bool(unreach.any()):
        _attach_representatives(index.state, unreach, config)
    _sync(dev)
    seconds["refine_rescue_s"] = time.perf_counter() - t0
    seconds["build_s"] = time.perf_counter() - t_all
    seconds["batches"] = BUILD_TIMERS["batches"] - timers0["batches"]
    seconds["overflow_rounds"] = BUILD_TIMERS["overflow_rounds"] - timers0["overflow_rounds"]
    return seconds
