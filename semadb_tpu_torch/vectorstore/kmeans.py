"""k-means for the IVF coarse quantizer, in PyTorch.

Port of the IVF subset of ``semadb_tpu/vectorstore/kmeans.py``:
:func:`kmeans_assign` (top-t nearest centroids, ``:120-155``),
:func:`kmeans_fit_large` (``:158-249``) and :func:`_kmeans_fit_gather`
(``:252-301``). Assignment is a row-blocked ``torch.matmul`` (full f32, as
``ops.distance`` requires) plus ``argmin`` / ``topk``; the centroid update is
a segment sum by ``index_add_``. The JAX package leaves these products to
XLA outside any Pallas kernel, so here they stay plain torch.

Seeding draws the initial centroids with a ``torch.Generator`` seeded from
``seed``: JAX's ``random.choice`` cannot be reproduced, so a build is held
to the JAX package's on recall, not on bits.

The two-level (super → children) coarse quantizer for cluster counts past
the flat fit's ceiling (``:304-667``): :func:`kmeans_fit_two_level` and
:func:`kmeans_assign_two_level`, over :func:`_group_rows` (a copy: host
numpy), :func:`_kmeans_grouped`, :func:`_assign_col` and :func:`_merge_top`.
Members are grouped by super and each group is scored as one dense
[m, kc] batched product; the centroid array stays flat (children of super s
at rows ``[s*kc, (s+1)*kc)``), so the query path is the flat one. Where
the JAX version gathers each row's result back through an inverse
permutation to avoid XLA:TPU scatters, this one writes it with an indexed
store: the same answer. One difference: ``_kmeans_grouped`` strides its
init over the members a group holds (``min(cnt, maxm)``); the JAX version
strides over ``cnt`` and, for a group ``_group_rows`` subsampled, reads
past the gathered members, where ``take_along_axis`` fills NaN.

Not ported: ``kmeans_fit`` and ``kmeans_fit_subvectors`` (product
quantization).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Optional

import torch


def kmeans_assign(
    data: torch.Tensor, cents: torch.Tensor, t: int = 1, row_ids: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Top-t nearest centroids per row → i32[N, t] (ascending distance).

    Row-blocked so the [NB, K] distance matrix stays ≤ 2^26 elements. With
    ``row_ids``, ``data`` is the full backing matrix and rows are gathered
    block by block (a full [N, D] gather would double peak device memory)."""
    n = row_ids.shape[0] if row_ids is not None else data.shape[0]
    k = cents.shape[0]
    sq_c = (cents * cents).sum(-1)[None, :]
    nb = max(2**26 // k, 512)
    out = torch.empty((n, t), dtype=torch.int32, device=cents.device)
    for lo in range(0, n, nb):
        blk = data[row_ids[lo : lo + nb].long()] if row_ids is not None else data[lo : lo + nb]
        dist = (blk * blk).sum(-1, keepdim=True) - 2.0 * (blk @ cents.T) + sq_c
        out[lo : lo + nb] = torch.topk(dist, t, dim=-1, largest=False, sorted=True).indices.to(torch.int32)
    return out


def kmeans_fit_large(
    data: torch.Tensor,
    k: int,
    seed: int = 0,
    iters: int = 15,
    block_rows: int = 0,
    row_ids: Optional[torch.Tensor] = None,
):
    """Large-K k-means for the IVF coarse quantizer → (centroids f32[k, d],
    labels i32[N]).

    Sampled init (k distinct rows), a fixed number of Lloyd iterations, and
    a segment-sum update; a cluster that loses every row keeps its centroid.
    The assignment is blocked over rows so the [NB, K] distance matrix stays
    ≤ 2^27 elements (at 1M x 32,768 clusters an unblocked one would be
    137 GB). With ``row_ids``, ``data`` is the full backing matrix and fit
    rows are gathered per block (:func:`_kmeans_fit_gather`)."""
    if row_ids is not None:
        return _kmeans_fit_gather(data, row_ids, k, seed, iters, block_rows)
    n = data.shape[0]
    return _lloyd(lambda lo, hi: data[lo:hi], n, data[_init_rows(n, k, seed, data.device)], iters, block_rows)


def _kmeans_fit_gather(data, row_ids, k, seed, iters, block_rows):
    """:func:`kmeans_fit_large` over rows gathered per block from the full
    matrix ``data``."""
    n = row_ids.shape[0]
    rows = row_ids.long()
    init = data[rows[_init_rows(n, k, seed, data.device)]]
    return _lloyd(lambda lo, hi: data[rows[lo:hi]], n, init, iters, block_rows)


def _init_rows(n: int, k: int, seed: int, device) -> torch.Tensor:
    """k distinct row positions in [0, n), drawn from ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=gen)[:k].to(device)


def _lloyd(block: Callable[[int, int], torch.Tensor], n: int, cents: torch.Tensor, iters: int, block_rows: int):
    k, d = cents.shape
    nb = block_rows or max(2**27 // k, 512)

    def labels_of(blk, c, sq_c):
        return torch.argmin((blk * blk).sum(-1, keepdim=True) - 2.0 * (blk @ c.T) + sq_c, dim=-1)

    for _ in range(iters):
        sq_c = (cents * cents).sum(-1)[None, :]
        sums = torch.zeros((k, d), dtype=torch.float32, device=cents.device)
        cnt = torch.zeros((k,), dtype=torch.float32, device=cents.device)
        for lo in range(0, n, nb):
            blk = block(lo, min(lo + nb, n))
            lab = labels_of(blk, cents, sq_c)
            sums.index_add_(0, lab, blk)
            cnt.index_add_(0, lab, torch.ones_like(lab, dtype=torch.float32))
        cents = torch.where((cnt > 0)[:, None], sums / cnt.clamp(min=1.0)[:, None], cents)
    sq_c = (cents * cents).sum(-1)[None, :]
    labs = torch.cat([labels_of(block(lo, min(lo + nb, n)), cents, sq_c) for lo in range(0, n, nb)])
    return cents, labs.to(torch.int32)


# ---------------------------------------------------------------------------
# Two-level (hierarchical) coarse quantization
# ---------------------------------------------------------------------------


def _group_rows(labels: "np.ndarray", n_groups: int, maxm: int):
    """Host-side grouping: row positions per label, padded/subsampled to
    ``maxm`` columns. Returns (rows i32[G, maxm], w f32[G, maxm],
    cnt i32[G]). Groups larger than maxm are strided-subsampled; empty
    groups point at row 0 with weight 0."""
    import numpy as np

    order = np.argsort(labels, kind="stable")
    ls = labels[order]
    starts = np.searchsorted(ls, np.arange(n_groups))
    ends = np.searchsorted(ls, np.arange(n_groups) + 1)
    cnt = (ends - starts).astype(np.int32)
    rows = np.zeros((n_groups, maxm), np.int32)
    w = np.zeros((n_groups, maxm), np.float32)
    if cnt.max(initial=0) <= maxm:
        # Fast path (no subsampling): one vectorized scatter by
        # within-group rank — the per-group Python loop costs seconds per
        # call at 10M rows on a 1-vCPU host.
        rank = np.arange(len(ls), dtype=np.int64) - starts[ls]
        rows[ls, rank] = order
        w[ls, rank] = 1.0
        return rows, w, cnt
    for g in range(n_groups):
        mem = order[starts[g] : ends[g]]
        m = len(mem)
        if m == 0:
            continue
        if m > maxm:
            mem = mem[np.linspace(0, m - 1, maxm).astype(np.int64)]
            m = maxm
        rows[g, :m] = mem
        w[g, :m] = 1.0
    return rows, w, cnt


def _kmeans_grouped(data, rows, w, cnt, kc: int, iters: int) -> torch.Tensor:
    """Weighted Lloyd's over member groups → cents f32[G, kc, D].

    ``data`` f32[cap, D] is the full backing matrix, ``rows`` i32[G, maxm]
    the member row ids (padded), ``w`` f32[G, maxm] their weights (0 =
    padding), ``cnt`` i32[G] the groups' sizes. The init is a stride over
    each group's gathered members (deterministic); a child that loses every
    member keeps its previous centroid."""
    G, maxm = rows.shape
    D = data.shape[1]
    mem = data[rows.long()]  # [G, maxm, D]
    live = cnt.long().clamp(1, maxm)
    pick = torch.arange(kc, device=mem.device)[None, :] * live[:, None] // kc  # [G, kc]
    cents = torch.take_along_dim(mem, pick[:, :, None], dim=1)  # [G, kc, D]
    sq_m = (mem * mem).sum(-1)  # [G, maxm]
    base = (torch.arange(G, device=mem.device) * kc)[:, None]
    wm = (mem * w[:, :, None]).reshape(-1, D)
    wf = w.reshape(-1)
    for _ in range(iters):
        sq_c = (cents * cents).sum(-1)  # [G, kc]
        cross = torch.bmm(mem, cents.transpose(1, 2))  # [G, maxm, kc]
        lab = torch.argmin(sq_m[:, :, None] - 2.0 * cross + sq_c[:, None, :], dim=-1)  # [G, maxm]
        flat = (lab + base).reshape(-1)
        sums = torch.zeros((G * kc, D), dtype=torch.float32, device=mem.device).index_add_(0, flat, wm)
        cnts = torch.zeros((G * kc,), dtype=torch.float32, device=mem.device).index_add_(0, flat, wf)
        sums, cnts = sums.reshape(G, kc, D), cnts.reshape(G, kc)
        cents = torch.where((cnts > 0)[:, :, None], sums / cnts.clamp(min=1.0)[:, :, None], cents)
    return cents


def _merge_top(cand_d, cand_i, d_col, i_col, t: int):
    """Keep the best ``t`` of the running candidates ∪ one new column."""
    dd = torch.cat([cand_d, d_col], dim=1)
    ii = torch.cat([cand_i, i_col], dim=1)
    v, oi = torch.topk(dd, t, dim=1, largest=False, sorted=True)
    return v, torch.gather(ii, 1, oi)


def _assign_col(data, lab, child, rid, t_in: int):
    """Top-``t_in`` children within each row's ``lab`` super → (dists
    f32[n, t_in], flat cluster ids i32[n, t_in]).

    Rows are sorted by super into a [G, maxm] layout (maxm = the largest
    group), scored a chunk of groups at a time as one batched product, and
    each row's result is stored back at its own position. ``rid``: row ids
    into ``data`` (None: position == id)."""
    n = lab.shape[0]
    G, kc, D = child.shape
    dev = child.device
    lab = lab.long()
    order = torch.argsort(lab, stable=True)
    ls = lab[order]
    starts = torch.searchsorted(ls, torch.arange(G + 1, device=dev))
    rank = torch.arange(n, device=dev) - starts[ls]
    maxm = max(int((starts[1:] - starts[:-1]).max()), 1)
    rows = torch.zeros((G, maxm), dtype=torch.long, device=dev)
    rows[ls, rank] = order  # padding slots keep row 0: wasted work, never read back
    # Chunk groups so the larger of the [g, maxm, D] gather and the
    # [g, maxm, kc] scores stays ~256 MB
    gchunk = max(2**26 // (maxm * max(D, kc)), 1)
    d_out = torch.empty((n, t_in), dtype=torch.float32, device=dev)
    i_out = torch.empty((n, t_in), dtype=torch.int32, device=dev)
    for g0 in range(0, G, gchunk):
        g1 = min(g0 + gchunk, G)
        j0, j1 = int(starts[g0]), int(starts[g1])
        if j0 == j1:
            continue
        rows_b = rows[g0:g1]
        mem = data[rows_b if rid is None else rid[rows_b].long()]  # [g, maxm, D]
        child_b = child[g0:g1]
        sq_c = (child_b * child_b).sum(-1)
        dd = (mem * mem).sum(-1)[:, :, None] - 2.0 * torch.bmm(mem, child_b.transpose(1, 2)) + sq_c[:, None, :]
        v, ci = torch.topk(dd, t_in, dim=-1, largest=False, sorted=True)  # [g, maxm, t_in]
        # The rows of groups g0..g1-1 are sorted positions j0..j1-1
        g_of, m_of = ls[j0:j1] - g0, rank[j0:j1]
        dst = order[j0:j1]
        d_out[dst] = v[g_of, m_of]
        i_out[dst] = (ls[j0:j1, None] * kc + ci[g_of, m_of]).to(torch.int32)
    return d_out, i_out


def kmeans_assign_two_level(
    data: torch.Tensor,
    sup_cents: torch.Tensor,
    child_flat: torch.Tensor,
    t: int,
    row_ids: Optional[torch.Tensor] = None,
    n_sup: int = 2,
) -> torch.Tensor:
    """Top-t flat cluster ids per row (i32[N, t], ascending distance),
    considering the children of each row's ``n_sup`` nearest supers: the
    two-level replacement for :func:`kmeans_assign` at cluster counts where
    the flat [N, C] scoring no longer pays. ``sup_cents`` f32[Cs, D],
    ``child_flat`` f32[Cs*kc, D]. Columns merge into the running top-t one
    at a time, so no [N, n_sup·t] buffer is held."""
    Cs = sup_cents.shape[0]
    d = data.shape[1]
    kc = child_flat.shape[0] // Cs
    child = child_flat.reshape(Cs, kc, d)
    t_in = min(t, kc)
    n_sup = min(n_sup, Cs)
    sup_t = kmeans_assign(data, sup_cents, n_sup, row_ids=row_ids)
    cand_d = cand_i = None
    for col in range(n_sup):
        d_col, i_col = _assign_col(data, sup_t[:, col], child, row_ids, t_in)
        if cand_d is None:
            cand_d, cand_i = d_col, i_col
        else:
            cand_d, cand_i = _merge_top(cand_d, cand_i, d_col, i_col, min(t, cand_d.shape[1] + t_in))
    return cand_i


def kmeans_fit_two_level(
    data: torch.Tensor,
    k: int,
    seed: int = 0,
    iters: int = 15,
    row_ids: Optional[torch.Tensor] = None,
    supers: int = 512,
    fit_maxm: int = 32768,
    refine_iters: int = 2,
    final_n_sup: int = 8,
    phase: Callable = lambda name: nullcontext(),
):
    """Hierarchical fit → (centroids f32[k, d] FLAT, labels i32[N],
    sup_cents f32[supers, d]); labels are flat ids (super·kc + child).

    ``k`` must be a multiple of ``supers``. The steps and their constants
    are the JAX package's (its docstring gives the measurements): the super
    fit on a ≤ 2^18-row stride sample; every row to its nearest super; the
    children of each super by :func:`_kmeans_grouped` over at most
    ``fit_maxm`` of its members; ``refine_iters`` global Lloyd rounds that
    reassign every row over the children of its 4 nearest supers and take
    the means (``index_add_`` in 2^20-row blocks, no [N, D] copy); final
    labels over the ``final_n_sup`` nearest supers. ``phase(name)`` is a
    context manager around each step (the refit times them with it)."""
    if k % supers:
        raise ValueError(f"a two-level fit needs the cluster count {k} to be a multiple of the supers {supers}")
    kc = k // supers
    n = row_ids.shape[0] if row_ids is not None else data.shape[0]
    d = data.shape[1]
    dev = data.device

    with phase("super_fit_s"):
        stride = max(n // 2**18, 1)
        if row_ids is not None:
            sup_cents, _ = kmeans_fit_large(data, supers, seed, iters, row_ids=row_ids[::stride].contiguous())
        else:
            sup_cents, _ = kmeans_fit_large(data[::stride], supers, seed, iters)
    with phase("super_assign_s"):
        lab_sup = kmeans_assign(data, sup_cents, 1, row_ids=row_ids)[:, 0].cpu().numpy()
    with phase("child_fit_s"):
        gchunk = max(2**26 // max(fit_maxm * max(d, kc), 1), 1)
        rows_np, w_np, cnt_np = _group_rows(lab_sup, supers, fit_maxm)
        if row_ids is not None:
            rows_np = row_ids.cpu().numpy()[rows_np]
        child = torch.cat([
            _kmeans_grouped(
                data, torch.from_numpy(rows_np[g0 : g0 + gchunk]).to(dev),
                torch.from_numpy(w_np[g0 : g0 + gchunk]).to(dev),
                torch.from_numpy(cnt_np[g0 : g0 + gchunk]).to(dev), kc, iters,
            )
            for g0 in range(0, supers, gchunk)
        ])
        child_flat = child.reshape(k, d)
    blk = 1 << 20
    for it in range(refine_iters):
        with phase(f"refine_{it}_s"):
            lab_r = kmeans_assign_two_level(data, sup_cents, child_flat, 1, row_ids=row_ids, n_sup=4)[:, 0].long()
            ssum = torch.zeros((k, d), dtype=torch.float32, device=dev)
            cnt = torch.zeros((k,), dtype=torch.float32, device=dev)
            for i in range(0, n, blk):
                lab_b = lab_r[i : i + blk]
                rows_b = data[row_ids[i : i + blk].long()] if row_ids is not None else data[i : i + blk]
                ssum.index_add_(0, lab_b, rows_b)
                cnt.index_add_(0, lab_b, torch.ones_like(lab_b, dtype=torch.float32))
            child_flat = torch.where((cnt > 0)[:, None], ssum / cnt.clamp(min=1.0)[:, None], child_flat)
    with phase("final_labels_s"):
        labels = kmeans_assign_two_level(data, sup_cents, child_flat, 1, row_ids=row_ids, n_sup=final_n_sup)[:, 0]
    return child_flat, labels, sup_cents
