"""IVF (inverted-file / clustered) vector index, in PyTorch with CUDA kernels.

Port of ``semadb_tpu/index/ivf.py`` without the product quantizer (IVF-PQ).
Layout as there: traversal state beside the exact-rerank state, all tensors
on the index's device.

  - ``vectors f32[cap, D]``  per-node full-precision rows: the source of
    truth for writes and refits, and what the exact rerank reads
  - ``centroids f32[C, D]``  the k-means coarse quantizer
    (``vectorstore.kmeans.kmeans_fit_large``); from ``TWO_LEVEL_MIN_C``
    clusters the two-level one (``kmeans_fit_two_level``), whose children
    keep this flat layout, with ``_sup_cents f32[supers, D]`` beside it for
    the assignments of later writes
  - ``slabs [C, S, tdim]``   cluster members, zero in empty slots; f32, or
    bf16 past ``SLAB_BF16_BYTES``; stored in the corpus' top-``PROJ_DIM``
    principal subspace when D > PROJ_DIM
  - ``slab_sq f32[C, S]``    per-slot norms (of the f32 rows)
  - ``slab_ids i32[C, S]``   node id per slot (-1 = empty)
  - overflow rows + ids      points whose home and relocation clusters were
    all full, and not-yet-clustered inserts; scanned densely

Placement, SOAR copies, spill relocation and the refit schedule are the JAX
package's, line for line (its module docstring gives the measurements behind
them). A query (:func:`_ivf_query`) is: probe selection (one [B, C]
``torch.matmul`` + ``topk``) → K3, the hand-written probed-slab scan with a
running top-rr (``ops/kernels/ivf_scan.py``: the probe list is inverted on
the device, so each probed cluster is read once per group of up to 16 of the
queries that probe it) → the overflow scan
(``torch.matmul`` + ``topk``) merged into the pool → K4, the hand-written
exact rerank (``ops/kernels/ivf_rerank.py``), which also returns each id
once when points have copies → top-k. On CPU tensors both kernels run their
plain PyTorch versions.

Where the port differs from the JAX package:
  - writes update tensors in place (``index_copy_`` / ``index_put_``) under
    ``_write_lock``; ``slab_ids`` is still written last, so a concurrent
    search never scores a slot whose row is not written yet. A refit builds
    every new array first and binds them all at once under ``_state_lock``,
    which searches hold while they capture the arrays and enqueue their work
    (on a CUDA device that is launch time only; the stream orders the rest).
    ``_sup_cents`` is bound there too, with the centroids it belongs to, and
    the refit's own assignments are handed the new one (the JAX package
    clears it when a refit starts and sets it when the fit ends);
  - probe selection and the overflow scan use exact ``topk`` where JAX uses
    ``approx_max_k`` (C ≥ 2^17, the chunked overflow scan), and the overflow
    scan is skipped when the host knows the pool holds no live row;
  - no donation, no grow-ahead, no shape bucketing (``_pad_dup``, query
    padding): PyTorch does not compile per shape;
  - a write into a two-level index lands where a search for the point
    itself looks: a row whose two-level candidates are not all among its
    own default probes takes its first probes (``_within_own_probes``); the
    JAX package writes it where its own search may not find it;
  - a product quantizer raises ``NotImplementedError``;
  - the tuning values the JAX package reads from ``SEMADB_IVF_*``
    environment variables are constants here, at its defaults.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.models.schema import VectorIVFParams
from semadb_tpu_torch.ops.distance import pairwise_distance
from semadb_tpu_torch.ops.kernels.ivf_rerank import ivf_exact_rerank
from semadb_tpu_torch.ops.kernels.ivf_scan import ivf_probe_scan
from semadb_tpu_torch.utils.grow import initial_capacity, next_capacity
from semadb_tpu_torch.vectorstore.kmeans import (
    kmeans_assign,
    kmeans_assign_two_level,
    kmeans_fit_large,
    kmeans_fit_two_level,
)
from semadb_tpu_torch.vectorstore.store import host_tensor

NIL = -1
TARGET_CLUSTER_SIZE = 24
DEFAULT_SLAB = 64
MIN_FIT = 512
KMEANS_ITERS = 15
RERANK_POOL = 64
# Projected coarse scores carry JL distortion: the pool is deeper
RERANK_POOL_PQ = 256
PROJ_DIM = 128
# Slabs past this many f32 bytes are stored in bf16. On the H100 the 10M x 128
# cell (f32 slabs 12.9 GB) measured the same recall@10 on both types and K3
# 19% faster on bf16 (PERF.md, the 10M cell), so the threshold stays the JAX value
SLAB_BF16_BYTES = 2**32
# Full [B, O] overflow distance matrix cap before the scan chunks it
OVF_CHUNK_BYTES = 2**26
OVF_CHUNK_ROWS = 65536
# Full [B, C] probe-selection matrix cap before chunking over C
PROBE_CHUNK_BYTES = 2**30
PROBE_CHUNK_C = 16384
# Cluster counts from here on take the two-level coarse quantizer: a flat
# fit and assignment score every row against every cluster
TWO_LEVEL_MIN_C = 65537
TWO_LEVEL_SUPERS = 512
# Largest filter-member count served by the exact member scan; larger
# filters probe FILTER_WIDEN times wider instead
FILTER_EXACT_CAP = 262144
FILTER_WIDEN = 4
# Slab budget of _auto_slab (bf16 bytes); see its docstring
SLAB_BYTES = 7 * 2**30
RELOC_T = 8  # relocation candidates for a primary whose home cluster is full
WRITE_CHUNK = 131072  # rows per upload + scatter of a large write


def _long(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _member_scan_chunked(vectors, members: np.ndarray, q, k: int, metric: str, chunk_cap: int):
    """Exact top-k over the rows ``members`` (host ids), scanned in chunks of
    ``chunk_cap``: gather, score, merge each chunk's top-k into the running
    [B, k] pool. Exact: the global top-k is a fixed point of the merge."""
    B = q.shape[0]
    best_d = torch.full((B, 0), float("inf"), device=q.device)
    best_i = torch.full((B, 0), NIL, dtype=torch.int32, device=q.device)
    for lo in range(0, len(members), chunk_cap):
        ids = torch.from_numpy(members[lo : lo + chunk_cap].astype(np.int32)).to(q.device)
        d = torch.cat([best_d, pairwise_distance(q, vectors[ids.long()], metric)], dim=1)
        i = torch.cat([best_i, ids[None, :].expand(B, -1)], dim=1)
        best_d, pos = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False, sorted=True)
        best_i = torch.gather(i, 1, pos)
    return _pad_k(best_d, best_i, k)


def _pad_k(d: torch.Tensor, i: torch.Tensor, k: int):
    """(inf, -1) for non-finite entries, padded to k columns."""
    ok = torch.isfinite(d)
    d = d.masked_fill(~ok, float("inf"))
    i = i.masked_fill(~ok, NIL)
    if d.shape[1] < k:
        B, pad = d.shape[0], k - d.shape[1]
        d = torch.cat([d, d.new_full((B, pad), float("inf"))], dim=1)
        i = torch.cat([i, i.new_full((B, pad), NIL)], dim=1)
    return d, i


def _gather_project(vectors, rows, proj):
    """``vectors[rows] @ proj`` with the gather blocked per 64k rows (a
    full-D gather of 2M rows at 1536-d would be 12 GB)."""
    nb = 65536
    out = torch.empty((rows.shape[0], proj.shape[1]), dtype=torch.float32, device=vectors.device)
    for lo in range(0, rows.shape[0], nb):
        out[lo : lo + nb] = vectors[rows[lo : lo + nb].long()] @ proj
    return out


def _slabs_from_ids(vectors, sid, proj, out_dtype=torch.float32, want_sq=True):
    """Build [Cn, S, tdim] slabs (+ f32 |x|^2 per slot) by GATHERING rows for
    the id layout ``sid`` (NIL slots → zero rows), blocked over clusters so
    each step's full-D gather stays ~32 MB. Norms are taken from the f32 rows
    before any bf16 cast, so only the coarse cross term carries rounding."""
    Cn, S = sid.shape
    cap, D = vectors.shape
    tdim = D if proj is None else proj.shape[1]
    cb = max(2**25 // max(S * D * 4, 1), 8)
    slabs = torch.empty((Cn, S, tdim), dtype=out_dtype, device=vectors.device)
    sq = torch.zeros((Cn, S), dtype=torch.float32, device=vectors.device)
    for c0 in range(0, Cn, cb):
        sb = sid[c0 : c0 + cb]
        rows = vectors[sb.clamp(0, cap - 1).long()]  # [cb, S, D]
        if proj is not None:
            rows = rows @ proj
        rows = torch.where((sb != NIL)[..., None], rows, torch.zeros((), device=rows.device))
        if want_sq:
            sq[c0 : c0 + cb] = (rows * rows).sum(-1)
        slabs[c0 : c0 + cb] = rows.to(out_dtype)
    return slabs, sq


def _pack_greedy(rows, col_clusters, fill, S, Cn):
    """Greedy capacity-bounded packing of `rows` into `col_clusters`
    (per-row target cluster): returns (placed rows, clusters, slots,
    updated fill, leftover positions into `rows`). Vectorised: rank
    within each target cluster via stable sort + searchsorted."""
    order2 = np.argsort(col_clusters, kind="stable")
    c2s = col_clusters[order2]
    starts2 = np.searchsorted(c2s, np.arange(Cn))
    rank2 = np.arange(len(rows)) - starts2[c2s]
    slot2 = fill[c2s] + rank2
    ok = slot2 < S
    fill = fill + np.minimum(
        np.bincount(col_clusters, minlength=Cn), np.maximum(S - fill, 0)
    ).astype(np.int32)
    return rows[order2[ok]], c2s[ok], slot2[ok], fill, order2[~ok]


def _auto_slab(copies: int, n: int, Cn: int, tdim: int, current: int) -> int:
    """Slab depth for a refit: grow past the configured default when SOAR
    copies would otherwise saturate the slot budget.

    At 10M × 128d / C=131072 / copies=2, the default S=128 offers 16.8M
    slots for 20M placements — a third of the copies get dropped and
    primaries relocate far from home, capping recall ~0.96 at p=24. Sizing
    S to copies·n/Cn with 25% heavy-tail headroom (rounded up to 64, the
    gather-friendly granule) keeps both placements resident. Bounded by the
    ``SLAB_BYTES`` bf16 slab budget, 7 GiB, the JAX package's for a 16 GB
    chip; never shrinks below the configured value. On the 80 GB H100 the
    budget leaves room: the 10M x 128 cell peaked at 12.09 GiB with 11.30
    GiB resident (PERF.md, the 10M cell). There need and cap are both 192 (7 GiB
    over 131,072 x 128 x 2 B is 224, rounded down to 64), so at C = 131,072
    the cap binds from ~10.07M points on. It stays at the JAX value until a
    cell past that size measures what a deeper slab buys."""
    if n <= 0:
        return current
    need = int(np.ceil(copies * n / Cn * 1.25 / 64.0)) * 64
    cap = max((SLAB_BYTES // (Cn * tdim * 2)) // 64 * 64, 64)
    return max(current, min(need, cap))


def _npow2(x: int, lo: int, hi: int) -> int:
    """Nearest power of two in [lo, hi] (geometric rounding): the cluster
    count drives the [B, C] probe-selection top_k, whose cost doubles per
    step, so round down unless x is past the geometric midpoint."""
    p = lo
    while p * 1.414 < x and p < hi:
        p *= 2
    return p


def _select_probes(qp, centroids, cent_sq, p: int) -> torch.Tensor:
    """Top-p probe cluster ids per query (i32[B, p], nearest first): one
    dense [B, C] ``torch.matmul`` + ``topk``, chunked over C past
    PROBE_CHUNK_BYTES with a per-chunk top-p carry. The top-p is exact; the
    JAX package takes ``approx_max_k`` from C = 2^17 and inside chunks."""
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


def _overflow_scan(qp, ovf_vecs, ovf_sq, ovf_ids, filter_mask, rr: int):
    """Dense scan of the overflow rows: [B, O] scores (chunked past
    OVF_CHUNK_BYTES), NIL and filtered rows at inf, top-rr of each chunk.
    Exact where the JAX package takes ``approx_max_k`` per chunk."""
    B, O = qp.shape[0], ovf_ids.shape[0]
    ob = O if B * O * 4 <= OVF_CHUNK_BYTES else OVF_CHUNK_ROWS
    dists, ids = [], []
    for lo in range(0, O, ob):
        oid = ovf_ids[lo : lo + ob]
        ok = oid != NIL
        if filter_mask is not None:
            ok = ok & filter_mask[oid.clamp(0, filter_mask.shape[0] - 1).long()] & (oid < filter_mask.shape[0])
        od = ovf_sq[None, lo : lo + ob] - 2.0 * (qp @ ovf_vecs[lo : lo + ob].T)
        od = od.masked_fill(~ok[None, :], float("inf"))
        v, pos = torch.topk(od, min(rr, od.shape[1]), dim=1, largest=False)
        dists.append(v)
        ids.append(oid[pos.reshape(-1)].reshape(pos.shape))
    return torch.cat(dists, dim=1), torch.cat(ids, dim=1)


def _ivf_query(
    centroids, cent_sq, slabs, slab_sq, slab_ids, ovf_vecs, ovf_sq, ovf_ids,
    queries, vectors, filter_mask, proj, p: int, k: int,
    metric: str = C.DISTANCE_EUCLIDEAN, dedup: bool = False, keep: Optional[dict] = None,
):
    """Returns (dists f32[B, k], node ids i32[B, k]); empty slots (inf, -1).

    The JAX package's ``_ivf_query`` with the slab scan and the pool in K3
    and the rerank in K4. Coarse scores omit |q|^2 (rank-invariant per
    query); the final distances are the engine-wide metric (squared
    euclidean / negated dot / 1 - cosine), exact f32. ``filter_mask`` is a
    bool tensor over node ids or None; ``proj`` the [D, r] traversal basis
    or None. The top rr of (K3's top rr ∪ the overflow's) equals the top rr
    of all candidates, up to ties. ``keep``, when given, receives the
    arguments of this call's K3 and K4 launches (``"k3"``, ``"k4"``), for
    callers that check or time the kernels on a real search's operands."""
    qp = queries if proj is None else queries @ proj
    probe = _select_probes(qp, centroids, cent_sq, p)
    rr = max(RERANK_POOL_PQ if proj is not None else RERANK_POOL, 2 * k)
    mask_u8 = None if filter_mask is None else filter_mask.view(torch.uint8)
    k3_args = (qp, probe, slabs, slab_sq, slab_ids, mask_u8, rr)
    dist, ids = ivf_probe_scan(*k3_args)
    if ovf_ids.shape[0]:
        od, oi = _overflow_scan(qp, ovf_vecs, ovf_sq, ovf_ids, filter_mask, rr)
        d_all, i_all = torch.cat([dist, od], dim=1), torch.cat([ids, oi], dim=1)
        dist, pos = torch.topk(d_all, rr, dim=1, largest=False, sorted=True)
        ids = torch.gather(i_all, 1, pos)
    # K4 takes a non-finite coarse score as an empty slot and, with dedup
    # (assignCopies > 1 stores a point in several slabs), each id once
    k4_args = (vectors, queries, ids.contiguous(), dist.contiguous(), k, metric, dedup)
    if keep is not None:
        keep.update(k3=k3_args, k4=k4_args)
    return ivf_exact_rerank(*k4_args)


class IndexIVF:
    """Stateful host handle on a device-resident IVF index.

    Same surface as the flat index: ``insert_update_delete`` over
    (id, vector|None) changes, ``search_batch``/``search_batch_async`` with
    an optional filter mask, array persistence. Only euclidean, dot and
    cosine (the schema validator refuses the rest)."""

    def __init__(self, params: VectorIVFParams, device: torch.device):
        q = params.quantizer
        if q is not None and q.type == C.QUANTIZER_PRODUCT:
            raise NotImplementedError(
                "a product quantizer on vectorIVF (IVF-PQ) is not ported to semadb_tpu_torch yet"
            )
        self.params = params
        self.metric = params.distance_metric
        self.device = torch.device(device)
        D = params.vector_size
        self.slab = params.slab_size or DEFAULT_SLAB * max(1, params.assign_copies)
        # High-dim traversal: a fixed random-orthonormal [D, r] map from the
        # same numpy seed as the JAX package (the first refit replaces it by
        # the corpus' principal subspace)
        pdim = params.proj_dim or PROJ_DIM
        if D > pdim:
            prng = np.random.default_rng(0xC0FFEE)
            qmat, _ = np.linalg.qr(prng.standard_normal((D, pdim)).astype(np.float64))
            self._proj = torch.from_numpy(qmat.astype(np.float32)).to(self.device)
            self.tdim = pdim
        else:
            self._proj = None
            self.tdim = D
        dev = self.device
        # Pre-fit state: everything lives in the overflow pool
        self.centroids = torch.zeros((1, D), dtype=torch.float32, device=dev)
        self.slabs = torch.zeros((1, self.slab, self.tdim), dtype=torch.float32, device=dev)
        self.slab_sq = torch.zeros((1, self.slab), dtype=torch.float32, device=dev)
        self.slab_ids = torch.full((1, self.slab), NIL, dtype=torch.int32, device=dev)
        self._fill = np.zeros(1, np.int32)
        self.ovf_vecs = torch.zeros((8, self.tdim), dtype=torch.float32, device=dev)
        self.ovf_ids = torch.full((8,), NIL, dtype=torch.int32, device=dev)
        self._ovf_free: list[int] = list(range(8))
        # Host mirrors, so writes never read back from the device
        self._loc: dict[int, tuple] = {}  # node id -> ("s", c, slot) | ("o", j)
        self._loc2: dict[int, list] = {}  # node id -> [(c, slot), ...] copies
        self._n_at_fit = 0
        self._sup_cents: Optional[torch.Tensor] = None  # the two-level super layer, else None
        self._sq_cache: dict = {}
        # Searches hold _state_lock while they capture the arrays and enqueue
        # their work; writers hold it around each in-place update and
        # rebinding. _write_lock serialises writers (placement and the host
        # mirrors are read-modify-write); searches never take it.
        self._state_lock = threading.RLock()
        self._write_lock = threading.RLock()
        self._max_seen = 0
        self.capacity = initial_capacity(D * 4, 128)
        self.vectors = torch.zeros((self.capacity, D), dtype=torch.float32, device=dev)
        self.refit_seconds: dict = {}  # phase → seconds of the last refit
        self.repaired_writes = 0  # written rows placed by their own probes (_within_own_probes)

    # -- internals ----------------------------------------------------------
    def _sq(self, arr: torch.Tensor) -> torch.Tensor:
        """Stored-side norm term: squared euclidean keeps |x|^2; dot and
        cosine drop it so the score orders like -dot and 1 - cosine."""
        if self.metric == C.DISTANCE_EUCLIDEAN:
            return (arr * arr).sum(-1)
        return torch.zeros(arr.shape[:-1], dtype=torch.float32, device=arr.device)

    def _set_rows(self, name: str, rows, vals: torch.Tensor) -> None:
        """``getattr(self, name)[rows] = vals`` in place."""
        idx = _long(rows).to(self.device)
        with self._state_lock:
            dst = getattr(self, name)
            dst.index_copy_(0, idx, vals.to(dst.device, dst.dtype))

    def _set_cells(self, name: str, cs, ss, vals: torch.Tensor) -> None:
        """``getattr(self, name)[cs, ss] = vals`` in place."""
        ci, si = _long(cs).to(self.device), _long(ss).to(self.device)
        with self._state_lock:
            dst = getattr(self, name)
            dst.index_put_((ci, si), vals.to(dst.device, dst.dtype))

    def _ensure_capacity(self, max_id: int) -> None:
        self._max_seen = max(self._max_seen, max_id)
        if max_id < self.capacity:
            return
        new_cap = next_capacity(self.capacity, max_id, self.params.vector_size * 4)
        grown = torch.zeros((new_cap, self.params.vector_size), dtype=torch.float32, device=self.device)
        with self._state_lock:
            grown[: self.capacity] = self.vectors
            self.vectors = grown
            self.capacity = new_cap

    def __len__(self) -> int:
        return len(self._loc)

    def _ovf_slots(self, n: int) -> list[int]:
        """Reserve n overflow slots, growing (doubling) the pool at most
        once per call."""
        while len(self._ovf_free) < n:
            old = self.ovf_ids.shape[0]
            grow = max(old, n)
            with self._state_lock:
                self.ovf_vecs = torch.cat([self.ovf_vecs, self.ovf_vecs.new_zeros((grow, self.tdim))])
                self.ovf_ids = torch.cat([self.ovf_ids, self.ovf_ids.new_full((grow,), NIL)])
            self._ovf_free.extend(range(old, old + grow))
        return [self._ovf_free.pop() for _ in range(n)]

    def _assign_top(self, cents, sup, t, row_ids=None, rows=None) -> np.ndarray:
        """Top-t nearest clusters as host ids: over the children of the 4
        nearest supers when ``sup`` (the super layer of ``cents``) is given
        and C ≥ ``TWO_LEVEL_MIN_C``, flat otherwise. ``rows`` = explicit data
        matrix; ``row_ids`` = gather rows from ``self.vectors`` per block."""
        data = rows if rows is not None else self.vectors
        ids = None if rows is not None else row_ids
        if sup is not None and cents.shape[0] >= TWO_LEVEL_MIN_C:
            # n_sup = 4: with 2, 6.5% of assignments miss the nearest
            # cluster (the JAX package's measurement at 64k x 64d, C = 1024)
            return kmeans_assign_two_level(data, sup, cents, t, row_ids=ids, n_sup=4).cpu().numpy()
        return kmeans_assign(data, cents, t, row_ids=ids).cpu().numpy()

    def _should_refit(self) -> bool:
        n = len(self._loc)
        if n < MIN_FIT:
            return False
        if self._n_at_fit == 0:
            return True
        n_ovf = self.ovf_ids.shape[0] - len(self._ovf_free)
        return n >= 2 * self._n_at_fit or n_ovf > max(64, n // 4)

    @contextmanager
    def _phase(self, name: str):
        """Time one refit phase into ``refit_seconds`` (device work included)."""
        _sync(self.device)
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.refit_seconds[name] = self.refit_seconds.get(name, 0.0) + time.perf_counter() - t0

    def _refit(self) -> None:
        """Full k-means + repack. Vector data never leaves the device: the
        corpus is gathered from ``vectors``, the k-means labels are the only
        readback, and the slabs are gathered from the new id layout. Every
        new array is built first and bound at once under ``_state_lock``."""
        self.refit_seconds = {}
        ids = np.fromiter(self._loc.keys(), np.int32, len(self._loc))
        n = len(ids)
        D = self.params.vector_size
        Cn = self.params.num_clusters or _npow2(max(n // TARGET_CLUSTER_SIZE, 1), 16, 131072)
        if n < 2**17:
            n_pad = MIN_FIT
            while n_pad < n:
                n_pad *= 2
        else:
            n_pad = -(-n // 4096) * 4096
        Cn = min(Cn, n_pad)
        S = self.slab
        if not self.params.slab_size:
            S = _auto_slab(min(self.params.assign_copies, Cn), n, Cn, self.tdim, self.slab)
        # Tiling real ids pads the fit input (duplicates only nudge means)
        pad_ids = ids if n_pad == n else ids[np.arange(n_pad) % n]
        pad_ids_dev = torch.from_numpy(pad_ids).to(self.device)
        # Past 256 MB the [n_pad, D] gather copy is skipped: rows are
        # gathered per block inside k-means and the assignment instead
        big = n_pad * D * 4 >= 2**28
        sup = None
        with self._phase("kmeans_s"):
            if Cn >= TWO_LEVEL_MIN_C:
                fit_data = None if big else self.vectors[pad_ids_dev.long()]
                cents, lab, sup = kmeans_fit_two_level(
                    self.vectors if big else fit_data, Cn, iters=KMEANS_ITERS,
                    row_ids=pad_ids_dev if big else None, supers=min(TWO_LEVEL_SUPERS, Cn),
                    phase=lambda name: self._phase("kmeans_" + name),
                )
            elif big:
                fit_data = None
                cents, lab = kmeans_fit_large(self.vectors, Cn, iters=KMEANS_ITERS, row_ids=pad_ids_dev)
            else:
                fit_data = self.vectors[pad_ids_dev.long()]
                cents, lab = kmeans_fit_large(fit_data, Cn, iters=KMEANS_ITERS)
            lab = lab.cpu().numpy()[:n]
        data = fit_data

        proj = self._proj
        if proj is not None:
            # The corpus' top-r principal subspace: second moments from a
            # ≤64k-row sample on the device, the [D, D] eigh on the host
            with self._phase("pca_s"):
                stride_p = max(n_pad // 2**16, 1)
                sample = (
                    self.vectors[_long(pad_ids[::stride_p]).to(self.device)]
                    if big else fit_data[::stride_p]
                )
                cov = sample.T @ sample
                _, evecs = np.linalg.eigh(cov.cpu().numpy().astype(np.float64))
                proj = torch.from_numpy(
                    np.ascontiguousarray(evecs[:, -self.tdim:][:, ::-1]).astype(np.float32)
                ).to(self.device)
                del sample

        with self._phase("pack_s"):
            order = np.argsort(lab, kind="stable")
            lab_sorted = lab[order]
            starts = np.searchsorted(lab_sorted, np.arange(Cn))
            rank = np.arange(n) - starts[lab_sorted]
            in_slab = rank < S
            sel = order[in_slab]  # row positions into `data`
            spill = order[~in_slab]
            cs, ss = lab[sel], rank[in_slab]
            copies = min(self.params.assign_copies, Cn)
            fill = np.minimum(np.bincount(lab, minlength=Cn), S).astype(np.int32)
            t_all = max(copies, RELOC_T)
            pc = np.full(n, -1, np.int64)  # placed (primary) cluster per row
            pc[sel] = lab[sel]
            pri_rows, pri_cs, pri_ss = sel, cs.astype(np.int64), ss.astype(np.int64)
        topt = None
        with self._phase("assign_s"):
            if len(spill) and copies > 1:
                topt = (
                    self._assign_top(cents, sup, t_all, row_ids=pad_ids_dev)
                    if big else self._assign_top(cents, sup, t_all, rows=fit_data)
                )[:n]
                topt_sp = topt[spill]
            elif len(spill):
                topt_sp = self._assign_top(
                    cents, sup, RELOC_T, rows=self.vectors[_long(ids[spill]).to(self.device)]
                )
            else:
                topt_sp = np.empty((0, t_all), np.int64)
        with self._phase("pack_s"):
            # Spill relocation: a primary that misses its full home cluster
            # moves to the next-nearest cluster with a free slot
            still, still_topt = spill, topt_sp
            for col in range(1, t_all):
                if not len(still):
                    break
                placed, pcl, psl, fill, left_pos = _pack_greedy(still, still_topt[:, col], fill, S, Cn)
                pri_rows = np.concatenate([pri_rows, placed])
                pri_cs = np.concatenate([pri_cs, pcl])
                pri_ss = np.concatenate([pri_ss, psl])
                pc[placed] = pcl
                still = still[left_pos]
                still_topt = still_topt[left_pos]
            spill = still
        # SOAR-style secondary copies, best-effort into free slots
        sec_rows = np.empty(0, np.int64)
        sec_cs = np.empty(0, np.int64)
        sec_ss = np.empty(0, np.int64)
        if copies > 1:
            if topt is None:
                with self._phase("assign_s"):
                    topt = (
                        self._assign_top(cents, sup, t_all, row_ids=pad_ids_dev)
                        if big else self._assign_top(cents, sup, t_all, rows=fit_data)
                    )[:n]
            with self._phase("pack_s"):
                for col in range(1, copies):
                    cand = np.nonzero((pc >= 0) & (topt[:, col] != pc))[0]
                    placed, pcl, psl, fill, _ = _pack_greedy(cand, topt[cand, col], fill, S, Cn)
                    sec_rows = np.concatenate([sec_rows, placed])
                    sec_cs = np.concatenate([sec_cs, pcl])
                    sec_ss = np.concatenate([sec_ss, psl])
        with self._phase("pack_s"):
            all_rows = np.concatenate([pri_rows, sec_rows]).astype(np.int64)
            all_cs = np.concatenate([pri_cs, sec_cs])
            all_ss = np.concatenate([pri_ss, sec_ss])
            o_min = 4096 if n >= 2**17 else 8
            O = max(int(2 ** np.ceil(np.log2(max(len(spill) * 2, 8)))), o_min)
            ovf_ids = np.full((O,), NIL, np.int32)
            ovf_ids[: len(spill)] = ids[spill]
            slab_ids = np.full((Cn, S), NIL, np.int32)
            slab_ids[all_cs, all_ss] = ids[all_rows]

        with self._phase("slab_build_s"):
            bf16 = Cn * S * self.tdim * 4 > SLAB_BF16_BYTES
            slab_ids_dev = torch.from_numpy(slab_ids).to(self.device)
            slabs, slab_sq = _slabs_from_ids(
                self.vectors, slab_ids_dev, proj,
                out_dtype=torch.bfloat16 if bf16 else torch.float32,
                want_sq=self.metric == C.DISTANCE_EUCLIDEAN,
            )
            ovf_vecs = torch.zeros((O, self.tdim), dtype=torch.float32, device=self.device)
            if len(spill):
                sp_v = self.vectors[_long(ids[spill]).to(self.device)] if big else data[_long(spill).to(self.device)]
                ovf_vecs[: len(spill)] = sp_v if proj is None else sp_v @ proj
        with self._state_lock:
            self.centroids, self._sup_cents = cents, sup
            self._proj = proj
            self.slab = S
            self.slabs, self.slab_sq, self.slab_ids = slabs, slab_sq, slab_ids_dev
            self.ovf_vecs = ovf_vecs
            self.ovf_ids = torch.from_numpy(ovf_ids).to(self.device)
            # With the pool it describes: a search's skip test compares the two
            self._ovf_free = list(range(len(spill), O))
            self._sq_cache = {}
        self._fill = fill  # high-water mark incl. secondary copies
        with self._phase("loc_maps_s"):
            self._loc = dict(
                zip(
                    ids[pri_rows].tolist(),
                    zip(("s",) * len(pri_rows), pri_cs.tolist(), pri_ss.tolist()),
                )
            )
            for j, i in enumerate(ids[spill].tolist()):
                self._loc[i] = ("o", j)
            self._loc2 = {}
            for i, c, s in zip(ids[sec_rows].tolist(), sec_cs.tolist(), sec_ss.tolist()):
                self._loc2.setdefault(i, []).append((c, s))
        self._n_at_fit = n

    # -- writes --------------------------------------------------------------
    def insert_update_delete(self, changes: Iterable[Tuple[int, Optional[np.ndarray]]]) -> None:
        """Apply (id, vector|None) changes: host vectors, each converted on
        its own (for arrays already on the device use :meth:`insert_bulk`).
        Tensors are updated in place under ``_write_lock``."""
        with self._write_lock:
            self._insert_update_delete_locked(changes)

    def _insert_update_delete_locked(self, changes) -> None:
        ups: list[tuple[int, np.ndarray]] = []
        removals: list = []  # loc tuples to blank
        max_id = 0
        for node_id, vec in changes:
            if node_id in (0, 1):
                raise ValueError(f"cannot modify point with reserved id: {node_id}")
            max_id = max(max_id, node_id)
            if vec is None:
                loc = self._loc.pop(node_id, None)
                if loc is not None:
                    removals.append(loc)
                for c2, s2 in self._loc2.pop(node_id, ()):
                    removals.append(("s", c2, s2))
            else:
                ups.append((node_id, np.asarray(vec, np.float32)))
        self._ensure_capacity(max_id)
        if ups:
            up_ids = np.array([u[0] for u in ups], np.int32)
            up_vecs = np.stack([u[1] for u in ups])
            for off in range(0, len(ups), WRITE_CHUNK):
                self._set_rows(
                    "vectors", up_ids[off : off + WRITE_CHUNK],
                    torch.from_numpy(up_vecs[off : off + WRITE_CHUNK]).to(self.device),
                )
            # update = replace: pop every old location before placement
            for node_id, _ in ups:
                old = self._loc.pop(node_id, None)
                if old is not None:
                    removals.append(old)
                for c2, s2 in self._loc2.pop(node_id, ()):
                    removals.append(("s", c2, s2))
            if removals:
                self._apply_removals(removals)
                removals = []
            if self._n_at_fit > 0:
                self._place_fitted(up_ids.astype(np.int64))
            elif len(self._loc) + len(ups) >= MIN_FIT:
                # This batch triggers the first fit at the end of the call,
                # which rebuilds slabs and overflow: placeholders until then
                self._loc.update((int(i), ("o", -1)) for i in up_ids)
            else:
                # tiny pre-fit corpus: real overflow entries
                slots = np.array(self._ovf_slots(len(ups)), np.int32)
                rows = self.vectors[_long(up_ids).to(self.device)]
                if self._proj is not None:
                    rows = rows @ self._proj
                self._set_rows("ovf_vecs", slots, rows)
                self._set_rows("ovf_ids", slots, torch.from_numpy(up_ids).to(self.device))
                for nid, j in zip(up_ids, slots):
                    self._loc[int(nid)] = ("o", int(j))
        if removals:
            self._apply_removals(removals)
        if self._should_refit():
            self._refit()
        self._sq_cache = {}

    def _apply_removals(self, removals: list) -> None:
        """Blank removed locations. Deferred-fit placeholders ``("o", -1)``
        have no device state: dropping them is the whole removal."""
        s_cs = np.array([l[1] for l in removals if l[0] == "s"], np.int32)
        s_ss = np.array([l[2] for l in removals if l[0] == "s"], np.int32)
        o_js = np.array([l[1] for l in removals if l[0] == "o" and l[1] >= 0], np.int32)
        if len(s_cs):
            self._set_cells("slab_ids", s_cs, s_ss, torch.full((len(s_cs),), NIL, dtype=torch.int32))
        if len(o_js):
            self._set_rows("ovf_ids", o_js, torch.full((len(o_js),), NIL, dtype=torch.int32))
            self._ovf_free.extend(int(j) for j in o_js)

    def _has_placeholders(self) -> bool:
        """True while any deferred-fit ``("o", -1)`` location exists."""
        return any(l[0] == "o" and l[1] < 0 for l in self._loc.values())

    def insert_bulk(self, ids, vecs, defer_fit: bool = False) -> None:
        """Array bulk insert: no per-point Python.

        ``ids``: int array [n] of new node ids; ``vecs``: f32 [n, D], numpy
        or a tensor (a tensor on the index's device never visits the host).
        Batches holding existing or repeated ids take the generic path. An
        unfitted index takes placeholders and one refit; a fitted one the
        greedy packing. ``defer_fit=True`` skips the trailing refit so the
        caller can drop its corpus first; call :meth:`flush_pending` after."""
        with self._write_lock:
            self._insert_bulk_locked(ids, vecs, defer_fit)

    def _insert_bulk_locked(self, ids, vecs, defer_fit: bool) -> None:
        ids_np = np.asarray(ids, np.int64)
        n = len(ids_np)
        if n == 0:
            return
        if (ids_np <= 1).any():
            raise ValueError("cannot modify point with reserved id")
        if len(np.unique(ids_np)) != n or any(int(i) in self._loc for i in ids_np):
            self.insert_update_delete(zip(ids_np.tolist(), _host(vecs)))
            return
        contiguous = bool(np.array_equal(ids_np, np.arange(ids_np[0], ids_np[0] + n)))
        if isinstance(vecs, torch.Tensor) and not self._loc and contiguous:
            # Adopt a device-resident corpus into id positions; capacity
            # pads to a 2^20 multiple past 2M rows, as in the JAX package
            new_cap = self.capacity
            while new_cap <= int(ids_np[-1]):
                new_cap *= 2
            if new_cap >= 2**21:
                new_cap = (int(ids_np[-1]) // 2**20 + 1) * 2**20
            lead = int(ids_np[0])
            grown = torch.zeros((new_cap, self.params.vector_size), dtype=torch.float32, device=self.device)
            grown[lead : lead + n] = vecs.to(self.device, torch.float32)
            with self._state_lock:
                self.vectors = grown
                self.capacity = new_cap
            self._max_seen = max(self._max_seen, int(ids_np[-1]))
        else:
            self._ensure_capacity(int(ids_np.max()))
            for off in range(0, n, WRITE_CHUNK):
                blk = vecs[off : off + WRITE_CHUNK]
                blk = blk if isinstance(blk, torch.Tensor) else torch.from_numpy(np.asarray(blk, np.float32))
                self._set_rows("vectors", ids_np[off : off + WRITE_CHUNK], blk.to(self.device))
        if self._n_at_fit == 0:
            self._loc.update((int(i), ("o", -1)) for i in ids_np)
            if len(self._loc) >= MIN_FIT:
                if not defer_fit:
                    self._refit()
            else:
                # tiny pre-fit corpus: real overflow entries
                for i in ids_np:
                    self._loc.pop(int(i))
                self.insert_update_delete(zip(ids_np.tolist(), _host(vecs)))
            self._sq_cache = {}
            return
        self._place_fitted(ids_np)
        if self._should_refit() and not defer_fit:
            self._refit()
        self._sq_cache = {}

    def _within_own_probes(self, topt: np.ndarray, ids_dev: torch.Tensor) -> np.ndarray:
        """Candidate clusters of written rows that a search for the row itself
        probes. The two-level assignment looks at the children of 4 supers,
        while a search probes the nearest clusters of all; a row whose
        candidates are not all among its own default probes would be written
        where its own search cannot find it (the JAX package places it there
        all the same). Such a row takes its first probes instead; every other
        row keeps the two-level candidates."""
        t = topt.shape[1]
        p = max(self._num_probes(), t)
        with self._state_lock:
            cent, cent_sq = self._probe_centroids()
        own = np.empty((len(topt), p), np.int64)
        for lo in range(0, len(topt), 4096):
            rows = self.vectors[ids_dev[lo : lo + 4096].long()]
            qp = rows if self._proj is None else rows @ self._proj
            own[lo : lo + 4096] = _select_probes(qp, cent, cent_sq, p).cpu().numpy()
        inside = (topt[:, :, None] == own[:, None, :]).any(2).all(1)
        topt = topt.copy()
        topt[~inside] = own[~inside, :t]
        self.repaired_writes += int((~inside).sum())
        return topt

    def _place_fitted(self, ids_np: np.ndarray) -> None:
        """Vectorised placement of already-written ``vectors`` rows into
        slabs/overflow: per-column greedy packing (primaries with spill
        relocation, then SOAR copies), one scatter per array, ids last."""
        n = len(ids_np)
        ids_dev = torch.from_numpy(ids_np.astype(np.int32)).to(self.device)
        Cn = self.centroids.shape[0]
        S = self.slab
        copies = min(self.params.assign_copies, Cn)
        t_ins = min(max(copies, 2), Cn)
        topt = self._assign_top(self.centroids, self._sup_cents, t_ins, row_ids=ids_dev)[:n]
        if self._sup_cents is not None and Cn >= TWO_LEVEL_MIN_C:
            topt = self._within_own_probes(topt, ids_dev)
        fill = self._fill
        placed_cols = []  # (rows (positions into ids_np), clusters, slots, is_primary)
        pc = np.full(n, -1, np.int64)
        still = np.arange(n)
        for col in range(t_ins):
            if not len(still):
                break
            placed, pcl, psl, fill, left = _pack_greedy(still, topt[still, col], fill, S, Cn)
            placed_cols.append((placed, pcl, psl, True))
            pc[placed] = pcl
            still = still[left]
        ovf_rows = still
        for col in range(1, copies):
            cand = np.nonzero((pc >= 0) & (topt[:, col] != pc))[0]
            placed, pcl, psl, fill, _ = _pack_greedy(cand, topt[cand, col], fill, S, Cn)
            placed_cols.append((placed, pcl, psl, False))
        self._fill = fill

        all_rows = np.concatenate([p[0] for p in placed_cols])
        all_cs = np.concatenate([p[1] for p in placed_cols])
        all_ss = np.concatenate([p[2] for p in placed_cols])
        if len(all_rows):
            node_ids = ids_np[all_rows].astype(np.int32)
            rows_dev = torch.from_numpy(node_ids).to(self.device)
            rows_f = (
                _gather_project(self.vectors, rows_dev, self._proj)
                if self._proj is not None else self.vectors[rows_dev.long()]
            )
            self._set_cells("slabs", all_cs, all_ss, rows_f)
            self._set_cells("slab_sq", all_cs, all_ss, self._sq(rows_f))
            # slab_ids LAST: the id write makes a slot visible to searches
            self._set_cells("slab_ids", all_cs, all_ss, rows_dev)
        if len(ovf_rows):
            slots = np.array(self._ovf_slots(len(ovf_rows)), np.int32)
            o_ids = torch.from_numpy(ids_np[ovf_rows].astype(np.int32)).to(self.device)
            ov = (
                _gather_project(self.vectors, o_ids, self._proj)
                if self._proj is not None else self.vectors[o_ids.long()]
            )
            self._set_rows("ovf_vecs", slots, ov)
            self._set_rows("ovf_ids", slots, o_ids)
            for r, j in zip(ovf_rows, slots):
                self._loc[int(ids_np[r])] = ("o", int(j))
        for placed, pcl, psl, primary in placed_cols:
            if primary:
                for r, c, sl in zip(placed, pcl, psl):
                    self._loc[int(ids_np[r])] = ("s", int(c), int(sl))
            else:
                for r, c, sl in zip(placed, pcl, psl):
                    self._loc2.setdefault(int(ids_np[r]), []).append((int(c), int(sl)))

    def flush_pending(self) -> None:
        """Run the refit a ``defer_fit`` bulk insert postponed (also when
        only placeholders remain: they carry no device state)."""
        with self._write_lock:
            if self._should_refit() or self._has_placeholders():
                self._refit()
                self._sq_cache = {}

    def sync(self) -> None:
        """Wait for the device's queued work."""
        _sync(self.device)

    # -- reads ---------------------------------------------------------------
    def _num_probes(self, requested: int = 0) -> int:
        Cn = self.centroids.shape[0]
        if requested or self.params.num_probes:
            p = requested or self.params.num_probes
        elif self.params.assign_copies > 1:
            # copies + relocation make the probe count ~scale-free
            p = 24
        else:
            p = max(8, Cn // 170)
        return max(1, min(max(4, p), Cn))

    def search_batch_async(self, queries, k: int, num_probes: int = 0, filter_mask=None,
                           keep: Optional[dict] = None):
        """Enqueue one batch → (dists f32[B, k], ids i32[B, k]) tensors on
        the index's device, not waited for. ``keep``: see :func:`_ivf_query`
        (not filled on the selective-filter path, which runs neither K3 nor
        K4)."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32).reshape(-1, self.params.vector_size).contiguous()
        else:
            q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(self.device)
        p = self._num_probes(num_probes)
        fm_np = None if filter_mask is None else np.asarray(filter_mask, bool)
        if fm_np is not None and int(fm_np.sum()) <= max(p * self.slab, FILTER_EXACT_CAP):
            # Selective filter: an exact scan over the member rows
            with self._state_lock:
                return self._member_exact(q, k, fm_np)
        with self._state_lock:
            cache = self._sq_cache
            cent_p, cent_sq = self._probe_centroids()
            fm = None
            if fm_np is not None:
                # Broad filter: probe wider instead
                p = min(FILTER_WIDEN * p, self.centroids.shape[0])
                full = np.zeros(self.capacity, bool)
                full[: min(len(fm_np), self.capacity)] = fm_np[: self.capacity]
                fm = torch.from_numpy(full).to(self.device)
            ov, ov_ids = self.ovf_vecs, self.ovf_ids
            if ov_ids.shape[0] == len(self._ovf_free):
                # no live overflow row: nothing to scan
                ov, ov_ids = ov[:0], ov_ids[:0]
            key = ("ovf", ov.shape[0])
            if key not in cache:
                cache[key] = self._sq(ov)
            return _ivf_query(
                cent_p, cent_sq, self.slabs, self.slab_sq, self.slab_ids,
                ov, cache[key], ov_ids, q, self.vectors, fm, self._proj, p, k, self.metric,
                dedup=self.params.assign_copies > 1, keep=keep,
            )

    def _probe_centroids(self):
        """(centroids in the slab space, their squared norms), cached until
        the next write or refit; the caller holds ``_state_lock``."""
        cache = self._sq_cache
        if "cent" not in cache:
            cent_p = self.centroids @ self._proj if self._proj is not None else self.centroids
            cache["cent_p"], cache["cent"] = cent_p, self._sq(cent_p)
        return cache["cent_p"], cache["cent"]

    def _member_exact(self, q: torch.Tensor, k: int, fm_np: np.ndarray):
        """Exact top-k over the live filter members only (member-gather
        scan), chunked past one matmul's memory budget."""
        live = self._sq_cache.get("live")
        if live is None or live.shape[0] != self.capacity:
            live = np.zeros(self.capacity, bool)
            ids = np.fromiter(self._loc.keys(), np.int64, len(self._loc))
            if len(ids):
                live[ids[ids < self.capacity]] = True
            self._sq_cache["live"] = live
        fm = np.zeros(self.capacity, bool)
        n = min(len(fm_np), self.capacity)
        fm[:n] = fm_np[:n]
        fm &= live
        members = np.nonzero(fm)[0]
        B = q.shape[0]
        if len(members) == 0:
            return (
                torch.full((B, k), float("inf"), device=self.device),
                torch.full((B, k), NIL, dtype=torch.int32, device=self.device),
            )
        chunk_cap = max(1024, min(65536, 2**28 // max(B, 1)))
        return _member_scan_chunked(self.vectors, members, q, k, self.metric, chunk_cap)

    def search_batch(self, queries, k: int, num_probes: int = 0, filter_mask=None):
        """Host arrays (dists f32[B, k], ids i32[B, k]); empty (inf, -1)."""
        d, i = self.search_batch_async(queries, k, num_probes, filter_mask)
        return d.cpu().numpy(), i.cpu().numpy()

    # -- persistence ----------------------------------------------------------
    def to_arrays(self) -> dict:
        """Host arrays in the JAX package's ``IndexIVF.to_arrays`` layout
        (slabs, norms and overflow rows are derived state, rebuilt by
        :meth:`from_arrays`)."""
        with self._write_lock:
            return {
                k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in self.device_arrays().items()
            }

    def device_arrays(self) -> dict:
        """Device-resident view for the snapshot writer (no readback).
        Deferred-fit placeholders are materialised first, or the snapshot
        would drop those points. Callers hold ``_write_lock``."""
        if self._has_placeholders():
            self.flush_pending()
        out = {
            "centroids": self.centroids,
            "slab_ids": self.slab_ids,
            "ovf_ids": self.ovf_ids,
            "vectors": self.vectors,
            "n_at_fit": np.asarray([self._n_at_fit], np.int64),
        }
        if self._proj is not None:
            out["proj"] = self._proj
        if self._sup_cents is not None:
            out["sup_cents"] = self._sup_cents
        return out

    def snapshot_row_bounds(self) -> dict:
        """Used-row bounds for the snapshot writer: rows of ``vectors`` past
        the highest id ever written are zeros."""
        return {"vectors": min(self.capacity, int(self._max_seen) + 1)}

    @classmethod
    def from_arrays(cls, params: VectorIVFParams, arrays: dict, device: torch.device) -> "IndexIVF":
        """Load what either package's ``to_arrays`` (or a snapshot) holds;
        slabs, norms and overflow rows are rebuilt from ``vectors`` with the
        gather a refit uses, unless the arrays carry them."""
        if "pq_codebook" in arrays:
            raise NotImplementedError("these IVF arrays hold IVF-PQ codes, which semadb_tpu_torch does not port yet")
        idx = cls(params, device)
        dev = idx.device
        D = params.vector_size
        idx.centroids = host_tensor(arrays["centroids"], np.float32).to(dev)
        idx.slab_ids = host_tensor(arrays["slab_ids"], np.int32).to(dev)
        idx.ovf_ids = host_tensor(arrays["ovf_ids"], np.int32).to(dev)
        rows = int(arrays["vectors"].shape[0])
        # Re-pad along the growth chain from the pregrow-aware base
        cap = max(next_capacity(idx.capacity, rows - 1, D * 4) if rows else idx.capacity, rows)
        idx.vectors = torch.zeros((cap, D), dtype=torch.float32, device=dev)
        idx.vectors[:rows] = host_tensor(arrays["vectors"], np.float32).to(dev)
        idx.capacity = cap
        idx._max_seen = max(rows - 1, 0)
        idx._n_at_fit = int(np.asarray(arrays["n_at_fit"]).reshape(-1)[0])
        if "sup_cents" in arrays:
            idx._sup_cents = host_tensor(arrays["sup_cents"], np.float32).to(dev)
        idx.slab = int(idx.slab_ids.shape[1])
        if "proj" in arrays:
            idx._proj = host_tensor(arrays["proj"], np.float32).to(dev)
            idx.tdim = int(idx._proj.shape[1])
        else:
            # D ≤ PROJ_DIM, or an old snapshot scored in its own full-D space
            idx._proj = None
            idx.tdim = int(arrays["slabs"].shape[-1]) if "slabs" in arrays else D
        if "slabs" in arrays:
            idx.slabs = _slab_tensor(arrays["slabs"]).to(dev)
            if "slab_sq" in arrays:
                idx.slab_sq = host_tensor(arrays["slab_sq"], np.float32).to(dev)
            else:
                idx.slab_sq = (idx.slabs.float() ** 2).sum(-1)
            idx.ovf_vecs = host_tensor(arrays["ovf_vecs"], np.float32).to(dev)
        else:
            Cn = int(idx.slab_ids.shape[0])
            bf16 = Cn * idx.slab * idx.tdim * 4 > SLAB_BF16_BYTES
            idx.slabs, idx.slab_sq = _slabs_from_ids(
                idx.vectors, idx.slab_ids, idx._proj,
                out_dtype=torch.bfloat16 if bf16 else torch.float32,
                want_sq=idx.metric == C.DISTANCE_EUCLIDEAN,
            )
            ovf_rows = idx.vectors[idx.ovf_ids.clamp(0, cap - 1).long()]
            if idx._proj is not None:
                ovf_rows = ovf_rows @ idx._proj
            idx.ovf_vecs = torch.where((idx.ovf_ids != NIL)[:, None], ovf_rows, torch.zeros((), device=dev))
        # Host mirrors. _fill is a high-water mark (deletes blank slots in
        # place): last occupied slot + 1, not a count of live slots
        slab_ids = np.asarray(arrays["slab_ids"])
        S = slab_ids.shape[1]
        has = slab_ids != NIL
        idx._fill = np.where(has.any(axis=1), S - np.argmax(has[:, ::-1], axis=1), 0).astype(np.int32)
        # Overflow first: an id can sit in overflow (primary spill) and in
        # slabs (secondary copies); those slab slots belong under _loc2
        ovf_ids = np.asarray(arrays["ovf_ids"])
        idx._ovf_free = [int(j) for j in np.nonzero(ovf_ids == NIL)[0]]
        for j in np.nonzero(ovf_ids != NIL)[0]:
            idx._loc[int(ovf_ids[j])] = ("o", int(j))
        for c, s in zip(*np.nonzero(has)):
            i = int(slab_ids[c, s])
            if i in idx._loc:
                idx._loc2.setdefault(i, []).append((int(c), int(s)))
            else:
                idx._loc[i] = ("s", int(c), int(s))
        return idx


def _host(vecs) -> np.ndarray:
    return vecs.cpu().numpy() if isinstance(vecs, torch.Tensor) else np.asarray(vecs, np.float32)


def _slab_tensor(a) -> torch.Tensor:
    """Tensor of stored slabs: f32, or bf16 held as numpy's ``bfloat16``
    extension type (moved by its bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return host_tensor(a, np.float32)
