"""Pluggable vector store: plain, binary and product quantization.

Port of ``semadb_tpu/vectorstore/store.py``. Vectors are owned by the index;
the store holds the quantizer state as tensors on the index's device: packed
bits and the threshold for ``binary``, u8 codes, the codebooks and the
optional OPQ rotation for ``product``. Codes are indexed by node id.

The binary scan of the flat index goes through the hand-written CUDA kernel
K1 (``ops/kernels/hamming.py``), the product scan (ADC: each query's
per-subvector distance table, summed over the entries a row's codes select)
through K9's dense entry (``ops/kernels/ivf_pq_scan.py``); on CPU tensors
both run their plain PyTorch versions.

The product functions are the JAX package's: :func:`pq_fit` (per-subvector
k-means on a stride sample), :func:`opq_fit` (OPQ's alternating rotation and
codebook fit; the [D, D] SVD by ``torch.linalg.svd`` in f64 where the JAX
version takes numpy's on the host), :func:`pq_encode` (blocked past 2^26
distances), :func:`pq_query_table`, :func:`pq_gather_distance` (plain torch;
the Vamana engine's lookup) and :func:`pq_scan_distance`. Codebooks are fit
from ``torch.Generator`` seeds, so they match the JAX package's in quality,
not in bits.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.models.quantizer import Quantizer
from semadb_tpu_torch.ops import bitops
from semadb_tpu_torch.ops.distance import pairwise_distance
from semadb_tpu_torch.ops.kernels.hamming import pairwise_bit_distance_kernel
from semadb_tpu_torch.ops.kernels.ivf_pq_scan import pq_scan
from semadb_tpu_torch.ops.topk import INF
from semadb_tpu_torch.vectorstore.kmeans import kmeans_fit_subvectors

PLAIN = "plain"
BINARY = "binary"
PRODUCT = "product"


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantizer parameters."""

    kind: str  # plain | binary | product
    dim: int
    metric: str  # float metric of the index
    # binary
    bit_metric: str = C.DISTANCE_HAMMING
    threshold: Optional[float] = None  # fixed threshold; None = fit mean
    trigger: int = 0
    # product
    num_subvectors: int = 8
    num_centroids: int = 256
    # OPQ: learn an orthonormal rotation before the subvector split
    opq: bool = False
    # The user's index metric is hamming or jaccard (a forced binary store):
    # a search returns the bit distances and never reranks in a float metric
    user_bit_metric: bool = False

    @classmethod
    def from_params(cls, q: Optional[Quantizer], dim: int, metric: str) -> "QuantConfig":
        # Hamming/jaccard as user metrics: a fixed-threshold binary store —
        # users send float 0/1 vectors which are binarised at 0.5.
        if metric in (C.DISTANCE_HAMMING, C.DISTANCE_JACCARD):
            return cls(
                kind=BINARY, dim=dim, metric=C.DISTANCE_EUCLIDEAN,
                bit_metric=metric, threshold=0.5, user_bit_metric=True,
            )
        if q is None or q.type == C.QUANTIZER_NONE:
            return cls(kind=PLAIN, dim=dim, metric=metric)
        if q.type == C.QUANTIZER_BINARY:
            b = q.binary
            return cls(
                kind=BINARY, dim=dim, metric=metric, bit_metric=b.distance_metric,
                threshold=b.threshold, trigger=b.trigger_threshold,
            )
        if q.type == C.QUANTIZER_PRODUCT:
            p = q.product
            if dim % p.num_subvectors != 0:
                raise ValueError(f"vector size {dim} not divisible by numSubVectors {p.num_subvectors}")
            return cls(
                kind=PRODUCT, dim=dim, metric=metric, trigger=p.trigger_threshold,
                num_subvectors=p.num_subvectors, num_centroids=p.num_centroids,
                opq=getattr(p, "opq", False),
            )
        raise ValueError(f"unknown quantizer type {q.type}")


class QuantState(NamedTuple):
    """Fitted quantizer state and codes.

    binary: codes i32[cap, ceil(D/32)] (the JAX package's u32 words), aux =
    threshold f32[D]; product: codes u8[cap, M], aux = codebooks
    f32[M, K, D/M], rot = the optional OPQ rotation f32[D, D] (codes and
    codebooks live in the rotated space; queries rotate once a batch)."""

    codes: torch.Tensor
    aux: torch.Tensor
    rot: Optional[torch.Tensor] = None


def bq_fit_threshold(vectors: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-dimension mean over live rows."""
    m = mask.to(torch.float32)[:, None]
    return (vectors * m).sum(0) / m.sum().clamp(min=1.0)


def bq_encode(vectors: torch.Tensor, threshold: torch.Tensor, dim: int) -> torch.Tensor:
    return bitops.binarize(vectors, threshold, dim)


# Codebook fits need ~1k samples per centroid, not the corpus: call sites
# stride-subsample past this many rows (the encode still covers every row)
PQ_FIT_SAMPLE = 262144
# Elements of the [n, M, K] encode distances a block holds at most
ENCODE_BLOCK = 2**26


def _fill_masked(vectors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``vectors`` with the rows outside ``mask`` replaced by the mean live row."""
    m = mask.to(torch.float32)[:, None]
    mean = (vectors * m).sum(0) / m.sum().clamp(min=1.0)
    return torch.where(mask[:, None], vectors, mean[None, :])


def pq_fit(
    vectors: torch.Tensor, mask: torch.Tensor, m: int, k: int, seed: int = 0,
    stride: int = 1, max_iter: int = 100,
) -> torch.Tensor:
    """Codebooks f32[M, k, D/M] fit on the live rows (masked rows take the
    mean live row), every ``stride``-th row."""
    d = vectors.shape[1]
    filled = _fill_masked(vectors, mask)
    if stride > 1:
        filled = filled[::stride]
    sub = filled.reshape(-1, m, d // m).transpose(0, 1).contiguous()  # [M, N, dsub]
    centroids, _ = kmeans_fit_subvectors(sub, k, seed, max_iter)
    return centroids


def _pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Rows rebuilt from codes: u8[N, M] + f32[M, K, dsub] → f32[N, D]."""
    n, m = codes.shape
    sub = torch.arange(m, device=codes.device)[None, :]
    return codebooks[sub, codes.long()].reshape(n, -1)


def opq_fit(vectors: torch.Tensor, mask: torch.Tensor, m: int, k: int, iters: int = 6, seed: int = 0):
    """OPQ-NP (Ge et al., CVPR 2013): an orthonormal rotation R and the
    codebooks, learnt by alternating a PQ fit and encode in the rotated
    space with the Procrustes update R = U Vᵀ from SVD(Xᵀ·recon), on a
    ≤64k-row sample with at most 25 Lloyd rounds; the final codebooks are
    fit on a ≤PQ_FIT_SAMPLE-row sample. Returns (R f32[D, D], codebooks
    f32[M, K, dsub])."""
    n, d = vectors.shape
    filled = _fill_masked(vectors, mask)
    X = filled[:: max(n // 65536, 1)]
    ones = torch.ones((X.shape[0],), dtype=torch.bool, device=X.device)
    R = torch.eye(d, dtype=torch.float32, device=X.device)
    for _ in range(iters):
        Y = X @ R
        cb = pq_fit(Y, ones, m, k, seed, max_iter=25)
        recon = _pq_decode(pq_encode(Y, cb, m, k, C.DISTANCE_EUCLIDEAN), cb)
        u, _, vt = torch.linalg.svd((X.T @ recon).double())
        R = (u @ vt).float()
    cb = pq_fit(filled @ R, mask, m, k, seed, stride=max(n // PQ_FIT_SAMPLE, 1))
    return R, cb


def pq_encode(
    vectors: torch.Tensor, codebooks: torch.Tensor, m: int, k: int, metric: str,
    row_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Each subvector's nearest centroid by the index metric → u8[N, M].
    Blocked over rows past ``ENCODE_BLOCK`` elements of [N, M, K]
    distances. With ``row_ids``, ``vectors`` is the full backing matrix and
    rows are gathered block by block (no second [N, D] copy)."""
    n = row_ids.shape[0] if row_ids is not None else vectors.shape[0]
    if row_ids is None and n * m * k <= ENCODE_BLOCK:
        return _pq_encode_block(vectors, codebooks, m, k, metric)
    nb = max(ENCODE_BLOCK // (m * k), 256)
    out = torch.empty((n, m), dtype=torch.uint8, device=codebooks.device)
    for lo in range(0, n, nb):
        blk = vectors[row_ids[lo : lo + nb].long()] if row_ids is not None else vectors[lo : lo + nb]
        out[lo : lo + nb] = _pq_encode_block(blk, codebooks, m, k, metric)
    return out


def _subvector_dist(sub: torch.Tensor, codebooks: torch.Tensor, metric: str) -> torch.Tensor:
    """[n, M, K] distances of ``sub`` f32[n, M, dsub] to every centroid by
    the metric (euclidean: squared; dot: −x·c; cosine: 1 − x·c)."""
    cross = torch.einsum("nmd,mkd->nmk", sub, codebooks)
    if metric == C.DISTANCE_COSINE:
        return 1.0 - cross
    if metric == C.DISTANCE_DOT:
        return -cross
    sq_s = (sub * sub).sum(-1)[:, :, None]
    sq_c = (codebooks * codebooks).sum(-1)[None, :, :]
    return sq_s - 2.0 * cross + sq_c


def _pq_encode_block(vectors: torch.Tensor, codebooks: torch.Tensor, m: int, k: int, metric: str) -> torch.Tensor:
    n, d = vectors.shape
    dist = _subvector_dist(vectors.reshape(n, m, d // m), codebooks, metric)
    return torch.argmin(dist, dim=-1).to(torch.uint8)


def pq_query_table(queries: torch.Tensor, codebooks: torch.Tensor, m: int, k: int, metric: str) -> torch.Tensor:
    """ADC tables: each query subvector's distance to every centroid →
    f32[B, M, K] (M batched products, a library call)."""
    b, d = queries.shape
    return _subvector_dist(queries.reshape(b, m, d // m), codebooks, metric)


def pq_gather_distance(codes: torch.Tensor, ids: torch.Tensor, table: torch.Tensor, k: int) -> torch.Tensor:
    """ADC distance to gathered candidates: codes u8[cap, M], ids i32[B, Kc],
    table f32[B, M, K] → f32[B, Kc]."""
    b, m, _ = table.shape
    cand = codes[ids.long()].long()  # [B, Kc, M]
    flat_idx = (torch.arange(m, device=codes.device)[None, None, :] * k + cand).reshape(b, -1)
    vals = torch.gather(table.reshape(b, m * k), 1, flat_idx)
    return vals.reshape(b, cand.shape[1], m).sum(-1)


def pq_scan_distance(codes: torch.Tensor, mask: torch.Tensor, table: torch.Tensor, k: int) -> torch.Tensor:
    """Full ADC scan (flat index): codes u8[N, M], mask bool[N], table
    f32[B, M, K] → f32[B, N]; masked rows are +inf. K9's dense entry."""
    if table.shape[2] != k:
        raise ValueError(f"the tables hold {table.shape[2]} centroids a subvector, not {k}")
    return pq_scan(table, codes, mask.view(torch.uint8))


class VectorStore:
    """Quantizer state and fit trigger beside the index's raw vectors:
    fit once, when the live count reaches the trigger threshold."""

    def __init__(self, config: QuantConfig, device: torch.device):
        self.config = config
        self.device = torch.device(device)
        self.state: Optional[QuantState] = None
        if config.kind == BINARY and config.threshold is not None:
            # Fixed threshold → fitted from the start with an empty code table
            self.state = QuantState(
                codes=torch.zeros(
                    (0, bitops.packed_width(config.dim)), dtype=torch.int32, device=self.device
                ),
                aux=torch.full((config.dim,), config.threshold, dtype=torch.float32, device=self.device),
            )

    @property
    def fitted(self) -> bool:
        return self.state is not None

    def maybe_fit(self, vectors: torch.Tensor, exists_mask: torch.Tensor) -> bool:
        """Fit trigger check; encodes ALL live vectors on fit. Returns True
        if a fit happened."""
        if self.config.kind == PLAIN or self.fitted:
            return False
        if int(exists_mask.sum()) < max(self.config.trigger, 1):
            return False
        cfg = self.config
        if cfg.kind == BINARY:
            thr = bq_fit_threshold(vectors, exists_mask, cfg.dim)
            self.state = QuantState(codes=bq_encode(vectors, thr, cfg.dim), aux=thr)
            return True
        rot = None
        if cfg.opq:
            rot, cb = opq_fit(vectors, exists_mask, cfg.num_subvectors, cfg.num_centroids)
        else:
            cb = pq_fit(
                vectors, exists_mask, cfg.num_subvectors, cfg.num_centroids,
                stride=max(vectors.shape[0] // PQ_FIT_SAMPLE, 1),
            )
        enc_in = vectors if rot is None else vectors @ rot
        codes = pq_encode(enc_in, cb, cfg.num_subvectors, cfg.num_centroids, cfg.metric)
        self.state = QuantState(codes=codes, aux=cb, rot=rot)
        return True

    def encode_rows(self, vectors: torch.Tensor, row_ids: np.ndarray) -> None:
        """Encode newly written rows into the code table (post-fit inserts)."""
        if not self.fitted or self.config.kind == PLAIN:
            return
        self.ensure_rows(vectors.shape[0])
        ids = torch.as_tensor(np.asarray(row_ids, np.int64), device=self.device)
        rows = vectors.index_select(0, ids)
        cfg = self.config
        if cfg.kind == BINARY:
            new = bq_encode(rows, self.state.aux, cfg.dim)
        else:
            if self.state.rot is not None:
                rows = rows @ self.state.rot
            new = pq_encode(rows, self.state.aux, cfg.num_subvectors, cfg.num_centroids, cfg.metric)
        # In place, where the JAX package built a new table with .at[].set
        self.state.codes.index_copy_(0, ids, new)

    def prepare_queries(self, queries: torch.Tensor) -> Optional[torch.Tensor]:
        """Per-batch query preparation: packed bits for binary, the ADC
        tables for product, None otherwise (or before the fit)."""
        if not self.fitted:
            return None
        cfg = self.config
        if cfg.kind == BINARY:
            return bq_encode(queries, self.state.aux, cfg.dim)
        if cfg.kind == PRODUCT:
            q = queries if self.state.rot is None else queries @ self.state.rot
            return pq_query_table(q, self.state.aux, cfg.num_subvectors, cfg.num_centroids, cfg.metric)
        return None

    def scan_distances(self, queries: torch.Tensor, vectors: torch.Tensor, mask: torch.Tensor):
        """Full-scan distances for the flat index through the active
        quantization; rows outside ``mask`` are INF. A binary store returns
        raw bit distances, a product store ADC distances (no float rerank)."""
        if not self.fitted or self.config.kind == PLAIN:
            d = pairwise_distance(queries, vectors, self.config.metric)
        elif self.config.kind == BINARY:
            qc = bq_encode(queries, self.state.aux, self.config.dim)
            d = pairwise_bit_distance_kernel(qc, self.state.codes, self.config.bit_metric)
        else:
            return pq_scan_distance(self.state.codes, mask, self.prepare_queries(queries), self.config.num_centroids)
        return d.masked_fill_(~mask[None, :], INF)

    # -- persistence --------------------------------------------------------
    def to_arrays(self) -> dict:
        """Host arrays in the JAX package's layout (binary codes as uint32)."""
        return {k: _host_array(v) for k, v in self.device_arrays().items()}

    def device_arrays(self) -> dict:
        """Device-resident view (no readback) for the snapshot writer; binary
        codes are a uint32 view so snapshots carry the JAX package's dtype."""
        out = {"kind": self.config.kind, "fitted": self.fitted}
        if self.fitted:
            codes = self.state.codes
            out["codes"] = codes.view(torch.uint32) if codes.dtype == torch.int32 else codes
            out["aux"] = self.state.aux
            if self.state.rot is not None:
                out["rot"] = self.state.rot
        return out

    def ensure_rows(self, n: int) -> None:
        """Pad the code table with zero rows to at least ``n`` rows."""
        if self.fitted and self.state.codes.shape[0] < n:
            old = self.state.codes
            codes = old.new_zeros((n, old.shape[1]))
            codes[: old.shape[0]] = old
            self.state = self.state._replace(codes=codes)

    def load_arrays(self, arrays: dict) -> None:
        """Load the ``to_arrays`` layout of either package (binary codes as
        uint32 or int32: the same bits; product codes as uint8)."""
        if arrays.get("fitted"):
            codes = np.ascontiguousarray(arrays["codes"])
            codes = codes if self.config.kind == PRODUCT else codes.view(np.int32)
            self.state = QuantState(
                codes=host_tensor(codes, codes.dtype).to(self.device),
                aux=host_tensor(arrays["aux"], np.float32).to(self.device),
                rot=host_tensor(arrays["rot"], np.float32).to(self.device) if "rot" in arrays else None,
            )


def _host_array(v):
    """numpy copy of a tensor (uint32 through its int32 bits), else ``v``."""
    if not isinstance(v, torch.Tensor):
        return v
    if v.dtype == torch.uint32:
        return v.view(torch.int32).cpu().numpy().view(np.uint32)
    return v.cpu().numpy()


def host_tensor(a, dtype) -> torch.Tensor:
    """CPU tensor over a numpy array (copied only when it is read-only, as
    arrays read back from JAX are)."""
    a = np.ascontiguousarray(a, dtype=dtype)
    return torch.from_numpy(a if a.flags.writeable else a.copy())
