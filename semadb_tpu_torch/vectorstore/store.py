"""Pluggable vector store: plain and binary quantization.

Port of ``semadb_tpu/vectorstore/store.py`` for the ``plain`` and ``binary``
kinds. Vectors are owned by the index; the store holds the quantizer state
(packed codes indexed by node id, plus the threshold) as tensors on the
index's device. Product quantization is not ported yet: constructing a
``product`` store raises ``NotImplementedError``.

The binary scan of the flat index goes through the hand-written CUDA kernel
(``ops/kernels/hamming.py``) on a CUDA device, and through its plain PyTorch
version on the CPU.
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
from semadb_tpu_torch.ops.topk import INF

PLAIN = "plain"
BINARY = "binary"
PRODUCT = "product"


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantizer parameters (the JAX package's fields for the
    ported kinds; a ``product`` config carries only its kind)."""

    kind: str  # plain | binary | product
    dim: int
    metric: str  # float metric of the index
    # binary
    bit_metric: str = C.DISTANCE_HAMMING
    threshold: Optional[float] = None  # fixed threshold; None = fit mean
    trigger: int = 0

    @classmethod
    def from_params(cls, q: Optional[Quantizer], dim: int, metric: str) -> "QuantConfig":
        # Hamming/jaccard as user metrics: a fixed-threshold binary store —
        # users send float 0/1 vectors which are binarised at 0.5.
        if metric in (C.DISTANCE_HAMMING, C.DISTANCE_JACCARD):
            return cls(
                kind=BINARY, dim=dim, metric=C.DISTANCE_EUCLIDEAN,
                bit_metric=metric, threshold=0.5,
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
            return cls(kind=PRODUCT, dim=dim, metric=metric)
        raise ValueError(f"unknown quantizer type {q.type}")


class QuantState(NamedTuple):
    """Fitted binary quantizer: codes i32[cap, ceil(D/32)] (the JAX
    package's u32 words), aux = threshold f32[D]."""

    codes: torch.Tensor
    aux: torch.Tensor


def bq_fit_threshold(vectors: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-dimension mean over live rows."""
    m = mask.to(torch.float32)[:, None]
    return (vectors * m).sum(0) / m.sum().clamp(min=1.0)


def bq_encode(vectors: torch.Tensor, threshold: torch.Tensor, dim: int) -> torch.Tensor:
    return bitops.binarize(vectors, threshold, dim)


class VectorStore:
    """Quantizer state and fit trigger beside the index's raw vectors:
    fit once, when the live count reaches the trigger threshold."""

    def __init__(self, config: QuantConfig, device: torch.device):
        if config.kind == PRODUCT:
            raise NotImplementedError(
                "product quantization is not ported to semadb_tpu_torch yet "
                "(ROADMAP.md, queue 1: IVF-PQ and PQ)"
            )
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
        thr = bq_fit_threshold(vectors, exists_mask, self.config.dim)
        self.state = QuantState(codes=bq_encode(vectors, thr, self.config.dim), aux=thr)
        return True

    def encode_rows(self, vectors: torch.Tensor, row_ids: np.ndarray) -> None:
        """Encode newly written rows into the code table (post-fit inserts)."""
        if not self.fitted or self.config.kind == PLAIN:
            return
        self.ensure_rows(vectors.shape[0])
        ids = torch.as_tensor(np.asarray(row_ids, np.int64), device=self.device)
        new = bq_encode(vectors.index_select(0, ids), self.state.aux, self.config.dim)
        # In place, where the JAX package built a new table with .at[].set
        self.state.codes.index_copy_(0, ids, new)

    def scan_distances(self, queries: torch.Tensor, vectors: torch.Tensor, mask: torch.Tensor):
        """Exact full-scan distances for the flat index through the active
        quantization; rows outside ``mask`` are INF. A binary store returns
        raw bit distances (no float rerank)."""
        if not self.fitted or self.config.kind == PLAIN:
            d = pairwise_distance(queries, vectors, self.config.metric)
        else:
            qc = bq_encode(queries, self.state.aux, self.config.dim)
            d = pairwise_bit_distance_kernel(qc, self.state.codes, self.config.bit_metric)
        return d.masked_fill_(~mask[None, :], INF)

    # -- persistence --------------------------------------------------------
    def to_arrays(self) -> dict:
        """Host arrays in the JAX package's layout: codes as uint32."""
        out = {"kind": self.config.kind, "fitted": self.fitted}
        if self.fitted:
            out["codes"] = self.state.codes.cpu().numpy().view(np.uint32)
            out["aux"] = self.state.aux.cpu().numpy()
        return out

    def device_arrays(self) -> dict:
        """Device-resident view (no readback) for the snapshot writer; the
        codes are a uint32 view so snapshots carry the JAX package's dtype."""
        out = {"kind": self.config.kind, "fitted": self.fitted}
        if self.fitted:
            out["codes"] = self.state.codes.view(torch.uint32)
            out["aux"] = self.state.aux
        return out

    def ensure_rows(self, n: int) -> None:
        """Pad the code table with zero rows to at least ``n`` rows."""
        if self.fitted and self.state.codes.shape[0] < n:
            codes = torch.zeros(
                (n, self.state.codes.shape[1]), dtype=torch.int32, device=self.device
            )
            codes[: self.state.codes.shape[0]] = self.state.codes
            self.state = QuantState(codes=codes, aux=self.state.aux)

    def load_arrays(self, arrays: dict) -> None:
        """Load the ``to_arrays`` layout of either package (codes as
        uint32 or int32: the same bits)."""
        if arrays.get("fitted"):
            codes = np.ascontiguousarray(arrays["codes"]).view(np.int32)
            self.state = QuantState(
                codes=host_tensor(codes, np.int32).to(self.device),
                aux=host_tensor(arrays["aux"], np.float32).to(self.device),
            )


def host_tensor(a, dtype) -> torch.Tensor:
    """CPU tensor over a numpy array (copied only when it is read-only, as
    arrays read back from JAX are)."""
    a = np.ascontiguousarray(a, dtype=dtype)
    return torch.from_numpy(a if a.flags.writeable else a.copy())
