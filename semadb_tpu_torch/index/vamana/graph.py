"""Device-resident Vamana graph state.

Port of ``semadb_tpu/index/vamana/graph.py``. The graph is three dense
tensors on one device, as in the JAX package:

  - ``vectors    f32[cap, D]``   — slot 0 reserved (nil id), slot 1 = start
  - ``adjacency  i32[cap, R]``   — fixed degree bound R, ``-1`` padded
  - ``exists     bool[cap]``     — slot holds a live node (start included)

Node ids are the row indices. Where the JAX package built new arrays under
``jit``, the port's writers update these tensors in place
(``build.insert_batch`` and ``build.delete_batch`` return the state they
were given).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from semadb_tpu_torch.models import constants as C
from semadb_tpu_torch.utils.grow import initial_capacity, next_capacity

NIL = -1  # adjacency padding sentinel
START_ID = C.START_NODE_ID  # row 1, entry point; never a user point

MIN_CAPACITY = 128


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """The graph's parameters (models.VectorVamanaParams; reference:
    models/index.go IndexVectorVamanaParameters)."""

    dim: int
    metric: str = C.DISTANCE_EUCLIDEAN
    degree_bound: int = 64
    search_size: int = 75
    alpha: float = 1.2


class GraphState(NamedTuple):
    vectors: torch.Tensor  # f32[cap, D]
    adjacency: torch.Tensor  # i32[cap, R]
    exists: torch.Tensor  # bool[cap]

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def row_bytes(config: GraphConfig) -> int:
    """Bytes of one node's row (vector + adjacency), which sizes the growth
    chain's floor."""
    return (config.dim + config.degree_bound) * 4


def make_start_vector(dim: int, seed: int = 0) -> np.ndarray:
    """Random unit vector for the start node (vamana.go:93-120); numpy, so it
    is the JAX package's bit for bit."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, size=dim).astype(np.float32)
    return v / np.linalg.norm(v)


def base_capacity(config: GraphConfig) -> int:
    """The first capacity of the growth chain: the 128 floor, or the
    pre-grown start (SEMADB_PREGROW_ROWS)."""
    return max(MIN_CAPACITY, initial_capacity(row_bytes(config), MIN_CAPACITY))


def init_graph(config: GraphConfig, device: torch.device, capacity: int = MIN_CAPACITY,
               seed: int = 0) -> GraphState:
    capacity = max(int(capacity), base_capacity(config))
    vectors = torch.zeros((capacity, config.dim), dtype=torch.float32, device=device)
    vectors[START_ID] = torch.from_numpy(make_start_vector(config.dim, seed)).to(device)
    adjacency = torch.full((capacity, config.degree_bound), NIL, dtype=torch.int32, device=device)
    exists = torch.zeros((capacity,), dtype=torch.bool, device=device)
    exists[START_ID] = True
    return GraphState(vectors=vectors, adjacency=adjacency, exists=exists)


def grow_graph(state: GraphState, new_capacity: int) -> GraphState:
    """Capacity growth: new tensors, the old rows copied in (rare)."""
    cap = state.capacity
    if new_capacity <= cap:
        return state
    vectors = state.vectors.new_zeros((new_capacity, state.vectors.shape[1]))
    vectors[:cap] = state.vectors
    adjacency = state.adjacency.new_full((new_capacity, state.adjacency.shape[1]), NIL)
    adjacency[:cap] = state.adjacency
    exists = state.exists.new_zeros((new_capacity,))
    exists[:cap] = state.exists
    return GraphState(vectors=vectors, adjacency=adjacency, exists=exists)


def required_capacity(max_id: int, config: GraphConfig, current: int = 0) -> int:
    """Capacity holding ``max_id`` on the growth chain that starts at
    :func:`base_capacity` (floor bucket then ×factor, utils/grow.py).
    Growing live (from ``current``, a point of the chain) and re-padding a
    row-bounded snapshot (from the base) land on the same point."""
    return next_capacity(max(current, base_capacity(config)), max_id, row_bytes(config))


def edge_counts(adjacency: torch.Tensor) -> torch.Tensor:
    """Number of valid (non-NIL) edges per node: i32[cap]."""
    return (adjacency != NIL).sum(-1, dtype=torch.int32)


def live_count(state: GraphState) -> int:
    """Number of user points (excludes the start node)."""
    return int(state.exists.sum()) - 1
