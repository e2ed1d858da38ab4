"""Query batches from the host to the device.

A host batch (a numpy array or a CPU tensor) of at least ``PINNED_MIN_BYTES``
in float32, bound for a CUDA device, takes the pinned route: torch's
multi-threaded CPU copy fills a pinned staging tensor, converting to
contiguous float32 on the way, in chunks of about ``UPLOAD_CHUNK_BYTES``; each
chunk's copy to the device is issued on the current stream, without a wait,
as soon as the chunk is filled, so the copy of one chunk runs while the host
fills the next, and the call returns with the copies queued. A pageable
``.to(device)`` would stage the rows through CUDA's own staging buffer, on one
thread, and hold the host until the copy ends.

The staging tensors come from PyTorch's caching host allocator, which records
each copy's event on its buffer and hands the buffer out again only once
those events have passed: a buffer is never refilled while its copy runs, and
nothing here waits on the stream.

Every other batch takes the direct route, ``.to(device)``: a
smaller host batch, a tensor already on a device, or any batch for an index
on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Host batches from this many float32 bytes take the pinned route. In a closed
# loop of searches on the H100 it served 1,536-d batches of 6.3 MB 25% faster
# than the direct route and of 25.2 MB 74% faster, but 128-d batches of 2.1 MB
# (the v2 limit of 4,096 queries) 7% slower: its fill wakes torch's CPU
# threads, which then spin through the search that follows (PERF.md, host
# dispatch)
PINNED_MIN_BYTES = 4 << 20
# Bytes a chunk holds (whole rows; at least one): of 2, 4, 8 and 16 MiB and one
# chunk a batch, the 25.2 MB batch went fastest in chunks of 16 MiB
UPLOAD_CHUNK_BYTES = 16 << 20
# Uploads by route, and the pinned route's bytes and host-to-device copies
UPLOADS = {"pinned": 0, "direct": 0, "bytes": 0, "chunks": 0}
_TORCH_FLOATS = (np.float16, np.float32, np.float64)


def chunk_rows(rows: int, row_bytes: int) -> list[tuple[int, int]]:
    """The row ranges [r0, r1) of the chunks of a batch of ``rows`` rows of
    ``row_bytes`` bytes: in order, each row once."""
    step = max(1, UPLOAD_CHUNK_BYTES // max(row_bytes, 1))
    return [(r, min(r + step, rows)) for r in range(0, rows, step)]


def upload_queries(queries, device) -> torch.Tensor:
    """A batch of queries (numpy array, nested sequence or tensor) as a
    float32 tensor of at least two dimensions on ``device``, contiguous unless
    a numpy view stays one on the CPU; on the pinned route its copies may
    still be running on the current stream when this returns."""
    device = torch.device(device)
    if device.type == "cuda" and (not isinstance(queries, torch.Tensor) or queries.device.type == "cpu"):
        src = _host_rows(queries)
        if 4 * src.numel() >= PINNED_MIN_BYTES:
            return _pinned(src, device)
    return _direct(queries, device)


def _direct(queries, device: torch.device) -> torch.Tensor:
    UPLOADS["direct"] += 1
    if isinstance(queries, torch.Tensor):
        return torch.atleast_2d(queries).to(device, torch.float32).contiguous()
    return torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(device)


def _pinned(src: torch.Tensor, device: torch.device) -> torch.Tensor:
    staging = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
    out = torch.empty(src.shape, dtype=torch.float32, device=device)
    chunks = _staged_copy(src, staging, out)
    UPLOADS["pinned"] += 1
    UPLOADS["bytes"] += staging.nbytes
    UPLOADS["chunks"] += chunks
    return out


def _host_rows(queries) -> torch.Tensor:
    """A host batch as a CPU tensor of at least two dimensions, left in its
    own dtype and strides where torch's copy converts it."""
    if isinstance(queries, torch.Tensor):
        return torch.atleast_2d(queries)
    a = np.atleast_2d(np.asarray(queries))
    # torch converts floats on its threads; numpy converts the rest, and the
    # reversed views that torch.from_numpy refuses
    if a.dtype not in _TORCH_FLOATS or min(a.strides) < 0:
        a = np.ascontiguousarray(a, np.float32)
    return torch.from_numpy(a)


def _staged_copy(src: torch.Tensor, staging: torch.Tensor, out: torch.Tensor) -> int:
    """Fill ``staging`` from ``src`` chunk by chunk, and issue each chunk's
    copy to ``out`` without a wait once it is filled; returns the chunks."""
    chunks = chunk_rows(src.shape[0], 4 * math.prod(src.shape[1:]))
    for r0, r1 in chunks:
        staging[r0:r1].copy_(src[r0:r1])
        out[r0:r1].copy_(staging[r0:r1], non_blocking=True)
    return len(chunks)
