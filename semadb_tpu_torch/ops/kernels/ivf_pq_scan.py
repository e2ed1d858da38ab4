"""Hand-written CUDA kernel K9: the ADC scan of product-quantized codes.

Replaces the XLA programs of ``semadb_tpu/index/ivf.py`` · ``_ivf_query_pq``
that score the probed code slabs (``:579-605``) and take the pool, and of
``semadb_tpu/vectorstore/store.py`` · ``pq_scan_distance`` (``:330-347``). ADC
(asymmetric distance computation): each query has a distance table
f32[M, K], one row of K centroid distances per subvector, and a row whose
codes are u8[M] scores sum_m table[m, code[m]].

One source (``semadb_tpu_torch/csrc/ivf_pq_scan.cu``), two entries:

- :func:`ivf_pq_probe_scan`: ``table`` f32[B, M, K] x ``probe`` i32[B, p] x
  ``slab_codes`` u8[C, S, M] x ``slab_ids`` i32[C, S] (x ``mask`` u8[n]) →
  the ``rr`` smallest scores over the probed slots, ascending, with their
  ids, as K3 returns them: NIL slots (id -1), ids the mask refuses and probes
  outside [0, C) are left out, unfilled places are ``(inf, -1)``, equal
  scores may come in any order;
- :func:`pq_scan`: ``table`` f32[B, M, K] x ``codes`` u8[N, M] (x ``mask``
  u8[N]) → f32[B, N], rows outside the mask +inf.

Built like K3 and K4: ``nvcc`` for ``sm_90a`` into ``semadb_tpu_torch/_build/``
at first use, loaded with ``ctypes``. The source's header says what bounds
it. For CPU tensors each entry runs its plain PyTorch version (a
``take_along_dim`` gather of the tables summed over m, then ``topk``); for
CUDA tensors it launches the kernel or raises, never falls back. ``LAUNCHES``
counts launching calls of both entries, ``LAUNCHES_BY`` by entry.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from semadb_tpu_torch.utils.build import CSRC_DIR, NVCC_FLAGS, build_library, nvcc

SOURCE = os.path.join(CSRC_DIR, "ivf_pq_scan.cu")
HEADERS = (os.path.join(CSRC_DIR, "smem_optin.cuh"),)
MAX_RR = 2048
MAX_K = 256  # codes are u8
# Shared memory a block may take on the H100 (227 KB): the query's table and,
# in the probed entry, the chunk's keys and two kept sets
SMEM_BYTES = 227 * 1024
# The probed entry's block: its threads, and what it holds in static shared
# memory (the radix histogram and a few counters; an upper bound)
THREADS = 256
STATIC_SMEM = 2048
# Most slots the probed entry scores between two selections (a multiple of
# THREADS); fewer where shared memory runs short
CHUNK = 4096
NIL = -1
# The device kernels' names (profiler events hold them), by entry
KERNELS = {"probed": ("pq_probe_scan_kernel",), "dense": ("pq_scan_dense_kernel",)}
# Elements of the [B, rows, M] gather per step of the plain versions
PLAIN_CHUNK = 1 << 26

LAUNCHES = 0
LAUNCHES_BY: dict = {}
BUILD_LOG = ""

_LIB = None
_LOCK = threading.Lock()


def _adc(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """sum_m table[b, m, codes[b, r, m]] for codes u8[B, R, M] → f32[B, R]."""
    B, M, K = table.shape
    idx = codes.long() + torch.arange(M, device=codes.device) * K  # u8 indexes as a mask: widen first
    return torch.gather(table.reshape(B, M * K), 1, idx.reshape(B, -1)).reshape(idx.shape).sum(-1)


def ivf_pq_probe_scan_plain(
    table: torch.Tensor, probe: torch.Tensor, slab_codes: torch.Tensor, slab_ids: torch.Tensor,
    mask: Optional[torch.Tensor], rr: int,
):
    """Plain PyTorch version: probe chunk by probe chunk, gather the probed
    code slabs, look the codes up in the tables, and carry the top ``rr``."""
    _check_probed(table, probe, slab_codes, slab_ids, mask, rr)
    B, p = probe.shape
    C, S, M = slab_codes.shape
    pc = max(1, min(p, PLAIN_CHUNK // max(B * S * M, 1)))
    best_d = torch.full((B, 0), float("inf"), dtype=torch.float32, device=table.device)
    best_i = torch.full((B, 0), NIL, dtype=torch.int32, device=table.device)
    for j0 in range(0, p, pc):
        pr = probe[:, j0 : j0 + pc].long()
        in_range = (pr >= 0) & (pr < C)
        prc = pr.clamp(0, C - 1)
        ids = slab_ids[prc]  # [B, pc, S]
        d = _adc(table, slab_codes[prc].reshape(B, -1, M)).reshape(ids.shape)
        ok = (ids != NIL) & in_range[..., None]
        if mask is not None:
            n = mask.shape[0]
            ok &= (ids >= 0) & (ids < n) & mask[ids.clamp(0, max(n - 1, 0)).long()].bool()
        d = torch.cat([best_d, d.masked_fill(~ok, float("inf")).reshape(B, -1)], dim=1)
        ids = torch.cat([best_i, ids.masked_fill(~ok, NIL).reshape(B, -1)], dim=1)
        best_d, pos = torch.topk(d, min(rr, d.shape[1]), dim=1, largest=False, sorted=True)
        best_i = torch.gather(ids, 1, pos)
    best_i = best_i.masked_fill(~torch.isfinite(best_d), NIL)
    if best_d.shape[1] < rr:
        pad = rr - best_d.shape[1]
        best_d = torch.cat([best_d, best_d.new_full((B, pad), float("inf"))], dim=1)
        best_i = torch.cat([best_i, best_i.new_full((B, pad), NIL)], dim=1)
    return best_d, best_i


def pq_scan_plain(table: torch.Tensor, codes: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the dense entry: the JAX ``pq_scan_distance``'s
    flat gather over [B, M·K], blocked over rows."""
    _check_dense(table, codes, mask)
    B, M, K = table.shape
    N = codes.shape[0]
    out = torch.empty((B, N), dtype=torch.float32, device=table.device)
    nb = max(1, PLAIN_CHUNK // max(B * M, 1))
    for lo in range(0, N, nb):
        blk = codes[lo : lo + nb]
        out[:, lo : lo + nb] = _adc(table, blk[None].expand(B, -1, -1))
    if mask is not None:
        out.masked_fill_(~mask.bool()[None, :], float("inf"))
    return out


def _cap(rr: int) -> int:
    """Entries of each of the probed entry's two kept sets: the power of two
    at or above rr (the final sort's width)."""
    n = 1
    while n < rr:
        n <<= 1
    return n


def _chunk(slots: int, mk: int, rr: int) -> int:
    """Slots the probed entry's block scores between two selections: all of
    a query's ``slots`` up to CHUNK, in whole THREADS, and no more than the
    shared memory beside the table (``mk`` floats) and the kept sets holds;
    0 when not even THREADS fit."""
    room = (SMEM_BYTES - STATIC_SMEM) // 4 - mk - 4 * _cap(rr)
    want = min(CHUNK, -(-max(slots, 1) // THREADS) * THREADS)
    return min(want, room // THREADS * THREADS)


def _on_cuda(tensors, what: str) -> bool:
    """True for CUDA operands (all on one device, contiguous), False for CPU
    ones; raises for a mix."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = tensors[0].device
    if any(t.device != dev for t in tensors) or dev.type != "cuda":
        raise ValueError(f"{what} operands must all lie on one CUDA device; got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} operands must be contiguous")
    return True


def _count(entry: str) -> None:
    global LAUNCHES
    with _LOCK:
        LAUNCHES += 1
        LAUNCHES_BY[entry] = LAUNCHES_BY.get(entry, 0) + 1


def ivf_pq_probe_scan(
    table: torch.Tensor, probe: torch.Tensor, slab_codes: torch.Tensor, slab_ids: torch.Tensor,
    mask: Optional[torch.Tensor], rr: int,
):
    """The probed entry: (f32[B, rr], i32[B, rr]). The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    tensors = (table, probe, slab_codes, slab_ids) + ((mask,) if mask is not None else ())
    if not _on_cuda(tensors, "K9"):
        return ivf_pq_probe_scan_plain(table, probe, slab_codes, slab_ids, mask, rr)
    _check_probed(table, probe, slab_codes, slab_ids, mask, rr)
    B = probe.shape[0]
    chunk = _chunk(probe.shape[1] * slab_codes.shape[1], table.shape[1] * table.shape[2], rr)
    out = launch_probed(_library() if B else None, table, probe, slab_codes, slab_ids, mask, rr, chunk)
    if B:
        _count("probed")
    return out


def launch_probed(lib, table, probe, slab_codes, slab_ids, mask, rr: int, work: int):
    """One launch of a probed-entry library (:func:`bind`) on checked,
    contiguous operands on one CUDA device (none for an empty batch, which
    needs no ``lib``); ``work`` is the int the C interface takes after rr
    (this source's chunk). Counts nothing; raises if it is refused."""
    B, p = probe.shape
    C, S, M = slab_codes.shape
    K = table.shape[2]
    dev = table.device
    out_d = torch.empty((B, rr), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, rr), dtype=torch.int32, device=dev)
    if B == 0:
        return out_d, out_i
    with torch.cuda.device(dev):
        rc = lib.semadb_pq_probe_scan(
            table.data_ptr(), probe.data_ptr(), slab_codes.data_ptr(), slab_ids.data_ptr(),
            None if mask is None else mask.data_ptr(), 0 if mask is None else mask.shape[0],
            B, p, C, S, M, K, rr, work, out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"K9 probed launch failed ({rc}: {lib.semadb_pq_error_string(rc).decode()}) "
            f"at B={B} p={p} C={C} S={S} M={M} K={K} rr={rr} work={work}"
        )
    return out_d, out_i


def pq_scan(table: torch.Tensor, codes: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The dense entry: f32[B, N]. The kernel for CUDA tensors, the plain
    version for CPU tensors."""
    tensors = (table, codes) + ((mask,) if mask is not None else ())
    if not _on_cuda(tensors, "K9"):
        return pq_scan_plain(table, codes, mask)
    _check_dense(table, codes, mask)
    B, M, K = table.shape
    N = codes.shape[0]
    out = torch.empty((B, N), dtype=torch.float32, device=table.device)
    if B == 0 or N == 0:
        return out
    lib = _library()
    with torch.cuda.device(table.device):
        rc = lib.semadb_pq_scan_dense(
            table.data_ptr(), codes.data_ptr(), None if mask is None else mask.data_ptr(), B, N, M, K,
            out.data_ptr(), torch.cuda.current_stream(table.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"K9 dense launch failed ({rc}: {lib.semadb_pq_error_string(rc).decode()}) at B={B} N={N} M={M} K={K}"
        )
    _count("dense")
    return out


def _check_table(table: torch.Tensor, m: int) -> None:
    if table.dtype != torch.float32 or table.dim() != 3 or table.shape[1] != m:
        raise TypeError(f"tables must be f32[B, {m}, K], got {table.dtype} {tuple(table.shape)}")
    if not 1 <= table.shape[2] <= MAX_K:
        raise ValueError(f"K must lie in [1, {MAX_K}], got {table.shape[2]}")


def _check_probed(table, probe, slab_codes, slab_ids, mask, rr) -> None:
    if slab_codes.dtype != torch.uint8 or slab_codes.dim() != 3:
        raise TypeError(f"slab_codes must be u8[C, S, M], got {slab_codes.dtype} {tuple(slab_codes.shape)}")
    C, S, M = slab_codes.shape
    _check_table(table, M)
    if probe.dtype != torch.int32 or slab_ids.dtype != torch.int32:
        raise TypeError(f"probe and slab_ids must be int32, got {probe.dtype} and {slab_ids.dtype}")
    if probe.dim() != 2 or probe.shape[0] != table.shape[0] or slab_ids.shape != (C, S):
        raise ValueError(f"probe {tuple(probe.shape)} and slab_ids {tuple(slab_ids.shape)} do not fit "
                         f"tables {tuple(table.shape)} and codes {tuple(slab_codes.shape)}")
    if mask is not None and (mask.dtype != torch.uint8 or mask.dim() != 1):
        raise TypeError(f"mask must be 1-D uint8, got {mask.dtype} {tuple(mask.shape)}")
    if not 1 <= rr <= MAX_RR:
        raise ValueError(f"rr must lie in [1, {MAX_RR}], got {rr}")
    if _chunk(probe.shape[1] * S, M * table.shape[2], rr) < THREADS:
        raise ValueError(f"a table of M={M} x K={table.shape[2]} and a pool of {rr} exceed one block's shared memory")


def _check_dense(table, codes, mask) -> None:
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError(f"codes must be u8[N, M], got {codes.dtype} {tuple(codes.shape)}")
    _check_table(table, codes.shape[1])
    if mask is not None and (mask.dtype != torch.uint8 or mask.shape != (codes.shape[0],)):
        raise TypeError(f"mask must be u8[{codes.shape[0]}], got {mask.dtype} {tuple(mask.shape)}")
    if table.shape[1] * table.shape[2] * 4 > SMEM_BYTES:
        raise ValueError(f"a table of {tuple(table.shape[1:])} exceeds one block's shared memory")


def bind(path: str):
    """Load a library built from a K9 source with this C interface."""
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.semadb_pq_probe_scan.restype = i32
    lib.semadb_pq_probe_scan.argtypes = [ptr, ptr, ptr, ptr, ptr, i64] + [i32] * 8 + [ptr, ptr, ptr]
    lib.semadb_pq_scan_dense.restype = i32
    lib.semadb_pq_scan_dense.argtypes = [ptr, ptr, ptr, i32, i64, i32, i32, ptr, ptr]
    lib.semadb_pq_error_string.restype = ctypes.c_char_p
    lib.semadb_pq_error_string.argtypes = [i32]
    return lib


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is None:
            path, BUILD_LOG = build_library("ivf_pq_scan", SOURCE, nvcc(), NVCC_FLAGS, HEADERS)
            _LIB = bind(path)
        return _LIB
