"""Hand-written CUDA kernel K3: the IVF probed-slab scan with a running top-rr.

Replaces the XLA program of ``semadb_tpu/index/ivf.py`` · ``_ivf_query`` that
scores the probed slabs (``:428-442``) and takes the coarse pool
(``:507-509``). The kernel source is ``semadb_tpu_torch/csrc/ivf_scan.cu``
(with ``csrc/ivf_common.cuh``); it is bound by bytes, and its header says
what the design does about that. It is built like K1 and K2: ``nvcc`` for
``sm_90a`` into ``semadb_tpu_torch/_build/`` at first use, loaded with
``ctypes``.

The design is cluster-major: the probe list is inverted on the device, each
probed cluster is read once per group of up to Q of the (query, probe) pairs
that name it, every pair's slot scores go to a scratch buffer, and each
query's scores are merged into its top-rr. A call is five kernels and a
memset (``KERNELS``), and a scratch of B * p * S floats, which the wrapper
keeps under ``SCRATCH_BYTES`` by running B in chunks.

:func:`ivf_probe_scan` returns the ``rr`` smallest coarse scores
``slab_sq - 2 <slab row, qp>`` over the probed slots, ascending, with their
ids; NIL slots (id -1) and slots whose id the mask refuses are left out, and
unfilled places are ``(inf, -1)``. Equal scores may come in any order. For
CPU tensors it runs :func:`ivf_probe_scan_plain`, the plain PyTorch version
(the JAX program's probe-chunked gather and einsum, then ``topk``); for CUDA
tensors it launches the kernels or raises — it never falls back.
``LAUNCHES`` counts wrapper calls that launched (one a call, whatever the
number of chunks).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from semadb_tpu_torch.utils.build import CSRC_DIR, NVCC_FLAGS, build_library, nvcc

SOURCE = os.path.join(CSRC_DIR, "ivf_scan.cu")
HEADERS = (os.path.join(CSRC_DIR, "ivf_common.cuh"),)
SLAB_DTYPES = (torch.float32, torch.bfloat16)
MAX_RR = 2048  # the largest pool the merge keeps in shared memory
MAX_R = 4096
NIL = -1
# Bytes of the [B, pchunk, S, r] gather per step of the plain version
PLAIN_CHUNK_BYTES = 1 << 30
# The scratch (B * p * S scores of 4 bytes) stays under this many bytes: B
# runs in chunks past it
SCRATCH_BYTES = 1 << 30
# The device kernels of one call (and of each further chunk of B), besides
# one memset that zeroes the work area's counters
KERNELS = ("ivf_scan_count", "ivf_scan_offsets", "ivf_scan_invert", "ivf_scan_score", "ivf_scan_merge")

LAUNCHES = 0
BUILD_LOG = ""  # nvcc's output of the build this process did (ptxas -v)

_LIB = None
_LOCK = threading.Lock()


def ivf_probe_scan_plain(
    qp: torch.Tensor, probe: torch.Tensor, slabs: torch.Tensor, slab_sq: torch.Tensor,
    slab_ids: torch.Tensor, mask: Optional[torch.Tensor], rr: int,
):
    """Plain PyTorch version: gather the probed slabs probe chunk by probe
    chunk (as the JAX program's ``lax.scan``), score in f32, and carry the
    top ``rr`` across chunks."""
    _check_operands(qp, probe, slabs, slab_sq, slab_ids, mask, rr)
    B, p = probe.shape
    C, S, r = slabs.shape
    pc = max(1, min(p, PLAIN_CHUNK_BYTES // max(B * S * r * 4, 1)))
    best_d = torch.full((B, 0), float("inf"), dtype=torch.float32, device=qp.device)
    best_i = torch.full((B, 0), NIL, dtype=torch.int32, device=qp.device)
    for j0 in range(0, p, pc):
        pr = probe[:, j0 : j0 + pc].long()
        in_range = (pr >= 0) & (pr < C)
        prc = pr.clamp(0, C - 1)
        ids = slab_ids[prc]  # [B, pc, S]
        cross = torch.einsum("bpsr,br->bps", slabs[prc].float(), qp)
        d = slab_sq[prc] - 2.0 * cross
        ok = (ids != NIL) & in_range[..., None]
        if mask is not None:
            n = mask.shape[0]
            ok &= (ids >= 0) & (ids < n) & mask[ids.clamp(0, max(n - 1, 0)).long()].bool()
        d = torch.cat([best_d, d.masked_fill(~ok, float("inf")).reshape(B, -1)], dim=1)
        ids = torch.cat([best_i, ids.masked_fill(~ok, NIL).reshape(B, -1)], dim=1)
        kk = min(rr, d.shape[1])
        best_d, pos = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        best_i = torch.gather(ids, 1, pos)
    best_i = best_i.masked_fill(~torch.isfinite(best_d), NIL)
    if best_d.shape[1] < rr:
        pad = rr - best_d.shape[1]
        best_d = torch.cat([best_d, best_d.new_full((B, pad), float("inf"))], dim=1)
        best_i = torch.cat([best_i, best_i.new_full((B, pad), NIL)], dim=1)
    return best_d, best_i


def batch_chunk(b: int, p: int, s: int) -> int:
    """Queries a chunk: as many as keep the scratch of ``b * p * s`` f32
    scores under ``SCRATCH_BYTES`` (at least 1)."""
    return max(1, min(b, SCRATCH_BYTES // max(p * s * 4, 1)))


def random_operands(c: int, s: int, r: int, seed: int, device):
    """A slab set for checking the kernel at a shape, made on ``device`` from
    ``seed`` in blocks of 8,192 clusters: bf16[c, s, r] normal rows with 30%
    NIL slots (zero rows), the norms of the f32 rows, distinct ids from 2 on,
    and a u8 mask that admits about half the ids. Returns (the generator,
    slabs, slab_sq, slab_ids, mask); the generator goes on to draw queries."""
    gen = torch.Generator(device=device).manual_seed(seed)
    slabs = torch.empty((c, s, r), dtype=torch.bfloat16, device=device)
    slab_sq = torch.empty((c, s), dtype=torch.float32, device=device)
    ids = (torch.randperm(c * s, generator=gen, device=device).reshape(c, s) + 2).to(torch.int32)
    for c0 in range(0, c, 8192):
        rows = torch.randn((min(8192, c - c0), s, r), generator=gen, device=device)
        nil = torch.rand(rows.shape[:2], generator=gen, device=device) < 0.3
        rows[nil] = 0.0
        ids[c0 : c0 + rows.shape[0]][nil] = NIL
        slabs[c0 : c0 + rows.shape[0]] = rows.to(torch.bfloat16)
        slab_sq[c0 : c0 + rows.shape[0]] = (rows * rows).sum(-1)
    mask = (torch.rand(c * s + 2, generator=gen, device=device) < 0.5).to(torch.uint8)
    return gen, slabs, slab_sq, ids, mask


def ivf_probe_scan(
    qp: torch.Tensor, probe: torch.Tensor, slabs: torch.Tensor, slab_sq: torch.Tensor,
    slab_ids: torch.Tensor, mask: Optional[torch.Tensor], rr: int,
):
    """``qp`` f32[B, r], ``probe`` i32[B, p], ``slabs`` f32|bf16[C, S, r],
    ``slab_sq`` f32[C, S], ``slab_ids`` i32[C, S], ``mask`` u8[n] or None →
    (f32[B, rr], i32[B, rr]): the kernels for CUDA tensors, the plain version
    for CPU tensors."""
    tensors = (qp, probe, slabs, slab_sq, slab_ids) + ((mask,) if mask is not None else ())
    if all(t.device.type == "cpu" for t in tensors):
        return ivf_probe_scan_plain(qp, probe, slabs, slab_sq, slab_ids, mask, rr)
    _check_operands(qp, probe, slabs, slab_sq, slab_ids, mask, rr)
    dev = qp.device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"K3 operands must all lie on one CUDA device; got {[str(x.device) for x in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K3 operands must be contiguous")
    B, p = probe.shape
    C, S, r = slabs.shape
    out_d = torch.empty((B, rr), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, rr), dtype=torch.int32, device=dev)
    if B == 0:
        return out_d, out_i
    if p == 0:
        return out_d.fill_(float("inf")), out_i.fill_(NIL)
    lib = _library()
    global LAUNCHES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        bc = batch_chunk(B, p, S)
        work = torch.empty(lib.semadb_ivf_scan_work_ints(bc, p, C, r), dtype=torch.int32, device=dev)
        scratch = torch.empty(bc * p * S, dtype=torch.float32, device=dev)
        for b0 in range(0, B, bc):
            b1 = min(B, b0 + bc)
            rc = lib.semadb_ivf_probe_scan(
                qp[b0:b1].data_ptr(), probe[b0:b1].data_ptr(), slabs.data_ptr(), slab_sq.data_ptr(),
                slab_ids.data_ptr(), None if mask is None else mask.data_ptr(),
                0 if mask is None else mask.shape[0], b1 - b0, p, C, S, r,
                int(slabs.dtype == torch.bfloat16), rr, work.data_ptr(), scratch.data_ptr(),
                out_d[b0:b1].data_ptr(), out_i[b0:b1].data_ptr(), stream,
            )
            if rc != 0:
                msg = lib.semadb_ivf_error_string(rc).decode()
                raise RuntimeError(f"K3 launch failed ({rc}: {msg}) at B={b1 - b0} p={p} C={C} S={S} r={r} rr={rr}")
        with _LOCK:
            LAUNCHES += 1
    return out_d, out_i


def _check_operands(qp, probe, slabs, slab_sq, slab_ids, mask, rr) -> None:
    if slabs.dim() != 3:
        raise ValueError(f"slabs must be [C, S, r], got {tuple(slabs.shape)}")
    C, S, r = slabs.shape
    if slabs.dtype not in SLAB_DTYPES:
        raise TypeError(f"slabs must be one of {SLAB_DTYPES}, got {slabs.dtype}")
    if qp.dtype != torch.float32 or slab_sq.dtype != torch.float32:
        raise TypeError(f"qp and slab_sq must be float32, got {qp.dtype} and {slab_sq.dtype}")
    if probe.dtype != torch.int32 or slab_ids.dtype != torch.int32:
        raise TypeError(f"probe and slab_ids must be int32, got {probe.dtype} and {slab_ids.dtype}")
    if mask is not None and (mask.dtype != torch.uint8 or mask.dim() != 1):
        raise TypeError(f"mask must be 1-D uint8, got {mask.dtype} {tuple(mask.shape)}")
    if qp.dim() != 2 or probe.dim() != 2 or qp.shape != (probe.shape[0], r):
        raise ValueError(f"qp {tuple(qp.shape)} and probe {tuple(probe.shape)} do not fit slabs {tuple(slabs.shape)}")
    if slab_sq.shape != (C, S) or slab_ids.shape != (C, S):
        raise ValueError(f"slab_sq {tuple(slab_sq.shape)} and slab_ids {tuple(slab_ids.shape)} must be [{C}, {S}]")
    if not 1 <= rr <= MAX_RR or not 1 <= r <= MAX_R:
        raise ValueError(f"rr must lie in [1, {MAX_RR}] and r in [1, {MAX_R}], got rr={rr} r={r}")


def _library():
    """Build (once per source hash) and load the kernel library."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path, BUILD_LOG = build_library("ivf_scan", SOURCE, nvcc(), NVCC_FLAGS, HEADERS)
        lib = ctypes.CDLL(path)
        lib.semadb_ivf_probe_scan.restype = ctypes.c_int
        lib.semadb_ivf_probe_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.semadb_ivf_scan_work_ints.restype = ctypes.c_longlong
        lib.semadb_ivf_scan_work_ints.argtypes = [ctypes.c_int] * 4
        lib.semadb_ivf_error_string.restype = ctypes.c_char_p
        lib.semadb_ivf_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
        return lib
