"""Microbenchmark: the row gather K2 against ``torch.index_select``.

Port of ``semadb_tpu/tools/gatherbench.py``. It measures the Vamana hop's
dominant primitive — a random row gather from a device-resident [cap, D]
f32 matrix — at hop-shaped sizes, with the same flags, defaults and data
(``numpy.random.default_rng(0)``). Three calls compute ``vectors[ids]``:

- ``kernel``: ``ops.kernels.gather.gather_rows_padded`` (K2, the CUDA kernel
  on a CUDA device);
- ``torch``: ``torch.index_select(vectors, 0, ids)``, the one library call
  that computes the same function (the JAX tool's ``xla_take``);
- ``plain``: K2's plain PyTorch version (range check, then ``index_select``
  on int64 ids).

Each is timed as the median of ``REPS`` calls after a warm-up: CUDA events
around each call on a GPU, the host clock on the CPU. The whole kernel
output, taken through the checked path, must equal the library call's bit
for bit. ``*_gbps`` divides the output's bytes by the time, as the JAX tool
does; ``bound_bytes`` counts what the gather must move at least — the ids,
each distinct row once, the output once.

Usage:  python -m semadb_tpu_torch.tools.gatherbench [--cap 1000000] [--dim 128]
        [--rows 1048576] [--device cuda]

``--device cuda`` (the default) is an error without a CUDA device. Prints one
JSON line; exits 1 when the kernel's output is wrong.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from semadb_tpu_torch.ops.kernels import gather

REPS = 21
WARMUP = 3


def _median_s(fn, device: torch.device) -> float:
    """Seconds per call: the median of REPS calls after WARMUP."""
    for _ in range(WARMUP):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench(cap: int, dim: int, rows: int, device: torch.device) -> dict:
    rng = np.random.default_rng(0)
    vectors = torch.from_numpy(rng.standard_normal((cap, dim)).astype(np.float32)).to(device)
    ids = torch.from_numpy(rng.integers(0, cap, rows).astype(np.int32)).to(device)
    row_bytes = dim * 4
    out_bytes = rows * row_bytes
    unique = int(torch.unique(ids).numel())

    t_kernel = _median_s(lambda: gather.gather_rows_padded(vectors, ids), device)
    t_torch = _median_s(lambda: torch.index_select(vectors, 0, ids), device)
    t_plain = _median_s(lambda: gather.gather_rows_plain(vectors, ids), device)

    got = gather.gather_rows_padded(vectors, ids, check=True)
    ok = bool(torch.equal(got, torch.index_select(vectors, 0, ids)))
    return {
        "rows": rows,
        "row_bytes": row_bytes,
        "torch_s": t_torch,
        "torch_gbps": out_bytes / t_torch / 1e9,
        "kernel_s": t_kernel,
        "kernel_gbps": out_bytes / t_kernel / 1e9,
        "kernel_correct": ok,
        "plain_s": t_plain,
        "plain_gbps": out_bytes / t_plain / 1e9,
        "unique_rows": unique,
        "bound_bytes": rows * 4 + unique * row_bytes + out_bytes,
        "platform": device.type,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cap", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--rows", type=int, default=8192 * 128)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; an error without CUDA)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but no CUDA device is available")
    result = bench(args.cap, args.dim, args.rows, device)
    print(json.dumps(result), flush=True)
    return 0 if result["kernel_correct"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
