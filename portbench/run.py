"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``. The run needs as many CUDA devices as the cell asks for;
without them it exits with 2 and prints no result. Progress, the set-up
split and every compared number beside its limit go to standard error (the
numbers last); the result is the last line of standard output.
"""

from __future__ import annotations

import time

T_TOP = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Top-level modules the run may not hold once its window has closed: JAX,
# its kin, the JAX package and the root bench script
FORBIDDEN = ("jax", "jaxlib", "flax", "semadb_tpu", "bench")


def process_age() -> float:
    """Seconds since this process started, by the kernel's clock (0 where
    /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    t_origin = T_TOP - process_age()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    spec = harness.load_spec()
    cell = harness.plan(spec, args.workload)["cell"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_origin, spec)
    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: the run loaded {leaked}; it may load none of {list(FORBIDDEN)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} {c['must_be']} {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
