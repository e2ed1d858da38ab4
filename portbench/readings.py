"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 -m portbench.readings --workload <cell> --seeds 11,12 --control-seeds 21,22,23 --seconds 10

runs, in one process on the card, the cell with the program on each of
``--seeds`` and with the control (``control.TF32Exact`` in the program's
place) on each of ``--control-seeds``, and prints one JSON line a run: the
numbers the comparison computed, whether they held, and the end-to-end
metrics. ``--faults`` adds runs of the program with each planted fault, and
``--paths`` runs of the program with each of its own paths below float32
switched on. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from portbench import control, harness

FAULTS = {"half_left_out": control.HalfLeftOut, "altered": control.Altered}
PATHS = {"tf32_matmuls": control.tf32_matmuls, "bf16_slabs": control.bf16_slabs}


def one(name: str, seed: int, seconds: float, kind: str, device="cuda", overrides=None, spec=None) -> dict:
    make = None
    if kind == "control":
        # the control answers some 30 times fewer requests than the program, so it keeps every answer
        make = control.TF32Exact
        overrides = dict(overrides or {})
        overrides["traffic"] = {**overrides.get("traffic", {}), "judged_share": 1.0}
    elif kind in FAULTS:
        entry = harness.entry(harness.plan(spec or harness.load_spec(), name)["config"])
        make = lambda schema, dev: FAULTS[kind](entry.make(schema, dev))  # noqa: E731
    with PATHS.get(kind, contextlib.nullcontext)():
        out = harness.run_cell(name, seed, seconds, False, device, spec=spec, overrides=overrides, make_engine=make)
    return {"kind": kind, "seed": seed, "correct": out["correct"], "checks": out["checks"], "metrics": out["metrics"],
            "attempted": out["attempted"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings of the compared numbers")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="seeds for the planted faults")
    ap.add_argument("--paths", default="", help="seeds for the program's paths below float32")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    runs = [("program", s) for s in seeds(args.seeds)] + [("control", s) for s in seeds(args.control_seeds)]
    runs += [(f, s) for s in seeds(args.faults) for f in FAULTS]
    runs += [(p, s) for s in seeds(args.paths) for p in PATHS]
    for kind, seed in runs:
        print(json.dumps({"workload": args.workload, **one(args.workload, seed, args.seconds, kind)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
