"""The control of the angular cells: the plain reference put in the
program's place one precision below what the configurations state.

``TF32Angular`` is exact search by 1 - q·x with the product in TF32 (the
configurations state returned distances in float32 with TF32 off), with the
engines' interface; on the CPU there is no TF32 and it answers exactly.
``control.TF32Exact`` returns squared euclidean distances, 2 (1 - q·x) on
unit rows, and would fail an angular cell for that alone.

    python3 -m portbench.control_angular --workload <cell> --seeds 21,22,23 --seconds 10

runs the control on each seed on the card, every answer judged, and prints
one JSON line a run, as ``python3 -m portbench.readings`` does for the
program and the planted faults (which serve an angular cell as they are).
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import control, harness


class TF32Angular(control.TF32Exact):
    """A brute-force store with the engines' interface, by 1 - q·x."""

    def search_batch_async(self, queries, k: int):
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        keep = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            best_d = torch.full((len(q), k), float("inf"), device=self.device)
            best_i = torch.full((len(q), k), -1, dtype=torch.int64, device=self.device)
            for r in range(0, len(self.live), control.ROW_CHUNK):
                d = 1.0 - q @ self.vectors[r : r + control.ROW_CHUNK].T
                d.masked_fill_(~self.live[r : r + control.ROW_CHUNK][None, :], float("inf"))
                v, i = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
                v, pos = torch.topk(torch.cat([best_d, v], 1), k, dim=1, largest=False)
                best_i = torch.gather(torch.cat([best_i, i + r], 1), 1, pos)
                best_d = v
        finally:
            torch.backends.cuda.matmul.allow_tf32 = keep
        return best_d, best_i.masked_fill(~torch.isfinite(best_d), -1).to(torch.int32)


def one(name: str, seed: int, seconds: float, device="cuda", overrides=None, spec=None) -> dict:
    """One run of cell ``name`` with the control in the program's place.
    The control answers far fewer requests than the program, so it keeps
    every answer (``judged_share`` 1.0)."""
    overrides = dict(overrides or {})
    overrides["traffic"] = {**overrides.get("traffic", {}), "judged_share": 1.0}
    out = harness.run_cell(name, seed, seconds, False, device, spec=spec, overrides=overrides,
                           make_engine=TF32Angular)
    return {"kind": "control", "seed": seed, "correct": out["correct"], "checks": out["checks"],
            "metrics": out["metrics"], "attempted": out["attempted"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings of the angular control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        print(json.dumps({"workload": args.workload, **one(args.workload, seed, args.seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
