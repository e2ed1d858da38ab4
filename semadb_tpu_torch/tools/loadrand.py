"""HTTP load generator: random points against a running server.

Parity reference: internal/loadrand (HTTP stress loader).

Usage: python -m semadb_tpu.tools.loadrand --base http://localhost:8081 \
         --collection loadtest --dim 128 --count 10000
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import requests


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default="http://localhost:8081")
    ap.add_argument("--collection", default="loadtest")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--count", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=1000)
    ap.add_argument("--user", default="loadrand")
    ap.add_argument("--plan", default="BASIC")
    args = ap.parse_args(argv)

    headers = {"X-User-Id": args.user, "X-Plan-Id": args.plan}
    rng = np.random.default_rng(0)

    r = requests.post(
        f"{args.base}/v2/collections",
        json={
            "id": args.collection,
            "indexSchema": {
                "vector": {
                    "type": "vectorVamana",
                    "vectorVamana": {
                        "vectorSize": args.dim,
                        "distanceMetric": "euclidean",
                    },
                }
            },
        },
        headers=headers,
    )
    print("create:", r.status_code, r.text[:100])

    t0 = time.time()
    sent = 0
    while sent < args.count:
        n = min(args.batch, args.count - sent)
        pts = [{"vector": rng.random(args.dim).tolist()} for _ in range(n)]
        r = requests.post(
            f"{args.base}/v2/collections/{args.collection}/points",
            json={"points": pts},
            headers=headers,
        )
        r.raise_for_status()
        sent += n
        print(f"\rinserted {sent}/{args.count} ({sent/(time.time()-t0):.0f}/s)", end="")
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
