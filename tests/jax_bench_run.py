"""Runs one mode of the JAX package's root ``bench.py``, unchanged, in a
subprocess on the CPU, for the tests that hold the port's ``bench`` against it.

The sizes are the tests' (``SIZES``); ``prelude`` is Python run before the
mode (patches that record what the mode does), ``epilogue`` after it.
Returns the mode's JSON line as a dict.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"BENCH_N": "4000", "BENCH_DIM": "32", "BENCH_QUERIES": "256", "BENCH_QUERY_BATCH": "128"}
WRITE_SIZES = {"BENCH_WRITE_TXNS": "4", "BENCH_WRITE_TXN_POINTS": "100"}


def run_jax_mode(mode: str, env: dict = None, prelude: str = "", epilogue: str = "") -> dict:
    code = "\n".join([
        "import os",
        "os.environ['JAX_PLATFORMS'] = 'cpu'",
        prelude,
        "import bench, jax",
        f"bench._run_{mode}(jax)",
        epilogue,
    ])
    full = {**os.environ, "JAX_PLATFORMS": "cpu", **SIZES, **(env or {})}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def port_settings(mode: str, **extra) -> dict:
    """The port's ``bench.settings`` at the tests' sizes."""
    from semadb_tpu_torch import bench

    return bench.settings({"BENCH_MODE": mode, **SIZES, **extra})
