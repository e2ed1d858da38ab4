"""Card tests of the benchmark's comparison: the control (the reference one
precision below the configurations', TF32 in place of float32) must come out
not correct in every cell, and the program correct, on three seeds at
100,000 points of the cells' own width.

    python -m pytest portbench/tests/test_card.py -q

They skip where there is no CUDA device. At the cells' own size the same
runs are ``python3 -m portbench.readings``.
"""

from __future__ import annotations

import pytest
import torch

from portbench import harness, readings

SPEC = harness.load_spec()
CELLS = [c["name"] for c in SPEC["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
SIZE = {"config": {"n_points": 100_000}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_holds(card, cell):
    for seed in SEEDS:
        assert readings.one(cell, seed, 2.0, "control", "cuda", SIZE)["correct"] is False
    assert readings.one(cell, SEEDS[0], 2.0, "program", "cuda", SIZE)["correct"] is True
