"""Card test of the angular cell's comparison: its control
(``control_angular.TF32Angular``, exact search by 1 - q·x with the product in
TF32, one precision below the configuration's float32) must come out not
correct, and the program correct, on three seeds at 100,000 points of the
cell's own width.

    python -m pytest portbench/tests/test_card_angular.py -q

It skips where there is no CUDA device. At the cell's own size the same runs
are ``python3 -m portbench.control_angular`` and ``python3 -m
portbench.readings``.
"""

from __future__ import annotations

import pytest
import torch

from portbench import control_angular, readings

CELL = "mix1m-1536-ivf.batch4096-angular"
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
SIZE = {"config": {"n_points": 100_000}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_angular_control_fails_and_program_holds(card):
    for seed in SEEDS:
        got = control_angular.one(CELL, seed, 2.0, "cuda", SIZE)
        assert got["correct"] is False
        assert got["checks"]["dist_err_max"]["value"] > got["checks"]["dist_err_max"]["limit"]
    assert readings.one(CELL, SEEDS[0], 2.0, "program", "cuda", SIZE)["correct"] is True
