"""K2, the row gather: the port's plain version held against the JAX kernel.

The JAX ``gather_rows_padded`` runs its Pallas body in interpret mode on the
CPU (``pallas_call`` patched in this test only), on the same seeded numpy
inputs as the port's ``gather_rows`` / ``gather_rows_padded`` on ``cpu``.
Tolerance: exact equality — a gather copies bits. The port's gatherbench
runs on ``cpu`` at a small size and must report a correct kernel.
"""

import functools
import json
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import semadb_tpu.ops.pallas.gather as pallas_gather
from semadb_tpu_torch.ops.kernels import gather
from semadb_tpu_torch.tools import gatherbench

CAP = 5000


def _inputs(dim, n, seed):
    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((CAP, dim)).astype(np.float32)
    ids = rng.integers(0, CAP, n).astype(np.int32)
    ids[0] = 0
    if n > 1:
        ids[-1] = CAP - 1
    if n > 2:
        ids[n // 2] = ids[-1]  # a repeat
    return vectors, ids


def _jax_gather(vectors, ids):
    interpret = functools.partial(pl.pallas_call, interpret=True)
    with mock.patch.object(pallas_gather.pl, "pallas_call", interpret):
        return np.asarray(pallas_gather.gather_rows_padded(jnp.asarray(vectors), jnp.asarray(ids)))


@pytest.mark.parametrize("n", [1, 1023, 1024, 1500])
@pytest.mark.parametrize("dim", [1, 3, 128])
def test_gather_matches_jax_interpret(dim, n):
    vectors, ids = _inputs(dim, n, seed=dim * 10_000 + n)
    want = _jax_gather(vectors, ids)
    np.testing.assert_array_equal(want, vectors[ids])
    tv, ti = torch.from_numpy(vectors), torch.from_numpy(ids)
    got = gather.gather_rows_padded(tv, ti)
    assert got.dtype == torch.float32 and got.shape == (n, dim)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gather.gather_rows_padded(tv, ti, check=True).numpy(), want)
    if n % gather.TILE == 0:
        np.testing.assert_array_equal(gather.gather_rows(tv, ti).numpy(), want)
    else:
        with pytest.raises(ValueError, match="multiple of 1024"):
            gather.gather_rows(tv, ti)


def test_gather_refuses_bad_ids_and_operands():
    vectors = torch.zeros((10, 4))
    for bad in (10, -1):
        ids = torch.tensor([0, bad, 3], dtype=torch.int32)
        with pytest.raises(IndexError, match=r"outside \[0, 10\)"):
            gather.gather_rows_padded(vectors, ids)
        with pytest.raises(IndexError):
            gather.gather_rows_plain(vectors, ids)
    ids = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        gather.gather_rows_padded(vectors, ids.long())
    with pytest.raises(TypeError, match="float32"):
        gather.gather_rows_padded(vectors.double(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows_padded(torch.zeros((4, 10)).T, ids)
    assert gather.gather_rows_padded(vectors, ids[:0]).shape == (0, 4)


def test_gatherbench_on_cpu(capsys):
    before = gather.LAUNCHES
    assert gatherbench.main(["--cap", "4096", "--dim", "8", "--rows", "3000", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(line)
    assert res["kernel_correct"] is True and res["platform"] == "cpu"
    assert res["rows"] == 3000 and res["row_bytes"] == 32
    for key in ("torch_s", "kernel_s", "plain_s", "torch_gbps", "kernel_gbps", "plain_gbps"):
        assert res[key] > 0, key
    rng = np.random.default_rng(0)  # the tool's data: vectors first, then ids
    rng.standard_normal((4096, 8))
    unique = len(np.unique(rng.integers(0, 4096, 3000)))
    assert res["unique_rows"] == unique
    assert res["bound_bytes"] == 3000 * 4 + unique * 32 + 3000 * 32
    assert gather.LAUNCHES == before  # the plain version on the CPU launches nothing


def test_gatherbench_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        gatherbench.main(["--cap", "16", "--dim", "2", "--rows", "8"])
    assert exc.value.code == 2
