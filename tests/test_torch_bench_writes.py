"""The port's ``bench`` write modes against the JAX package's root
``bench.py`` (run unchanged in a subprocess on the CPU), at 4,000 x 32 with
four write transactions of 100 points.

- ``shardwrite``: the same metric and keys, the same number of journaled
  transactions replayed by the crash reopen (with and without incremental
  flushes in the loop), probe parity >= 0.95 in both packages, every point
  the port acknowledged found at distance 0 under its own node id after the
  reopen, and the port's warmup ids inside the index's initial capacity (the
  JAX warmup writes the run's last rows).
- ``write``: the same metric and keys, recall@10 after the writes within
  0.01 of the JAX run's.
"""

import pytest
import torch

from jax_bench_run import WRITE_SIZES, port_settings, run_jax_mode
from semadb_tpu_torch import bench

CPU = torch.device("cpu")


def _same_shape(jax_out: dict, port_out: dict) -> None:
    assert port_out["metric"] == jax_out["metric"]
    assert set(jax_out) <= set(port_out), sorted(set(jax_out) - set(port_out))


@pytest.mark.parametrize("flush_every", [0, 2])
def test_shardwrite_matches_the_jax_mode(flush_every):
    env = {**WRITE_SIZES, "BENCH_FLUSH_EVERY": str(flush_every)}
    want = run_jax_mode("shardwrite", env)
    got = bench.run_mode(port_settings("shardwrite", **env), CPU)
    _same_shape(want, got)
    assert got["journal_txns_replayed"] == want["journal_txns_replayed"]
    assert got["incremental_flushes"] == want["incremental_flushes"]
    assert want["reopen_probe_parity"] >= 0.95 and got["reopen_probe_parity"] >= 0.95
    assert got["acknowledged"] == got["warmup_node_ids"][1] - got["warmup_node_ids"][0] + 1 + 4 * 100
    assert got["acknowledged_found"] == got["acknowledged"]
    assert got["warmup_node_ids"][0] == 4002 and got["warmup_node_ids"][1] < got["initial_capacity"]


def test_shardwrite_without_warmup_times_every_txn():
    got = bench.run_mode(port_settings("shardwrite", **WRITE_SIZES, BENCH_WRITE_WARMUP_TXNS="0"), CPU)
    assert got["warmup_txn_s"] == [] and got["warmup_node_ids"] == []
    assert got["acknowledged"] == got["acknowledged_found"] == 400
    assert got["journal_txns_replayed"] == 4


def test_write_matches_the_jax_mode():
    want = run_jax_mode("write", WRITE_SIZES)
    got = bench.run_mode(port_settings("write", **WRITE_SIZES), CPU)
    _same_shape(want, got)
    assert got["write_txns"] == 4 and got["txn_points"] == 100
    assert abs(got["recall@10_after_writes"] - want["recall@10_after_writes"]) <= 0.01
