"""K5's plain version, its route and its plan, on the CPU.

K5 (``ops/kernels/ivf_probe_topk.py``) replaces the port's probe selection
chain, whose arithmetic its plain version keeps: the plain version is held
to that chain (a copy of the function it replaced, below) exactly, and to the
JAX package's ``_select_probes`` by the tie rule, on the K3 tests' shapes and
the two-level tests' chunked one. The kernels run on the card only
(``tests/test_torch_cuda.py``); here the route by p, the plan that splits the
work, and the names the benchmark files the kernels under.

Tolerance: scores within 1e-5 of (|q| + max |c|)^2, the K3 and K4 tests'
(the sums run in another order); ids by the tie rule at that tolerance.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portbench import stages
from semadb_tpu.index import ivf as jax_ivf
from semadb_tpu_torch.index import ivf as port_ivf
from semadb_tpu_torch.ops.kernels import ivf_probe_topk as k5
from semadb_tpu_torch.ops.topk import tie_rule_errors

RTOL = 1e-5
SMS = 132  # the H100's SMs


def _torch_chain(qp, centroids, cent_sq, p, chunk_bytes=2**30, chunk_c=16384):
    """The port's probe selection before K5 (``index/ivf.py`` ``_select_probes``)."""
    B, Cn = qp.shape[0], centroids.shape[0]
    p = min(p, Cn)
    if B * Cn * 4 <= chunk_bytes:
        cd = cent_sq[None, :] - 2.0 * (qp @ centroids.T)
        return torch.topk(cd, p, dim=1, largest=False, sorted=True).indices.to(torch.int32)
    cb = min(chunk_c, Cn)
    dists, ids = [], []
    for c0 in range(0, Cn, cb):
        dd = cent_sq[None, c0 : c0 + cb] - 2.0 * (qp @ centroids[c0 : c0 + cb].T)
        v, i = torch.topk(dd, min(p, dd.shape[1]), dim=1, largest=False)
        dists.append(v)
        ids.append(i + c0)
    d, i = torch.cat(dists, dim=1), torch.cat(ids, dim=1)
    sel = torch.topk(d, p, dim=1, largest=False, sorted=True).indices
    return torch.gather(i, 1, sel).to(torch.int32)


def _operands(b, c, d, metric, seed):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((c, d)).astype(np.float32)
    queries = (cents[rng.integers(0, c, b)] + 0.3 * rng.standard_normal((b, d))).astype(np.float32)
    cent_sq = (cents * cents).sum(-1) if metric == "euclidean" else np.zeros(c, np.float32)
    return queries, cents, cent_sq.astype(np.float32)


def _assert_tie_rule(queries, cents, cent_sq, want, got):
    """Each row of ``got`` against ``want`` by the tie rule over the float64 scores."""
    score = cent_sq.astype(np.float64)[None, :] - 2.0 * queries.astype(np.float64) @ cents.astype(np.float64).T
    atol = RTOL * (np.linalg.norm(queries, axis=1) + np.linalg.norm(cents, axis=1).max()) ** 2
    for b in range(len(want)):
        errs = tie_rule_errors(score[b, want[b]], list(want[b]), score[b, got[b]], list(got[b]),
                               lambda i, b=b: score[b, i], atol=float(atol[b]))
        assert errs == [], (b, errs[:3])


# (B, C, D, p, metric, chunked): the K3 tests' (B, C, D, p), D = 194 (the
# fused index's rows), p = C, and the two-level tests' chunked selection
# (PROBE_CHUNK_BYTES 1, PROBE_CHUNK_C 32)
PLAIN_CASES = [
    (5, 16, 3, 3, "euclidean", False), (9, 24, 16, 4, "dot", False), (17, 32, 20, 8, "euclidean", False),
    (3, 20, 16, 5, "dot", False), (33, 8, 8, 3, "euclidean", False), (40, 24, 16, 6, "euclidean", False),
    (12, 12, 8, 6, "dot", False), (6, 70, 194, 24, "euclidean", False), (4, 40, 100, 40, "dot", False),
    (32, 128, 16, 24, "euclidean", True), (7, 100, 16, 50, "dot", True), (5, 90, 12, 90, "euclidean", True),
]


@pytest.mark.parametrize("b,c,d,p,metric,chunked", PLAIN_CASES)
def test_plain_matches_the_torch_chain_and_jax(b, c, d, p, metric, chunked, monkeypatch):
    queries, cents, cent_sq = _operands(b, c, d, metric, seed=b * 1000 + c + d)
    chunk = {}
    if chunked:
        chunk = {"chunk_bytes": 1, "chunk_c": 32}
        for mod in (jax_ivf, k5):
            monkeypatch.setattr(mod, "PROBE_CHUNK_BYTES", 1)
            monkeypatch.setattr(mod, "PROBE_CHUNK_C", 32)
    qt, ct, st = torch.from_numpy(queries), torch.from_numpy(cents), torch.from_numpy(cent_sq)
    got = k5.ivf_probe_topk_plain(qt, ct, st, p)
    assert got.dtype == torch.int32 and got.shape == (b, min(p, c))
    assert torch.equal(got, _torch_chain(qt, ct, st, p, **chunk))
    assert torch.equal(k5.ivf_probe_topk(qt, ct, st, p), got)  # CPU tensors take the plain version
    assert torch.equal(port_ivf._select_probes(qt, ct, st, p), got)
    want = np.asarray(jax_ivf._select_probes(jnp.asarray(queries), jnp.asarray(cents), jnp.asarray(cent_sq), p))
    _assert_tie_rule(queries, cents, cent_sq, want, got.numpy())


def test_select_probes_routes_by_p_at_the_cap(monkeypatch):
    """p up to MAX_P (after p is cut to C) goes to K5, p past it to the
    library route; nothing else picks the route."""
    calls = []
    for name in ("ivf_probe_topk", "ivf_probe_topk_library"):
        real = getattr(k5, name)
        monkeypatch.setattr(k5, name, lambda *a, _n=name, _f=real: calls.append((_n, a[3])) or _f(*a))
    queries, cents, cent_sq = _operands(3, k5.MAX_P + 40, 8, "euclidean", seed=1)
    ops = (torch.from_numpy(queries), torch.from_numpy(cents), torch.from_numpy(cent_sq))
    for p in (1, 24, k5.MAX_P, k5.MAX_P + 1, k5.MAX_P + 40, 10**6):
        port_ivf._select_probes(*ops, p)
    assert calls == [("ivf_probe_topk", 1), ("ivf_probe_topk", 24), ("ivf_probe_topk", k5.MAX_P),
                     ("ivf_probe_topk_library", k5.MAX_P + 1), ("ivf_probe_topk_library", k5.MAX_P + 40),
                     ("ivf_probe_topk_library", k5.MAX_P + 40)]
    calls.clear()
    port_ivf._select_probes(ops[0], ops[1][:100], ops[2][:100], k5.MAX_P + 1)  # p cut to C = 100 first
    assert calls == [("ivf_probe_topk", 100)]


def test_library_route_is_the_plain_version_and_counts_only_on_a_card():
    queries, cents, cent_sq = _operands(4, 300, 12, "dot", seed=2)
    ops = (torch.from_numpy(queries), torch.from_numpy(cents), torch.from_numpy(cent_sq))
    before = dict(k5.LAUNCHES_BY)
    got = k5.ivf_probe_topk_library(*ops, 280)
    assert torch.equal(got, k5.ivf_probe_topk_plain(*ops, 280))
    assert dict(k5.LAUNCHES_BY) == before


@pytest.mark.parametrize("b", [1, 7, 33, 64, 65, 1000, 4096, 20000])
@pytest.mark.parametrize("c", [1, 64, 129, 1000, 32768, 131072])
@pytest.mark.parametrize("p", [1, 24, 96, 256])
def test_plan_covers_every_cluster_within_the_kernel_limits(b, c, p):
    p = min(p, c)
    bm, slices, slice_tiles = k5.plan(b, c, p, SMS)
    assert bm in k5.TILE_BS and k5.tile_smem_bytes(bm, p) <= k5.SMEM_BLOCK and slices <= k5.MAX_SLICES
    assert (slices - 1) * slice_tiles * k5.TILE_C < c <= slices * slice_tiles * k5.TILE_C  # no slice empty
    assert bm == k5.TILE_BS[-1] or bm >= b or k5.tile_smem_bytes(2 * bm, p) > k5.SMEM_BLOCK
    assert -(-b // bm) * slices <= max(SMS, -(-b // bm))  # one wave while the query tiles allow


def test_plan_at_the_cells_shapes():
    """The bench cell: 4 slices of 8,192 clusters x 32 query tiles (128 of
    the 132 SMs); B = 1: one tile of 64 queries over 64 slices of 512
    clusters; the 10M cell's C: 4 slices of 32,768; the broad filter's p =
    96 and p = 256 on tiles of 64 queries, where every p up to MAX_P fits."""
    assert k5.plan(4096, 32768, 24, SMS) == (128, 4, 64)
    assert k5.plan(1, 32768, 24, SMS) == (64, 64, 4)
    assert k5.plan(4096, 131072, 24, SMS) == (128, 4, 256)
    assert k5.plan(4096, 32768, 96, SMS) == (64, 2, 128)
    assert k5.plan(4096, 32768, 256, SMS) == (64, 2, 128)
    assert k5.plan(1, 32768, 256, SMS) == (64, 64, 4)
    assert k5.tile_smem_bytes(128, 24) == 172032 and k5.tile_smem_bytes(128, 96) > k5.SMEM_BLOCK
    assert k5.tile_smem_bytes(k5.TILE_BS[0], k5.MAX_P) <= k5.SMEM_BLOCK


def test_wrapper_edges_on_cpu():
    queries, cents, cent_sq = _operands(3, 10, 4, "euclidean", seed=3)
    ops = (torch.from_numpy(queries), torch.from_numpy(cents), torch.from_numpy(cent_sq))
    assert k5.ivf_probe_topk(*ops, 0).shape == (3, 0)
    assert k5.ivf_probe_topk(ops[0][:0], ops[1], ops[2], 4).shape == (0, 4)
    assert port_ivf._select_probes(*ops, 50).shape == (3, 10)


def test_kernel_names_fall_under_probe_selection():
    """Every device kernel of K5 goes to a probe-selection stage of the
    benchmark's trace (``portbench.stages``), under the names the profiler
    gives it (demangled, and the ledger's form); none is a memset, and the
    source launches no kernel that ``KERNELS`` does not name."""
    for name in k5.KERNELS:
        forms = (name, f"void (anonymous namespace)::{name}<128, true>(float const*, float const*, float const*, "
                       f"int, int, int, int, int, unsigned long long*)",
                 f"void__anonymous_namespace_::{name}_128__true__float_const__")
        for form in forms:
            assert stages.stage_of(form) in stages.PROBE_SELECTION, form
            assert "Memset" not in form
    with open(k5.SOURCE) as f:
        src = f.read()
    assert set(re.findall(r"\b(ivf_probe_topk_\w+)\s*(?:<<<|<[^>]*><<<)", src)) == set(k5.KERNELS)
    assert "cudaMemset" not in src
