"""K3's and K4's plain versions held against the JAX programs they replace.

Both JAX pieces live inside ``semadb_tpu.index.ivf._ivf_query`` (no Pallas:
nothing is patched), so it is called on the same arrays:

- K3 (``ivf_probe_scan_plain``): the slabs hold the corpus rows themselves,
  so the exact rerank orders the coarse pool as the coarse score does
  (squared euclidean = coarse + |q|^2). With k = rr / 2 (the JAX pool is
  rr = 2k) the JAX query returns the k best of its pool, which must be the
  first k of K3's top-rr, plus |q|^2. The probes are the JAX package's own
  (``_select_probes``). bf16 slabs hold rows that bf16 represents exactly.
  Besides random probes: every query on the same probes (the load-imbalance
  case of the card's cluster-major route), ids stored in two clusters (the
  pool holds them twice, compared as multisets) and a probed cluster that is
  all NIL.
- K4 (``ivf_exact_rerank_plain``): one cluster of S = rr slots, probed by
  every query, so the JAX pool is exactly that slab's live ids; K4 reranks
  the same ids. Copies (an id two or three times in the slab) go through the
  JAX ``dedup_by_id`` and K4's own ``dedup``, which gets the raw pool; D =
  160 runs the JAX coarse pass in a projected space.

Tolerance: distances within 1e-5 of the summed terms' magnitude (the sums
run in another order); ids by the tie rule at that tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semadb_tpu.index import ivf as jax_ivf
from semadb_tpu_torch.ops.kernels import ivf_rerank, ivf_scan
from semadb_tpu_torch.ops.topk import pool_errors, tie_rule_errors

RTOL = 1e-5


def _agree(want_d, want_i, got_d, got_i, dist_of, atol):
    """The tie rule over each row's live places; the rest (inf, -1) on both sides."""
    for b in range(len(want_d)):
        live = np.isfinite(np.asarray(want_d[b]))
        assert (np.asarray(got_i[b])[~live] == -1).all() and np.isinf(np.asarray(got_d[b])[~live]).all(), b
        errs = tie_rule_errors(np.asarray(want_d[b])[live], list(np.asarray(want_i[b])[live]),
                               np.asarray(got_d[b])[live], list(np.asarray(got_i[b])[live]),
                               lambda i, b=b: dist_of(b, i), atol=float(atol[b]))
        assert errs == [], (b, errs[:3])


# (B, p, C, S, D, k, bf16, masked, layout): layout None (random probes),
# "same-probes" (every query on the same clusters), "copies" (ids stored in
# two clusters), "nil-cluster" (a probed cluster with no live slot)
K3_CASES = [
    (5, 3, 16, 40, 3, 32, False, False, None),
    (9, 4, 24, 64, 16, 32, False, True, None),
    (17, 8, 32, 64, 20, 64, True, False, None),
    (3, 5, 20, 48, 16, 40, True, True, None),
    (33, 3, 8, 100, 8, 128, False, False, None),
    (40, 6, 24, 64, 16, 32, False, False, "same-probes"),
    (24, 5, 16, 48, 12, 40, True, True, "same-probes"),
    (12, 6, 12, 40, 8, 32, False, False, "copies"),
    (10, 5, 16, 64, 16, 32, False, True, "copies"),
    (8, 4, 16, 40, 8, 32, False, False, "nil-cluster"),
    (6, 3, 12, 48, 20, 16, True, False, "nil-cluster"),
]


@pytest.mark.parametrize("b,p,c,s,d,k,bf16,masked,layout", K3_CASES)
def test_probe_scan_plain_matches_jax_pool(b, p, c, s, d, k, bf16, masked, layout):
    rng = np.random.default_rng(b * 100 + p)
    n = c * s
    rows = rng.standard_normal((n, d)).astype(np.float32)
    if bf16:  # rows bf16 holds exactly, so the f32 rerank orders like the coarse scores
        rows = torch.from_numpy(rows).to(torch.bfloat16).float().numpy()
    node = rng.permutation(n).astype(np.int32) + 2
    nil = rng.random(n) < 0.3
    slab_ids = np.where(nil, -1, node).reshape(c, s).astype(np.int32)
    slab_rows = np.where(nil[:, None], 0.0, rows).reshape(c, s, d).astype(np.float32)
    cap = n + 2
    vectors = np.zeros((cap, d), np.float32)
    vectors[node] = rows
    if layout == "copies":  # the first quarter of each cluster also fills the next cluster's last slots
        q4 = s // 4
        for cc in range(c):
            slab_ids[(cc + 1) % c, s - q4:] = slab_ids[cc, :q4]
            slab_rows[(cc + 1) % c, s - q4:] = slab_rows[cc, :q4]
    cents = slab_rows.mean(1) + 0.1 * rng.standard_normal((c, d)).astype(np.float32)
    cent_sq = (cents * cents).sum(-1)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    if layout == "same-probes":
        queries = queries[:1] + 1e-3 * queries
    if layout == "nil-cluster":  # every query's nearest cluster loses its slots
        near = np.argmin(cent_sq[None, :] - 2.0 * queries @ cents.T, axis=1)
        slab_ids[near] = -1
        slab_rows[near] = 0.0
    slab_sq = (slab_rows.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    mask = rng.random(cap) < 0.6 if masked else None
    slabs_j = jnp.asarray(slab_rows).astype(jnp.bfloat16) if bf16 else jnp.asarray(slab_rows)
    dj, ij = jax_ivf._ivf_query(
        jnp.asarray(cents), jnp.asarray(cent_sq), slabs_j, jnp.asarray(slab_sq), jnp.asarray(slab_ids),
        jnp.zeros((8, d), jnp.float32), jnp.zeros((8,), jnp.float32), jnp.full((8,), -1, jnp.int32),
        jnp.asarray(queries), jnp.asarray(vectors), None if mask is None else jnp.asarray(mask), None,
        p=p, k=k, pchunk=1,
    )
    probe = np.asarray(jax_ivf._select_probes(jnp.asarray(queries), jnp.asarray(cents), jnp.asarray(cent_sq), p))
    if layout == "same-probes":
        assert (probe == probe[:1]).all()
    if layout == "nil-cluster":
        assert (probe[:, 0] == near).all()
    slabs_t = torch.from_numpy(slab_rows)
    d3, i3 = ivf_scan.ivf_probe_scan(
        torch.from_numpy(queries), torch.from_numpy(probe.astype(np.int32)),
        slabs_t.to(torch.bfloat16) if bf16 else slabs_t, torch.from_numpy(slab_sq),
        torch.from_numpy(slab_ids), None if mask is None else torch.from_numpy(mask.astype(np.uint8)), 2 * k,
    )
    assert d3.shape == (b, 2 * k) and i3.dtype == torch.int32
    q2 = (queries.astype(np.float64) ** 2).sum(-1)
    got_d = d3[:, :k].double().numpy() + q2[:, None]
    got_i = i3[:, :k].numpy()
    got_d[got_i == -1] = np.inf

    def dist_of(bb, i):
        return np.inf if i == -1 else float(((vectors[i].astype(np.float64) - queries[bb]) ** 2).sum())

    xmax = float(np.linalg.norm(rows, axis=1).max())
    atol = RTOL * (xmax + np.linalg.norm(queries, axis=1)) ** 2
    if layout == "copies":  # both pools hold some ids twice
        assert any(len(set(row)) < len(row) for row in np.asarray(ij).tolist())
        for bb in range(b):
            errs = pool_errors(np.asarray(dj)[bb], np.asarray(ij)[bb].tolist(), got_d[bb], got_i[bb].tolist(),
                               lambda i, bb=bb: dist_of(bb, i), float(atol[bb]))
            assert errs == [], (bb, errs)
    else:
        _agree(np.asarray(dj), np.asarray(ij), got_d, got_i, dist_of, atol)
    # Unfilled places of the pool are (inf, -1); masked and NIL ids never appear
    assert ((i3 == -1) == torch.isinf(d3)).all()
    live = i3[i3 >= 0].numpy()
    assert not np.isin(live, slab_ids[slab_ids == -1]).any()
    if mask is not None:
        assert mask[live].all()


def test_probe_scan_plain_carries_the_top_across_probe_chunks(monkeypatch):
    """Probe chunks of the plain version merge into one exact top-rr."""
    rng = np.random.default_rng(5)
    qp = torch.from_numpy(rng.standard_normal((6, 12)).astype(np.float32))
    slabs = torch.from_numpy(rng.standard_normal((10, 16, 12)).astype(np.float32))
    sq = (slabs * slabs).sum(-1)
    ids = torch.arange(160, dtype=torch.int32).reshape(10, 16) + 2
    probe = torch.from_numpy(np.argsort(rng.random((6, 10)), axis=1)[:, :7].astype(np.int32))
    whole = ivf_scan.ivf_probe_scan_plain(qp, probe, slabs, sq, ids, None, 20)
    monkeypatch.setattr(ivf_scan, "PLAIN_CHUNK_BYTES", 1)
    chunked = ivf_scan.ivf_probe_scan_plain(qp, probe, slabs, sq, ids, None, 20)
    assert torch.equal(whole[1], chunked[1]) and torch.allclose(whole[0], chunked[0], atol=1e-5)
    assert torch.isinf(ivf_scan.ivf_probe_scan_plain(qp, probe[:, :1], slabs, sq, ids, None, 20)[0][:, 16:]).all()


# (B, D, k, metric, copies): copies > 1 stores two ids that many times each
K4_CASES = [
    (4, 3, 1, "euclidean", 1), (6, 16, 10, "dot", 1), (5, 16, 10, "cosine", 2),
    (7, 160, 32, "euclidean", 2), (3, 24, 64, "euclidean", 1), (4, 160, 10, "cosine", 1),
    (6, 16, 10, "euclidean", 3), (5, 16, 10, "dot", 2), (4, 24, 10, "dot", 3),
    (3, 16, 10, "cosine", 3), (6, 160, 10, "dot", 2),
]


@pytest.mark.parametrize("b,d,k,metric,copies", K4_CASES)
def test_exact_rerank_plain_matches_jax(b, d, k, metric, copies):
    rng = np.random.default_rng(b * 10 + d + k)
    proj_dim = jax_ivf.PROJ_DIM
    rr = max(jax_ivf.RERANK_POOL_PQ if d > proj_dim else jax_ivf.RERANK_POOL, 2 * k)
    cap = 3 * rr + 2
    vectors = rng.standard_normal((cap, d)).astype(np.float32)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    if metric == "cosine":
        vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    slab_ids = (rng.permutation(cap - 2)[:rr] + 2).astype(np.int32)
    slab_ids[rng.random(rr) < 0.2] = -1
    if copies > 1:  # two ids stored `copies` times each, the copies apart
        slab_ids[0 : 2 * copies : 2] = max(slab_ids[0], 2)
        slab_ids[1 : 2 * copies : 2] = max(slab_ids[1], 2)
    proj = None
    if d > proj_dim:
        proj = np.linalg.qr(rng.standard_normal((d, proj_dim)))[0].astype(np.float32)
    tv = vectors if proj is None else vectors @ proj
    slab = np.where((slab_ids == -1)[:, None], 0.0, tv[np.clip(slab_ids, 0, cap - 1)]).astype(np.float32)
    sq = (slab * slab).sum(-1) if metric == "euclidean" else np.zeros(rr, np.float32)
    cent = slab.mean(0, keepdims=True)
    dj, ij = jax_ivf._ivf_query(
        jnp.asarray(cent), jnp.zeros((1,), jnp.float32), jnp.asarray(slab[None]), jnp.asarray(sq[None]),
        jnp.asarray(slab_ids[None]), jnp.zeros((8, slab.shape[1]), jnp.float32), jnp.zeros((8,), jnp.float32),
        jnp.full((8,), -1, jnp.int32), jnp.asarray(queries), jnp.asarray(vectors), None,
        None if proj is None else jnp.asarray(proj), p=1, k=k, pchunk=1, metric=metric, dedup=copies > 1,
    )
    pool = torch.from_numpy(np.tile(slab_ids, (b, 1)))
    coarse = torch.where(pool >= 0, torch.zeros(()), torch.full((), float("inf")))
    d4, i4 = ivf_rerank.ivf_exact_rerank(torch.from_numpy(vectors), torch.from_numpy(queries), pool, coarse, k,
                                         metric, dedup=copies > 1)
    assert d4.shape == (b, k) and ((i4 == -1) == torch.isinf(d4)).all()
    if copies > 1:
        assert all(len(set(r[r >= 0].tolist())) == int((r >= 0).sum()) for r in i4)

    def dist_of(bb, i):
        if i == -1:
            return np.inf
        x, q = vectors[i].astype(np.float64), queries[bb].astype(np.float64)
        if metric == "euclidean":
            return float(((x - q) ** 2).sum())
        return 1.0 - float(x @ q) if metric == "cosine" else -float(x @ q)

    xmax = float(np.linalg.norm(vectors, axis=1).max())
    atol = RTOL * ((xmax + np.linalg.norm(queries, axis=1)) ** 2 + 1.0)
    _agree(np.asarray(dj), np.asarray(ij), d4.numpy(), i4.numpy(), dist_of, atol)


def test_probe_scan_chunk_planning(monkeypatch):
    """The B chunks that keep K3's f32[B, p, S] scratch under SCRATCH_BYTES
    (one chunk at the bench cell: 4,096 x 24 x 128 scores are 50 MB)."""
    assert ivf_scan.batch_chunk(4096, 24, 128) == 4096
    assert ivf_scan.batch_chunk(4096, 1024, 1024) == 256
    monkeypatch.setattr(ivf_scan, "SCRATCH_BYTES", 24 * 128 * 4 * 100)
    assert ivf_scan.batch_chunk(4096, 24, 128) == 100 and ivf_scan.batch_chunk(7, 24, 128) == 7
    assert ivf_scan.batch_chunk(5, 24, 4096) == 3 and ivf_scan.batch_chunk(5, 24, 128 * 101) == 1


def test_exact_rerank_plain_dedup_keeps_one_copy_per_id():
    """With dedup a live id comes back once, at its exact distance; an empty
    slot (non-finite coarse score) never hides a live copy of its id."""
    vectors = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    queries = torch.zeros((1, 2))
    pool = torch.tensor([[5, 3, 5, 1, 3, 3, -1]], dtype=torch.int32)
    coarse = torch.tensor([[0.0, float("inf"), 1.0, 0.0, 2.0, 0.0, 0.0]])
    d, i = ivf_rerank.ivf_exact_rerank(vectors, queries, pool, coarse, 5, "euclidean", dedup=True)
    assert i[0].tolist() == [1, 3, 5, -1, -1]
    assert d[0, :3].tolist() == [4.0 + 9.0, 36.0 + 49.0, 100.0 + 121.0] and torch.isinf(d[0, 3:]).all()
    d, i = ivf_rerank.ivf_exact_rerank(vectors, queries, pool, coarse, 5, "euclidean")
    assert i[0].tolist() == [1, 3, 3, 5, 5]


def test_pool_errors_compares_multisets():
    """The multiset tie rule the pool checks use: a copy may come back twice,
    but a lost copy, a wrong distance, or an id at the last distance that does
    not carry it is a violation."""
    dist = {5: 1.0, 7: 2.0, 9: 3.0, 4: 3.0}.__getitem__
    want_d, want_i = [1.0, 1.0, 2.0, 3.0], [5, 5, 7, 9]
    assert pool_pass(want_d, want_i, [1.0, 1.0, 2.0, 3.0], [5, 5, 7, 4], dist)
    assert not pool_pass(want_d, want_i, [1.0, 1.0, 2.0, 3.0], [5, 7, 7, 9], dist)
    assert not pool_pass(want_d, want_i, [1.0, 1.5, 2.0, 3.0], [5, 5, 7, 9], dist)
    assert not pool_pass(want_d, want_i, [1.0, 1.0, 2.0, 3.0], [5, 5, 7, 7], dist)
    assert pool_pass([1.0, float("inf")], [5, -1], [1.0, float("inf")], [5, -1], dist)


def pool_pass(want_d, want_i, got_d, got_i, dist):
    return pool_errors(want_d, want_i, got_d, got_i, dist, 1e-6) == []


def test_exact_rerank_plain_empty_slots_and_short_pools():
    """Non-finite coarse scores and ids outside [0, cap) are empty; k past
    the pool pads (inf, -1)."""
    vectors = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    queries = torch.zeros((1, 2))
    pool = torch.tensor([[5, 3, -1, 9, 1]], dtype=torch.int32)
    coarse = torch.tensor([[0.0, float("inf"), 0.0, 0.0, 1.0]])
    d, i = ivf_rerank.ivf_exact_rerank(vectors, queries, pool, coarse, 7, "euclidean")
    assert i[0].tolist() == [1, 5, -1, -1, -1, -1, -1]
    assert d[0, :2].tolist() == [4.0 + 9.0, 100.0 + 121.0] and torch.isinf(d[0, 2:]).all()


def test_kernel_wrappers_refuse_bad_operands_on_cpu():
    qp = torch.zeros((2, 4))
    slabs = torch.zeros((3, 5, 4), dtype=torch.float16)
    with pytest.raises(TypeError, match="slabs"):
        ivf_scan.ivf_probe_scan(qp, torch.zeros((2, 1), dtype=torch.int32), slabs, torch.zeros((3, 5)),
                                torch.zeros((3, 5), dtype=torch.int32), None, 4)
    with pytest.raises(ValueError, match="metrics"):
        ivf_rerank.ivf_exact_rerank(torch.zeros((3, 4)), qp, torch.zeros((2, 2), dtype=torch.int32),
                                    torch.zeros((2, 2)), 1, "hamming")
