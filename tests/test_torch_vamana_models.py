"""Models of K10's merge and K11's panel greedy, held to the plain versions on the CPU.

The second designs of K10 (``csrc/vamana_search.cu``) and K11
(``csrc/vamana_prune.cu``) compute what the first designs did by other
algorithms. The CUDA sources cannot run here, so their algorithms are written
out below in plain Python, step by step as the kernels take them, and held
equal to the plain versions the kernels are checked against on the card:

- ``k10_merge_model``: K10's merge. Entries become u64 keys (the distance's
  order bits with -0.0 as 0.0, id + 1, a bit for -0.0); only the new entries
  below the list's largest key survive (all of them with compaction when the
  list holds a real entry at inf; without compaction, when the list holds
  holes, only as many past its largest real key as can take a hole's place:
  ``hole_cut``); the survivors alone are sorted, and every
  entry's place follows from ranks, holes kept in place or compacted. Held to
  ``vamana_search.merge_sorted`` on seeded and hypothesis-drawn inputs, and
  inside whole walks of ``beam_search_plain``.
- ``k11_panel_model``: K11's panels of 32 live candidates, their kill masks
  and the one-warp greedy over them, held to ``robust_prune_plain``.

Both comparisons are exact (ids, flags and the bits of every distance): the
models reorder no arithmetic.
"""

import bisect

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from semadb_tpu_torch.ops.kernels import vamana_prune as k11
from semadb_tpu_torch.ops.kernels import vamana_search as k10
from semadb_tpu_torch.tools import vamana_operands as vo

NIL = -1
INF = float("inf")
HOLE = 0xFF80000000000000  # the key of (inf, -1)
PAD = (1 << 64) - 1
PANEL = 32  # live candidates a panel: kPanel in csrc/vamana_prune.cu
HYPOTHESIS = settings(max_examples=300, deadline=None, derandomize=True, database=None)


def key_of(d: float, i: int) -> int:
    u = int(np.array(d, np.float32).view(np.uint32))
    neg0 = u == 0x80000000
    if neg0:
        u = 0
    o = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (o << 32) | ((((i + 1) & 0xFFFFFFFF) << 1) & 0xFFFFFFFF) | int(neg0)


def dist_of(k: int) -> np.float32:
    if k & 1:
        return np.float32(-0.0)
    o = k >> 32
    u = (o & 0x7FFFFFFF) if o & 0x80000000 else (~o & 0xFFFFFFFF)
    return np.array(u, np.uint32).view(np.float32)[()]


def id_of(k: int) -> int:
    return ((k & 0xFFFFFFFF) >> 1) - 1


def hole_cut(nk, holes, sv):
    """An uncompacted merge whose list has ``holes`` holes and no real entry
    past them keeps its holes in place, so a new entry past the list's
    largest real key can only take a hole's place: the ``holes - a``
    smallest such (a: the survivors below that key) can enter, and no
    other. Returns the bound (exclusive) that keeps them."""
    top_real = nk[-1] if nk else 0
    need = holes - sum(k < top_real for k in sv)
    if need <= 0:
        return top_real
    beyond = sorted(k for k in sv if k >= top_real)
    return beyond[need - 1] + 1 if need <= len(beyond) else PAD


def merge_row(lk, le, new_keys, n_new, L, compact):
    """K10's merge of one list (keys in stored order, flags) with the real
    new entries' keys (``n_new`` new entries in all, the rest holes)."""
    top = max(lk)
    bound = PAD if compact and top > HOLE else top
    sv = [k for k in new_keys if k < bound]
    hnew = n_new - len(new_keys) if bound > HOLE else 0
    nk = [k for k in lk if k != HOLE]
    if not compact and bound == HOLE:
        sv = [k for k in sv if k < hole_cut(nk, L - len(nk), sv)]
    sv.sort()
    nke = [e for k, e in zip(lk, le) if k != HOLE]
    assert nk == sorted(nk), "a list's real entries are sorted"
    F = len(nk)
    dup = [(j > 0 and sv[j - 1] == x) or (bisect.bisect_right(nk, x) > 0 and nk[bisect.bisect_right(nk, x) - 1] == x)
           for j, x in enumerate(sv)]
    dp = np.concatenate([[0], np.cumsum(dup, dtype=np.int64)]).tolist()
    ndup = dp[-1]
    holes = (L - F) + hnew
    out, oute = [None] * L, [None] * L

    def put(p, k, e):
        if p < L:
            assert out[p] is None, "every place is written once"
            out[p], oute[p] = k, e

    for j, x in enumerate(sv):
        past = x > HOLE
        p = j + bisect.bisect_right(nk, x) + (holes if past else 0)
        if compact:
            if dup[j]:
                continue
            p += ndup - dp[j] if past else -dp[j]
        put(p, HOLE if dup[j] else x, False)
    for i, k in enumerate(nk):
        past = k > HOLE
        c = bisect.bisect_left(sv, k)
        p = i + c + (holes if past else 0)
        if compact:
            p += ndup - dp[c] if past else -dp[c]
        put(p, k, nke[i])
    c = bisect.bisect_left(sv, HOLE)
    start, length = bisect.bisect_left(nk, HOLE) + c, holes
    if compact:
        start, length = start - dp[c], length + ndup
    for p in range(start, min(start + length, L)):
        put(p, HOLE, False)
    assert None not in out, "every place is written"
    return out, oute


def k10_merge_model(dists, ids, exp, new_d, new_i, L: int, compact: bool = True):
    """``merge_sorted``'s signature and result, by K10's merge, row by row."""
    rows_d, rows_i, rows_e = [], [], []
    for b in range(ids.shape[0]):
        lk = [key_of(d, i) for d, i in zip(dists[b].tolist(), ids[b].tolist())]
        new_keys = [key_of(d, i) for d, i in zip(new_d[b].tolist(), new_i[b].tolist()) if i != NIL]
        out, oute = merge_row(lk, exp[b].tolist(), new_keys, new_i.shape[1], L, compact)
        rows_d.append([dist_of(k) for k in out])
        rows_i.append([id_of(k) for k in out])
        rows_e.append(oute)
    return (torch.from_numpy(np.array(rows_d, np.float32).reshape(-1, L)),
            torch.tensor(rows_i, dtype=ids.dtype).reshape(-1, L), torch.tensor(rows_e, dtype=torch.bool).reshape(-1, L))


def _equal(got, want) -> None:
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)  # the bits: -0.0 is not 0.0 here
        assert torch.equal(g, w), (g, w)


VALUES = np.array([-INF, -1.0, -0.0, 0.0, 0.0, 1.0, 1.0, 2.0, 3.0, INF], np.float32)


def merge_operands(rng, L: int, n: int, compact_like: bool, values=VALUES):
    """A list of L as a walk leaves it (real ids distinct, their entries
    sorted by (d, id) with -0.0 as 0.0, holes (inf, -1) among them anywhere,
    or after the finite ones when ``compact_like``; flags on finite entries)
    and n new entries (ids repeating each other and the list's, -1 holes), each
    id at one distance."""
    pool = L + n + 1
    dmap = rng.choice(values, pool)
    real = rng.choice(pool, int(rng.integers(0, L + 1)), replace=False)
    real = sorted(real.tolist(), key=lambda i: (float(dmap[i]) + 0.0, i))
    d = [float(dmap[i]) for i in real]
    e = [bool(rng.random() < 0.5) and np.isfinite(x) for x in d]
    ids = list(real)
    for _ in range(L - len(real)):
        at = sum(np.isfinite(d)) if compact_like else int(rng.integers(0, len(ids) + 1))
        ids.insert(at, NIL)
        d.insert(at, INF)
        e.insert(at, False)
    new_i = rng.integers(-1, pool, n)
    again = rng.random(n) < 0.3  # repeat a list id
    new_i[again] = rng.choice(real, int(again.sum())) if real else NIL
    new_d = np.where(new_i == NIL, np.float32(INF), dmap[np.maximum(new_i, 0)])
    return (torch.tensor([d], dtype=torch.float32), torch.tensor([ids], dtype=torch.int32),
            torch.tensor([e], dtype=torch.bool), torch.from_numpy(new_d[None].astype(np.float32)),
            torch.from_numpy(new_i[None].astype(np.int32)))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("L,n", [(1, 0), (1, 5), (4, 0), (5, 17), (12, 8), (40, 128), (75, 512), (9, 2), (75, 129)])
def test_k10_merge_model_equals_merge_sorted(L, n, compact):
    rng = np.random.default_rng(L * 1000 + n + compact)
    for _ in range(40):
        ops = merge_operands(rng, L, n, compact_like=bool(rng.random() < 0.5))
        _equal(k10_merge_model(*ops, L, compact), k10.merge_sorted(*ops, L, compact))


@pytest.mark.parametrize("compact", [False, True])
def test_k10_merge_model_with_real_entries_at_inf(compact):
    """Real entries at inf in the list: with compaction a dup's hole moves
    ahead of them, so every new entry must be taken, dups past the list's
    end included."""
    rng = np.random.default_rng(7)
    for _ in range(200):
        ops = merge_operands(rng, int(rng.integers(1, 9)), int(rng.integers(0, 12)), False,
                             values=np.array([1.0, INF, INF, INF], np.float32))
        L = ops[1].shape[1]
        _equal(k10_merge_model(*ops, L, compact), k10.merge_sorted(*ops, L, compact))


@st.composite
def merge_case(draw):
    L = draw(st.integers(1, 10))
    n = draw(st.integers(0, 16))
    values = np.array(draw(st.lists(st.sampled_from([-INF, -2.0, -0.0, 0.0, 1.0, 2.5, INF]), min_size=1,
                                    max_size=4)), np.float32)
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    return L, merge_operands(rng, L, n, draw(st.booleans()), values), draw(st.booleans())


@HYPOTHESIS
@given(merge_case())
def test_k10_merge_model_equals_merge_sorted_drawn(case):
    L, ops, compact = case
    _equal(k10_merge_model(*ops, L, compact), k10.merge_sorted(*ops, L, compact))


@pytest.mark.parametrize("metric", ["euclidean", "dot", "cosine"])
@pytest.mark.parametrize("L,W,track,seeded", [(25, 1, True, False), (40, 2, False, True), (12, 8, True, True),
                                              (40, 2, False, False), (75, 8, True, False), (5, 5, False, True)])
def test_k10_merge_model_in_whole_walks(monkeypatch, metric, L, W, track, seeded):
    """The model in place of merge_sorted inside the plain walk: lists
    filling up, seeds, interior holes hop after hop, rings; dot gives -0.0."""
    v, a = vo.random_graph(400, 8, 16, integer=True, metric=metric, seed=L + W, device="cpu")
    q = vo.random_queries(6, 8, integer=True, metric=metric, seed=W, device="cpu")
    seeds = vo.random_seeds(6, 20, v.shape[0], seed=L, device="cpu") if seeded else None
    args = (v, a, q, L, W, 0, metric, seeds, track)
    want = k10.beam_search_plain(*args)
    monkeypatch.setattr(k10, "merge_sorted", k10_merge_model)
    got = k10.beam_search_plain(*args)
    _equal(got, want)


# The quantized routes' tie pattern: integer hamming and ADC distances and
# jaccard's few distinct fractions, each shared by many ids
QUANT_VALUES = {
    "hamming": np.arange(0, 9, dtype=np.float32),
    "jaccard": np.array([0.0, 0.25, 1 / 3, 0.5, 0.6, 0.75, 1.0], np.float32),
    "adc": np.arange(0, 33, 4, dtype=np.float32),
}


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("kind", list(QUANT_VALUES))
@pytest.mark.parametrize("L,n", [(12, 8), (40, 128), (75, 129), (75, 512)])
def test_k10_merge_model_on_quantized_ties(L, n, compact, kind):
    """Heavy ties across ids, as the bit and ADC routes make them: the (d, id)
    keys must order them so that an id's copies land together and dedup."""
    rng = np.random.default_rng(L * 100 + n + compact)
    for _ in range(40):
        ops = merge_operands(rng, L, n, compact_like=bool(rng.random() < 0.5), values=QUANT_VALUES[kind])
        _equal(k10_merge_model(*ops, L, compact), k10.merge_sorted(*ops, L, compact))


@pytest.mark.parametrize("route", ["hamming", "jaccard", "adc"])
@pytest.mark.parametrize("L,W,track,seeded", [(40, 2, False, True), (40, 2, True, True), (12, 8, True, False),
                                              (75, 2, False, False)])
def test_k10_merge_model_in_quantized_walks(monkeypatch, route, L, W, track, seeded):
    """The model in place of merge_sorted inside the plain walk on each
    quantized route: packed signs by hamming or jaccard (some all-zero codes),
    PQ codes through integer-valued tables; with and without the ring."""
    v, a = vo.random_graph(400, 64, 16, integer=True, metric="euclidean", seed=L + W, device="cpu")
    q = vo.random_queries(6, 64, integer=True, metric="euclidean", seed=W, device="cpu")
    if route == "adc":
        c, p = vo.adc_codes(v.shape[0], 6, 8, 16, integer=True, seed=L, device="cpu")
        codes = k10.Codes("product", c, p)
    else:
        c, p = vo.bit_codes(v, q, zero_rows=0.1, seed=L)
        codes = k10.Codes("binary", c, p, route)
    seeds = vo.random_seeds(6, 20, v.shape[0], seed=L, device="cpu") if seeded else None
    args = (v, a, q, L, W, 0, "euclidean", seeds, track, codes)
    want = k10.beam_search_plain(*args)
    monkeypatch.setattr(k10, "merge_sorted", k10_merge_model)
    got = k10.beam_search_plain(*args)
    _equal(got, want)


def k11_panel_model(cand_d, cand_i, self_ids, vectors, degree, r_stop, alpha, metric, panel=PANEL):
    """K11's panels: the next ``panel`` live candidates against every later
    live one as kill masks, the greedy over the panel by the masks alone,
    then the kept rows' kills on the later ones; ``robust_prune_plain``'s
    signature and result."""
    B, P = cand_i.shape
    pd = k11.pairwise_among(vectors, cand_i, metric)
    kill = (torch.tensor(alpha, dtype=torch.float32) * pd < cand_d[:, None, :]).tolist()  # [b][i][j]
    out = torch.full((B, degree), NIL, dtype=torch.int32)
    for b in range(B):
        d, ids, me = cand_d[b].tolist(), cand_i[b].tolist(), int(self_ids[b])
        live = [j for j in range(P) if ids[j] != NIL and ids[j] != me and np.isfinite(d[j])]
        dead = [False] * len(live)
        count = cursor = 0
        while count < r_stop:
            al = [i for i in range(cursor, len(live)) if not dead[i]]
            if not al:
                break
            m, npn = len(al), min(panel, len(al))
            km = [sum(1 << i for i in range(min(npn, c)) if kill[b][live[al[i]]][live[al[c]]]) for c in range(m)]
            alive, kept = (1 << npn) - 1, 0
            for i in range(npn):
                if not (alive >> i) & 1:
                    continue
                if count >= r_stop:
                    break
                kept |= 1 << i
                if count < degree:
                    out[b, count] = ids[live[al[i]]]
                count += 1
                alive &= ~sum(1 << lane for lane in range(i + 1, npn) if (km[lane] >> i) & 1)
            for c in range(m):
                if c < npn or km[c] & kept:
                    dead[al[c]] = True
            cursor = al[npn - 1] + 1
    return out


@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("metric,dim,P,R,r_stop,panel", [
    ("euclidean", 16, 77, 32, 32, 32), ("euclidean", 16, 160, 64, 64, 32), ("euclidean", 16, 45, 32, 13, 32),
    ("euclidean", 16, 100, 4, 8, 32), ("dot", 16, 70, 32, 32, 32), ("cosine", 16, 66, 32, 20, 32),
    ("haversine", 2, 50, 16, 16, 32), ("euclidean", 16, 61, 32, 29, 5), ("dot", 16, 33, 40, 33, 32),
])
def test_k11_panel_model_equals_robust_prune_plain(alpha, metric, dim, P, R, r_stop, panel):
    """P not a multiple of the panel (33: one live row past the first
    panel), r_stop hit mid-panel (13 of 45, 20, 29 at panels of 5), R below
    r_stop; integer pools with repeats, the node's
    own id and -1 tails."""
    v, _ = vo.random_graph(3000, dim, 8, integer=True, metric=metric, seed=P, device="cpu")
    d, i, s = vo.prune_pools(v, 24, P, metric, seed=R + P)
    want = k11.robust_prune_plain(d, i, s, v, R, r_stop, alpha, metric)
    got = k11_panel_model(d, i, s, v, R, r_stop, alpha, metric, panel)
    assert torch.equal(got, want), (got != want).any(1).nonzero()[:5]
