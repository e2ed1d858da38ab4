"""Top-k selection and sorted-list merge primitives.

Port of ``semadb_tpu/ops/topk.py``. Convention everywhere: distances,
smaller is better; invalid slots carry ``INF`` distance and id ``-1``.

Among equal distances ``torch.topk`` promises no order on CUDA, where
``lax.top_k`` puts the lower index first; results are compared by the tie
rule (equal distances; equal ids below the k-th distance; at the k-th
distance, some set of rows carrying it), and pools that may hold an id
twice by its multiset form.
"""

from __future__ import annotations

import collections

import torch

INF = float("inf")
INVALID_ID = -1


def top_k_smallest(dists: torch.Tensor, k: int):
    """Smallest-k along the last axis → (values, indices), ascending."""
    return torch.topk(dists, k, dim=-1, largest=False, sorted=True)


def sort_by_distance(dists: torch.Tensor, ids: torch.Tensor, *rest: torch.Tensor):
    """Sort (dist, id) pairs ascending by distance along the last axis,
    ties broken by id (two stable sorts: by id, then by distance), so equal
    pairs keep their order, as ``jnp.lexsort`` and the stable
    ``lax.sort`` keep it; ``rest`` (tensors of the same shape) ride along."""
    out = (dists, ids, *rest)
    for key in (1, 0):
        order = torch.argsort(out[key], dim=-1, stable=True)
        out = tuple(torch.gather(t, -1, order) for t in out)
    return out


def smallest_k_stable(d: torch.Tensor, k: int):
    """The k smallest along the last axis, ascending, equal values in index
    order and -0.0 below 0.0: ``lax.top_k(-d, k)``'s order, from a stable
    sort of the floats' total-order integer keys."""
    bits = d.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.argsort(key, dim=-1, stable=True)[..., :k]
    return torch.gather(d, -1, idx), idx


def dedup_by_id(dists: torch.Tensor, ids: torch.Tensor):
    """Invalidate duplicate ids (dist=INF, id=-1), keeping the smallest
    distance per id (the first slot among equal ones). O(K^2) mask compare
    over the last axis."""
    same = ids[..., :, None] == ids[..., None, :]
    pos = torch.arange(ids.shape[-1], device=ids.device)
    better = (dists[..., None, :] < dists[..., :, None]) | (
        (dists[..., None, :] == dists[..., :, None]) & (pos[None, :] < pos[:, None])
    )
    dup = (same & better).any(-1) | (ids == INVALID_ID)
    return dists.masked_fill(dup, INF), ids.masked_fill(dup, INVALID_ID)


def merge_topk(dists_a, ids_a, dists_b, ids_b, k: int):
    """Merge two candidate sets and keep the k smallest, dropping duplicate
    ids (keeps the best occurrence)."""
    dists = torch.cat([dists_a, dists_b], dim=-1)
    ids = torch.cat([ids_a, ids_b], dim=-1)
    dists, ids = sort_by_distance(*dedup_by_id(dists, ids))
    return dists[..., :k], ids[..., :k]


def masked_top_k(dists: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k smallest among entries where ``mask`` is True."""
    return top_k_smallest(dists.masked_fill(~mask, INF), k)


def tie_rule_errors(ref_d, ref_ids, got_d, got_ids, dist_of, atol: float = 0.0) -> list:
    """Compare one ranked result list with a reference by the tie rule.

    ``ref_d``/``ref_ids``: the reference's k results, ascending;
    ``got_d``/``got_ids``: the results under test; ``dist_of``: id → its
    true distance (a mapping or callable), used for the rows at the k-th
    distance. Ids may be any hashable (node ids, UUID strings). Returns the
    list of violations, empty when the results agree."""
    lookup = dist_of if callable(dist_of) else dist_of.__getitem__
    ref_d, got_d = [float(d) for d in ref_d], [float(d) for d in got_d]
    if len(ref_d) != len(got_d):
        return [f"{len(got_d)} results, reference has {len(ref_d)}"]
    errors = [
        f"distance {i}: {g} != {r}"
        for i, (r, g) in enumerate(zip(ref_d, got_d))
        if not (r == g or abs(r - g) <= atol)
    ]
    if errors or not ref_d:
        return errors
    dk = ref_d[-1]
    below_ref = {i for d, i in zip(ref_d, ref_ids) if d < dk - atol}
    below_got = {i for d, i in zip(got_d, got_ids) if d < dk - atol}
    if below_ref != below_got:
        errors.append(
            f"ids below the k-th distance differ: missing {below_ref - below_got}, "
            f"extra {below_got - below_ref}"
        )
    if len(set(got_ids)) != len(got_ids):
        errors.append("duplicate ids in the results")
    for d, i in zip(got_d, got_ids):
        if d >= dk - atol and abs(float(lookup(i)) - dk) > atol:
            errors.append(f"id {i} at the k-th distance {dk} has distance {lookup(i)}")
    return errors


def pool_errors(want_d, want_i, got_d, got_i, dist_of, atol: float = 0.0) -> list:
    """The tie rule for one row of a pool that may hold an id twice (points
    stored with copies): distances equal within ``atol`` place by place; the
    multiset of ids below the last reference distance equal; every other
    returned id carries that distance (``dist_of``), or is -1 at inf.
    Returns the list of violations, empty when the rows agree."""
    want_d, got_d = [float(d) for d in want_d], [float(d) for d in got_d]
    errs = [f"place {j}: {g} != {w}" for j, (w, g) in enumerate(zip(want_d, got_d))
            if not (w == g or abs(w - g) <= atol)]
    if len(want_d) != len(got_d):
        errs.insert(0, f"{len(got_d)} places, reference has {len(want_d)}")
    if errs or not want_d:
        return errs[:3]
    dk = want_d[-1]
    below_w = collections.Counter(i for d, i in zip(want_d, want_i) if d < dk - atol)
    below_g = collections.Counter(i for d, i in zip(got_d, got_i) if d < dk - atol)
    if below_w != below_g:
        return [f"ids below the last distance differ: {below_w - below_g} / {below_g - below_w}"]
    for d, i in zip(got_d, got_i):
        if d >= dk - atol:
            true = float("inf") if i == -1 else float(dist_of(i))
            if not (true == d or abs(true - d) <= atol):
                return [f"id {i} at distance {d} has distance {true}"]
    return []
