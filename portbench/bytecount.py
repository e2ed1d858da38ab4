"""The least bytes a kernel call must move, and the device's memory rate.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``_bound_ms`` and the K3
count in ``_cell_kernels``) and ``semadb_tpu_torch/tools/vamana_operands.py``
(``k10_least_bytes``, with the plain walk of
``ops/kernels/vamana_search.py`` it watches): each input byte read once,
each output byte written once, counted from the call's own operands.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's device memory (NVIDIA's data sheet)
NIL = -1
START_ID = 1  # the Vamana graph's start row (semadb_tpu_torch/models/constants.py START_NODE_ID)


def bound_s(nbytes: float) -> float:
    """The least time for ``nbytes`` at the memory rate."""
    return nbytes / HBM_BYTES_PER_S


def k3_bytes(qp, probe, slabs, slab_sq, slab_ids, mask, rr: int) -> int:
    """K3 (``ivf_probe_scan``): every slot id of each distinct probed cluster
    once, the row and norm of its live slots once, the queries and probe ids
    read and the pool of rr (distance, id) pairs written."""
    B, p = probe.shape
    S, r = slabs.shape[1], slabs.shape[2]
    probed = torch.unique(probe).long()
    live = int((slab_ids[probed] != NIL).sum())
    return int(probed.numel()) * S * 4 + live * (r * slabs.element_size() + 4) + B * r * 4 + B * p * 4 + B * rr * 8


def _sort_by_distance(d, i, *rest):
    """(distance, id) ascending, equal pairs in their order: two stable sorts."""
    out = (d, i, *rest)
    for key in (1, 0):
        order = torch.argsort(out[key], dim=-1, stable=True)
        out = tuple(torch.gather(t, -1, order) for t in out)
    return out


def _merge(d, i, e, nd, ni, L: int, compact: bool):
    """The walk's merge: list and new entries by (d, id), a repeated id
    dropped, the first L."""
    md, mi, me = _sort_by_distance(torch.cat([d, nd], -1), torch.cat([i, ni], -1),
                                   torch.cat([e, torch.zeros_like(ni, dtype=torch.bool)], -1))
    dup = torch.zeros_like(me)
    dup[..., 1:] = mi[..., 1:] == mi[..., :-1]
    dup &= mi != NIL
    md, mi, me = md.masked_fill(dup, float("inf")), mi.masked_fill(dup, NIL), me & ~dup
    if compact:
        md, mi, me = _sort_by_distance(md, mi, me)
    return md[..., :L], mi[..., :L], me[..., :L]


def k10_bytes(vectors, adjacency, queries, L: int, W: int, seeds) -> dict:
    """K10 (``vamana_beam_search``) on the f32 route without a ring (the
    plain search's walk): each distinct row the batch's walks score and each
    distinct adjacency row they expand, once for the batch, plus the queries
    and seeds read and the list and ring written. The rows come from the
    plain walk, run here hop by hop with its merges watched."""
    cap, R = adjacency.shape
    B, D = queries.shape
    dev = queries.device
    inf = float("inf")
    scored = torch.zeros(cap, dtype=torch.bool, device=dev)
    expanded = torch.zeros_like(scored)
    scored[START_ID] = True

    def gd(ids):
        diff = vectors[ids.clamp(0, cap - 1).long()] - queries[:, None, :]
        return (diff * diff).sum(-1)

    d = torch.full((B, L), inf, device=dev)
    i = torch.full((B, L), NIL, dtype=torch.int32, device=dev)
    d[:, 0] = gd(torch.full((B, 1), START_ID, dtype=torch.int32, device=dev))[:, 0]
    i[:, 0] = START_ID
    e = torch.zeros((B, L), dtype=torch.bool, device=dev)
    if seeds is not None:
        ok = (seeds != NIL) & (seeds != START_ID)
        si = seeds.masked_fill(~ok, NIL)
        d, i, e = _merge(d, i, e, gd(seeds).masked_fill(~ok, inf), si, L, compact=True)
        scored[si[ok].long()] = True
    pos_l = torch.arange(L, device=dev)
    for _ in range((3 * L + W - 1) // W):
        unexp = (i != NIL) & ~e & torch.isfinite(d)
        active = unexp.any(-1)
        if not bool(active.any()):
            break
        pos = torch.sort(torch.where(unexp, pos_l, pos_l + L), dim=-1).values[:, :W] % L
        sel = torch.gather(unexp, 1, pos)
        cur = torch.gather(i, 1, pos)
        e = e.scatter(1, pos, torch.gather(e, 1, pos) | sel)
        expanded[cur[sel].long()] = True
        nbr = adjacency[cur.clamp(0, cap - 1).long()].reshape(B, W * R)
        ok = (nbr != NIL) & sel.repeat_interleave(R, dim=-1)
        ni = nbr.masked_fill(~ok, NIL)
        scored[ni[ok].long()] = True
        md, mi, me = _merge(d, i, e, gd(nbr).masked_fill(~ok, inf), ni, L, compact=False)
        a = active[:, None]
        d, i, e = torch.where(a, md, d), torch.where(a, mi, i), torch.where(a, me, e)
    rows, nodes = int(scored.sum()), int(expanded.sum())
    ring = ((2 * L + W - 1) // W) * W
    io = B * D * 4 + (0 if seeds is None else seeds.numel() * 4) + B * (L + ring) * 8 + B * 12
    return {"bytes": rows * D * 4 + nodes * R * 4 + io, "rows": rows, "nodes": nodes}
