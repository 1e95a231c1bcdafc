"""A plain block beam: the walk of the port's block graph written from its
description, in float64, one query at a time, on the program's own layout.

Plain PyTorch; it imports nothing of ``vectordb_retrieval_tpu_torch`` (nor
JAX). The layout is the ``graph`` artifact's ``data`` of a block-mode build
(``models/graph.GraphIndexer``): ``entries [Ne, d]`` router entries (the
mean of each segment, a maximal run of one k-means cluster inside one
block), ``entry_block [Ne]``, ``slot_ids [Nb, L]`` (member rows, -1 pads),
``list_vecs [Nb, L, d]`` (f32 rows, or bf16 residuals against the f32 block
means ``list_mu [Nb, d]``) and ``entry_adj [Ne, R]``, the entry graph.

* :func:`decode`: the stored rows as float64;
* :func:`check_layout`: the layout holds the corpus as it claims to;
* :func:`walk`: the block beam, as ``ops/graph.py`` describes it.

Departures from HNSW, as the port makes them: the graph routes between
blocks, not nodes (an entry stands for a segment of a block, and a hop
scores every row of the block it lands on); the dense scan of every entry
replaces HNSW's upper layers; the walk runs a fixed number of waves
(``iters``) instead of stopping when the frontier holds nothing nearer than
the k-th answer.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# an entry is its segment's mean within this share of the block's largest
# |value| (at least 1): f32 sums of at most a block's rows
MEAN_TOL = 1e-6
# blocks whose segments are matched at once
BLOCK_CHUNK = 256


def decode(layout: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``[Nb, L, d]`` float64: the stored rows, block mean plus residual
    where the layout has means (pad slots hold whatever was stored)."""
    x = layout["list_vecs"].to(torch.float64)
    mu = layout.get("list_mu")
    if mu is not None:
        x = x + mu.to(torch.float64)[:, None, :]
    return x


def _half_ulp_bf16(r: torch.Tensor) -> torch.Tensor:
    """Half a bf16 unit in the last place at ``|r|`` (8 significant bits)."""
    _, exp = torch.frexp(r.abs())
    return torch.ldexp(torch.ones_like(r), (exp - 9).to(torch.int32))


def check_layout(layout: Dict[str, torch.Tensor], x: torch.Tensor) -> Dict[str, bool]:
    """The layout against the corpus ``x [N, d]`` as the program indexed it
    (unit rows for cosine). Returns each check by name; all must be True:

    * ``rows_once``: every row of ``x`` lies in exactly one slot;
    * ``pads``: every other slot holds -1;
    * ``decoded``: each decoded row lies within bf16's half unit in the
      last place of its residual (plus f32 rounding of the mean) of its
      row, or equals it for f32 slabs;
    * ``entry_means``: each block's entries, in id order, are the means of
      consecutive runs of its rows that cover it, each within
      :data:`MEAN_TOL`;
    * ``ids_in_range``: entry ids in the entry graph and ``entry_block``
      in range, ``entry_block`` nondecreasing.
    """
    slots = layout["slot_ids"].long()
    nb, length = slots.shape
    n = x.shape[0]
    flat = slots.reshape(-1)
    real = flat >= 0
    counts = torch.bincount(flat[real], minlength=n) if n else flat.new_zeros(0)
    out = {
        "rows_once": bool(counts.numel() == n and (counts == 1).all() and (flat[real] < n).all()),
        "pads": bool((flat[~real] == -1).all()),
    }
    x64 = x.to(torch.float64)
    mask = (slots >= 0)[:, :, None]
    want = torch.where(mask, x64[slots.clamp(min=0)], torch.zeros((), dtype=torch.float64))
    got = decode(layout)
    mu = layout.get("list_mu")
    if mu is None:
        out["decoded"] = bool(torch.where(mask, got == want, True).all())
    else:
        mu64 = mu.to(torch.float64)[:, None, :]
        resid = want - mu64
        tol = _half_ulp_bf16(resid) + 2.0 ** -23 * (want.abs() + mu64.abs())
        out["decoded"] = bool(torch.where(mask, (got - want).abs() <= tol, True).all())
    out["entry_means"] = _entries_are_segment_means(layout, want, (slots >= 0).sum(dim=1))
    ne = layout["entries"].shape[0]
    eb = layout["entry_block"].long()
    adj = layout["entry_adj"].long()
    out["ids_in_range"] = bool(
        eb.numel() == ne and ((eb >= 0) & (eb < nb)).all() and (eb[1:] >= eb[:-1]).all()
        and ((adj >= 0) & (adj < ne)).all())
    return out


def _entries_are_segment_means(layout, rows: torch.Tensor, real: torch.Tensor) -> bool:
    """Each block's entries (in id order) are the means of consecutive
    runs of its ``real`` rows that end at its last real row."""
    entries = layout["entries"].to(torch.float64)
    eb = layout["entry_block"].long()
    nb, length, d = rows.shape
    if eb.numel() and not ((eb >= 0) & (eb < nb)).all():
        return False
    per = torch.bincount(eb, minlength=nb)
    if not (per[real > 0] >= 1).all():
        return False
    first = torch.cumsum(per, 0) - per
    ends = torch.arange(length + 1, device=rows.device, dtype=torch.float64)
    for a in range(0, nb, BLOCK_CHUNK):
        b = min(a + BLOCK_CHUNK, nb)
        prefix = torch.cat([rows.new_zeros((b - a, 1, d)), torch.cumsum(rows[a:b], dim=1)], dim=1)
        tol = MEAN_TOL * torch.clamp(rows[a:b].abs().amax(dim=(1, 2)), min=1.0)
        start = torch.zeros(b - a, dtype=torch.long, device=rows.device)
        m = per[a:b]
        for s in range(int(m.max()) if m.numel() else 0):
            act = m > s
            e = (first[a:b] + s).clamp(max=max(entries.shape[0] - 1, 0))
            base = torch.gather(prefix, 1, start[:, None, None].expand(-1, 1, d))
            span = (ends - start[:, None].to(torch.float64)).clamp(min=1.0)
            means = (prefix - base) / span[:, :, None]
            err = (means - entries[e][:, None, :]).abs().amax(dim=2)  # [b - a, L + 1]
            idx = torch.arange(length + 1, device=rows.device)
            last = (s == m - 1)[:, None]
            ok = (idx[None] > start[:, None]) & (idx[None] <= real[a:b, None]) & (err <= tol[:, None])
            ok &= ~last | (idx[None] == real[a:b, None])
            found = ok.any(dim=1)
            if not found[act].all():
                return False
            stop = torch.argmax(ok.to(torch.int8), dim=1)
            start = torch.where(act, stop, start)
        if not (start[m > 0] == real[a:b][m > 0]).all():
            return False
    return True


def _dist(q: torch.Tensor, rows: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "l2":
        diff = rows - q
        return torch.sum(diff * diff, dim=-1)
    return -(rows @ q)


def walk(
    layout: Dict[str, torch.Tensor],
    q: torch.Tensor,
    k: int,
    efb: int,
    expand: int,
    iters: int,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor, List[List[List[int]]]]:
    """The block beam of each query of ``q [B, d]`` (unit rows for
    cosine, as the program searches them), in float64, one query at a time:

    1. the distance to every entry; the ``efb`` nearest form the frontier,
       deduplicated by block (the nearest entry of a block stays);
    2. each wave pops the ``expand`` nearest frontier entries; a popped
       entry whose block repeats one popped before it in the wave, or one
       visited in an earlier wave, is not scored;
    3. every member row of the popped blocks is scored from the decoded
       slabs and merged into a running top-``k``;
    4. on every wave but the last, the graph neighbours of the popped
       entries (each popped entry's, scored or not) whose block is neither
       in the frontier nor visited are ranked by their entry distance; the
       ``efb + 96`` nearest (repeats counted) are kept, deduplicated by
       block (the nearest copy stays), and the frontier becomes the ``efb``
       nearest of it and them.

    ``metric``: ``l2`` (squared) or ``ip`` / ``cosine`` (negated dot).
    ``efb`` and ``expand`` are clamped to the entry count and to ``efb``, as
    the program clamps them. Returns ``(dists [B, k], ids [B, k], pops)``:
    float64 distances, ids (-1 and +inf where fewer than ``k`` rows were
    scored), and each query's popped entry ids by wave.
    """
    metric = "l2" if metric == "l2" else "ip"
    entries = layout["entries"].to(torch.float64)
    eb = layout["entry_block"].long().tolist()
    adj = layout["entry_adj"].long().tolist()
    slots = layout["slot_ids"].long()
    rows = decode(layout)
    efb = min(efb, entries.shape[0])
    expand = min(expand, efb)
    q64 = q.to(torch.float64)
    out_d = torch.full((q.shape[0], k), float("inf"), dtype=torch.float64)
    out_i = torch.full((q.shape[0], k), -1, dtype=torch.long)
    pops: List[List[List[int]]] = []
    for j in range(q.shape[0]):
        qj = q64[j]
        cd = _dist(qj, entries, metric).cpu()
        cdl = cd.tolist()
        frontier: Dict[int, Tuple[float, int]] = {}  # block -> (distance, entry)
        for e in torch.argsort(cd, stable=True)[:efb].tolist():
            frontier.setdefault(eb[e], (cdl[e], e))
        visited = set()
        best_d = torch.empty(0, dtype=torch.float64)
        best_i = torch.empty(0, dtype=torch.long)
        waves = []
        for t in range(iters):
            ranked = sorted(frontier.values())
            popped = [e for _, e in ranked[:expand]]
            for _, e in ranked[:expand]:
                del frontier[eb[e]]
            blocks = []
            for e in popped:
                if eb[e] not in visited and eb[e] not in blocks:
                    blocks.append(eb[e])
            visited.update(blocks)
            waves.append(popped)
            if blocks:
                sel = torch.as_tensor(blocks, device=slots.device)
                ids = slots[sel].reshape(-1)
                dist = _dist(qj, rows[sel].reshape(-1, rows.shape[2]), metric)
                keep = ids >= 0
                cat_d = torch.cat([best_d, dist[keep].cpu()])
                cat_i = torch.cat([best_i, ids[keep].cpu()])
                order = torch.argsort(cat_d, stable=True)[:k]
                best_d, best_i = cat_d[order], cat_i[order]
            if t == iters - 1:
                break
            cands = []
            for e in popped:
                for nb_e in adj[e]:
                    if nb_e >= 0 and eb[nb_e] not in frontier and eb[nb_e] not in visited:
                        cands.append((cdl[nb_e], nb_e))
            cands.sort(key=lambda c: c[0])
            new: Dict[int, Tuple[float, int]] = {}
            for dist_e, e in cands[:efb + 96]:
                new.setdefault(eb[e], (dist_e, e))
            merged = sorted(list(frontier.values()) + list(new.values()))[:efb]
            frontier = {eb[e]: (dist_e, e) for dist_e, e in merged}
        pops.append(waves)
        out_d[j, :best_d.shape[0]] = best_d
        out_i[j, :best_i.shape[0]] = best_i
    return out_d, out_i, pops


def certain(d: torch.Tensor, rel: float) -> torch.Tensor:
    """``[B, k - 1]`` bool of ``d [B, k]`` (sorted distances of ``k`` ranks,
    one more than compared): rank ``r`` is certain where its distance lies
    more than ``rel`` of its value from both neighbours'."""
    prev = torch.cat([torch.full_like(d[:, :1], -float("inf")), d[:, :-1]], dim=1)
    tie = rel * d.abs()
    far = ((d - prev).abs() > tie)[:, :-1] & ((d[:, 1:] - d[:, :-1]).abs() > tie[:, :-1])
    return far


def near_ties(layout: Dict[str, torch.Tensor], q: torch.Tensor, a: List[int], b: List[int],
              metric: str, rel: float) -> bool:
    """True where each entry of ``a`` has an entry of ``b`` whose float64
    distance to ``q [d]`` lies within ``rel`` of its own, and the other way
    round: two pops that differ only by such swaps."""
    metric = "l2" if metric == "l2" else "ip"
    entries = layout["entries"].to(torch.float64)
    da = _dist(q.to(torch.float64), entries[torch.as_tensor(a, dtype=torch.long)], metric).tolist() if a else []
    db = _dist(q.to(torch.float64), entries[torch.as_tensor(b, dtype=torch.long)], metric).tolist() if b else []

    def covered(xs, ys):
        return all(any(abs(x - y) <= rel * max(abs(x), abs(y)) for y in ys) for x in xs)

    return covered(da, db) and covered(db, da)
