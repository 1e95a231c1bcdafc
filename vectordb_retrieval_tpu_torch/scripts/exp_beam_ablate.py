"""The node beam with one component off at a time, at production shapes
(R 64, E 2048, ef 128, W 24, keep 96, 3 iterations on 20k x 64): each
row's time beside the full copy's shows that component's share.

Components: the selection of the ``W`` best unexpanded entries, the scatter
that marks them, the validity mask, the neighbour gather and product, the
dedup against the beam, the top-keep preselection, the dedup inside it,
and the merge; ``seedonly`` turns them all off.

The counterpart of the JAX package's ``scripts/exp_beam_ablate.py``: the
same module constants (``N``, ``D``, ``K``, ``B``, ``REPEATS``, ``R``,
``E``, ``EF``, ``W``, ``KEEP``, ``ITERS``), inputs (NumPy seed 42), graph
(``ops/graph.build_knn_graph``), entry points (``ops/graph.
pick_entry_points``, whose k-means runs kernel K3) and printed lines, then
one ``check`` line (``scripts/probes.print_check``): the full copy's
recall@20, and whether its ids and distances equal ``ops/graph.
graph_search``'s on the first batch. :func:`beam` copies the JAX script's
beam with its toggles (the JAX script copies an earlier production beam;
where they differ, this copies the script: the entry points' seed
distances are not masked for padded ids), written with the same
operations as ``ops/graph.NodeBeam``. ``approx_max_k`` is
``top_k_smallest``, ``take_along_axis`` a ``gather``, ``.at[].set`` a
``scatter``. Timing: the JAX script scans the ``REPEATS`` batches in one
``jit``; here one untimed stream, then one timed stream of Python-driven
iterations, ending in one synchronise and one copy of the last ids to the
host (``scripts/probes.timed_batches``), so the host's pace is part of
each time.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_beam_ablate [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import graph as gops
from vectordb_retrieval_tpu_torch.ops.distances import top_k_smallest
from vectordb_retrieval_tpu_torch.scripts.probes import (
    beam_inputs,
    print_check,
    set_recall,
    timed_batches,
)
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

N, D, K = 20_000, 64, 20
B, REPEATS = 256, 20
R, E, EF, W, KEEP, ITERS = 64, 2048, 128, 24, 96, 3
SKIPS = ("", "select", "scatter", "mask", "gather", "dedupbeam", "preselect", "dedupintra",
         "merge", "seedonly")
_ALL = "select,scatter,mask,gather,dedupbeam,preselect,dedupintra,merge"


def beam(queries, vectors, adjacency, entry_ids, sqnorms, skip=""):
    """The JAX script's beam: ``(dists [B, K], ids [B, K])``, with each
    component named in ``skip`` turned off."""
    b = queries.shape[0]
    r = adjacency.shape[1]
    e = entry_ids.shape[0]
    big = float("inf")
    ef, keep, expand = EF, KEEP, W
    adjacency, entry_ids = adjacency.long(), entry_ids.long()

    safe_entry = entry_ids.clamp(min=0)
    entry_vecs = vectors[safe_entry]
    seed_dots = queries @ entry_vecs.T
    qn = torch.sum(queries * queries, dim=-1)
    seed_d = qn[:, None] + sqnorms[safe_entry][None, :] - 2.0 * seed_dots
    seed_ids = entry_ids[None, :].expand(b, e)
    beam_d, sel0 = top_k_smallest(seed_d, ef)
    beam_ids = torch.gather(seed_ids, 1, sel0)
    beam_exp = torch.zeros((b, ef), dtype=torch.bool, device=queries.device)

    for _ in range(ITERS):
        if "select" in skip:
            sel = torch.arange(expand, device=queries.device)[None].expand(b, expand)
            sel_ids = torch.gather(beam_ids, 1, sel)
            sel_valid = torch.ones((b, expand), dtype=torch.bool, device=queries.device)
        else:
            sel_d = torch.where(beam_exp | (beam_ids < 0), big, beam_d)
            _, sel = top_k_smallest(sel_d, expand)
            sel_ids = torch.gather(beam_ids, 1, sel)
            sel_valid = torch.isfinite(torch.gather(sel_d, 1, sel))
        if "scatter" not in skip:
            beam_exp = beam_exp.scatter(1, sel, True)
        neigh = adjacency[sel_ids.clamp(min=0)].reshape(b, expand * r)
        if "mask" not in skip:
            neigh = torch.where(
                torch.repeat_interleave(sel_valid, r, dim=1) & (neigh >= 0), neigh, -1)
        if "gather" in skip:
            nd = (neigh % 1000).float() * 1e-3 + qn[:, None] * 0.0
        else:
            nd = gops._batch_dists(queries, vectors, sqnorms, neigh, "l2")
        if "dedupbeam" not in skip:
            nd = torch.where(gops._member(neigh, beam_ids) | (neigh < 0), big, nd)
        if "preselect" in skip:
            cand_d, cand_ids = nd[:, :keep], neigh[:, :keep]
        else:
            cand_d, cpos = top_k_smallest(nd, keep)
            cand_ids = torch.gather(neigh, 1, cpos)
        if "dedupintra" not in skip:
            cand_d = torch.where(gops._earlier_equal(cand_ids) | (cand_ids < 0), big, cand_d)
        if "merge" not in skip:
            cat_ids = torch.cat([beam_ids, cand_ids], dim=1)
            cat_d = torch.cat([beam_d, cand_d], dim=1)
            cat_exp = torch.cat([beam_exp, torch.zeros_like(cand_ids, dtype=torch.bool)], dim=1)
            beam_d, pos = top_k_smallest(cat_d, ef)
            beam_ids = torch.gather(cat_ids, 1, pos)
            beam_exp = torch.gather(cat_exp, 1, pos)
            beam_ids = torch.where(torch.isfinite(beam_d), beam_ids, -1)
    out_d, pos = top_k_smallest(beam_d, K)
    return out_d, torch.gather(beam_ids, 1, pos)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    x_np, q_np = beam_inputs(N, D, B, REPEATS)
    x = torch.as_tensor(x_np, device=device)
    queries_r = torch.as_tensor(q_np, device=device)
    gt = dops.exact_search(queries_r[0], x, K, metric="l2", device=device)[1].cpu().numpy()
    adjacency = gops.build_knn_graph(x, R)
    entries = gops.pick_entry_points(x, E, seed=42)
    sqn = dops.sq_norms(x)

    base, rec = None, None
    for skip in SKIPS:
        sk = _ALL if skip == "seedonly" else skip
        ids, el = timed_batches(
            lambda qb, sk=sk: beam(qb, x, adjacency, entries, sqn, skip=sk), queries_r, device)
        ms = el / REPEATS * 1000
        if skip == "":
            base = ms
        delta = "" if base is None or skip == "" else f"  saves {base - ms:6.2f} ms"
        line = ""
        if skip == "":
            rec = set_recall(ids, gt)
            line = f"  recall={rec:.4f}"
        print(f"skip={skip or '(none)':12s} {ms:8.2f} ms/batch{delta}{line}")

    d_copy, i_copy = beam(queries_r[0], x, adjacency, entries, sqn)
    d_prod, i_prod = gops.graph_search(queries_r[0], x, adjacency, entries, K, ef=EF, expand=W,
                                       iters=ITERS, metric="l2", sqnorms=sqn, cand_keep=KEEP)
    print_check(recall=rec, ids_equal=bool(torch.equal(i_copy, i_prod)),
                dists_equal=bool(torch.equal(d_copy, d_prod)),
                padded_entries=int((entries < 0).sum()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
