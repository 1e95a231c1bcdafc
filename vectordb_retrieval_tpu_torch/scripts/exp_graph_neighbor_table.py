"""The production node beam against a neighbour-table beam whose merge
dedups by an argsort, on random-20k (degree 32, ef 125, expand 48, 5
iterations): QPS over 8 batches of 256 and recall@20 on the first, with
f32 and bf16 tables, then four narrower and deeper settings on the bf16
table.

The table ``[N, R, d]`` turns an iteration's ``B W R`` scattered row
gathers into ``B W`` contiguous ``[R, d]`` rows, at R times the index's
memory. It bears on ``ops/graph.build_neighbor_table`` and the beam's
merge.

The counterpart of the JAX package's ``scripts/exp_graph_neighbor_table.py``:
the same module constants (``N``, ``D``, ``K``, ``B``, ``REPEATS``,
``EF``, ``EXPAND``, ``ITERS``, ``R``), settings (``RETUNES``), inputs
(NumPy seed 42), graph, entry points (``ops/graph.pick_entry_points``,
whose k-means runs kernel K3) and printed lines, then one ``check`` line
(``scripts/probes.print_check``) with every line's recall and QPS and the
best recall. :func:`nbr_table_search` copies the JAX script's beam, which
differs from the production beam (``ops/graph.graph_search``) in its
merge: all ``W R`` neighbours join the beam, sorted by id with the
expanded copy first (a stable argsort), and every later copy of an id is
dropped. ``approx_max_k`` is ``top_k_smallest``. Timing as
``exp_beam_tune`` (``scripts/probes.timed_batches``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_graph_neighbor_table [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch
import torch.nn.functional as F

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import graph as gops
from vectordb_retrieval_tpu_torch.ops.distances import top_k_smallest
from vectordb_retrieval_tpu_torch.scripts.probes import (
    beam_inputs,
    print_check,
    set_recall,
    timed_batches,
)
from vectordb_retrieval_tpu_torch.utils.device import resolve_device, synchronize

N, D, K = 20_000, 64, 20
B = 256
REPEATS = 8
EF, EXPAND, ITERS = 125, 48, 5
R = 32
# narrower / deeper settings of the bf16 table: (ef, W, iters)
RETUNES = ((125, 16, 10), (125, 8, 18), (96, 16, 9), (64, 8, 12))


def nbr_table_search(queries, nbr_vecs, nbr_sqn, adjacency, entry_ids, entry_vecs, entry_sqn,
                     k, ef=64, expand=4, iters=12):
    """The JAX script's table beam (l2): ``(dists [B, min(k, ef)], ids)``."""
    b = queries.shape[0]
    r = adjacency.shape[1]
    e = entry_ids.shape[0]
    big = float("inf")
    qn = torch.sum(queries * queries, dim=-1)

    seed_dots = queries.to(entry_vecs.dtype) @ entry_vecs.T
    seed_d = qn[:, None] + entry_sqn[None, :] - 2.0 * seed_dots
    seed_d = torch.where(entry_ids[None, :] >= 0, seed_d, big)
    seed_ids = entry_ids[None, :].expand(b, e)
    if e > ef:
        seed_d, sel = top_k_smallest(seed_d, ef)
        seed_ids = torch.gather(seed_ids, 1, sel)
        e = ef
    pad = max(ef - e, 0)
    beam_ids = F.pad(seed_ids, (0, pad), value=-1)[:, :ef]
    beam_d = F.pad(seed_d, (0, pad), value=big)[:, :ef]
    beam_exp = torch.zeros((b, ef), dtype=torch.bool, device=queries.device)
    q_cast = queries.to(nbr_vecs.dtype).float()
    first = torch.zeros((b, 1), dtype=torch.bool, device=queries.device)

    for _ in range(iters):
        sel_d = torch.where(beam_exp | (beam_ids < 0), big, beam_d)
        _, sel = top_k_smallest(sel_d, expand)
        sel_ids = torch.gather(beam_ids, 1, sel)
        sel_valid = torch.isfinite(torch.gather(sel_d, 1, sel))
        beam_exp = beam_exp.scatter(1, sel, True)
        safe_sel = sel_ids.clamp(min=0)
        neigh = adjacency[safe_sel]  # [B, W, R]
        nvec = nbr_vecs[safe_sel].float()  # [B, W, R, d]
        dots = torch.einsum("bwrd,bd->bwr", nvec, q_cast)
        nd = qn[:, None, None] + nbr_sqn[safe_sel] - 2.0 * dots
        neigh = torch.where(sel_valid[:, :, None] & (neigh >= 0), neigh, -1).reshape(b, expand * r)
        nd = torch.where(neigh >= 0, nd.reshape(b, expand * r), big)
        cat_ids = torch.cat([beam_ids, neigh], dim=1)
        cat_d = torch.cat([beam_d, nd], dim=1)
        cat_exp = torch.cat([beam_exp, torch.zeros_like(neigh, dtype=torch.bool)], dim=1)
        # sort by id, the expanded copy first; drop every later copy
        sort_key = torch.where(cat_ids < 0, 2**31 - 1, cat_ids * 2 + (1 - cat_exp.long()))
        order = torch.argsort(sort_key, dim=1, stable=True)
        s_ids = torch.gather(cat_ids, 1, order)
        s_d = torch.gather(cat_d, 1, order)
        s_exp = torch.gather(cat_exp, 1, order)
        dup = torch.cat([first, s_ids[:, 1:] == s_ids[:, :-1]], dim=1)
        s_d = torch.where(dup | (s_ids < 0), big, s_d)
        beam_d, pos = top_k_smallest(s_d, ef)
        beam_ids = torch.gather(s_ids, 1, pos)
        beam_exp = torch.gather(s_exp, 1, pos)
        beam_ids = torch.where(torch.isfinite(beam_d), beam_ids, -1)
    out_d, pos = top_k_smallest(beam_d, min(k, ef))
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
    gt_i = dops.exact_search(queries_r[0], x, K, metric="l2", device=device)[1].cpu().numpy()
    rows = {}

    def run(label, search):
        ids, el = timed_batches(search, queries_r, device)
        rows[label] = {"qps": B * REPEATS / el, "recall": set_recall(ids, gt_i)}
        return rows[label]["qps"], rows[label]["recall"]

    print("building graph...")
    t0 = time.perf_counter()
    adjacency = gops.build_knn_graph(x, R).long()
    entries = gops.pick_entry_points(x, min(2048, max(16, N // 64)), seed=42).long()
    synchronize(device)
    print(f"build {time.perf_counter() - t0:.1f}s")
    sqn = dops.sq_norms(x)

    # the production beam
    qps_c, rec_c = run("current", lambda qb: gops.graph_search(
        qb, x, adjacency, entries, K, ef=EF, expand=EXPAND, iters=ITERS, metric="l2",
        sqnorms=sqn))
    print(f"current beam:      {qps_c:10.0f} QPS  recall@{K}={rec_c:.4f}")

    # the neighbour-table beam (f32 and bf16 tables)
    safe_adj = adjacency.clamp(min=0)
    ent_safe = entries.clamp(min=0)
    ent_vecs, ent_sqn = x[ent_safe], sqn[ent_safe]
    nbr_sqn = sqn[safe_adj]  # [N, R]
    tables = {}
    for dt, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tables[label] = nbr_vecs = x.to(dt)[safe_adj]  # [N, R, d]
        mb = nbr_vecs.numel() * nbr_vecs.element_size() / 1e6
        qps_n, rec_n = run(f"nbr-table {label}", lambda qb, nv=nbr_vecs: nbr_table_search(
            qb, nv, nbr_sqn, adjacency, entries, ent_vecs, ent_sqn, K, ef=EF, expand=EXPAND,
            iters=ITERS))
        print(f"nbr-table {label}:  {qps_n:10.0f} QPS  recall@{K}={rec_n:.4f}  table={mb:.0f}MB")

    # narrower / deeper settings once gathers are cheap
    for ef, w, it in RETUNES:
        qps_n, rec_n = run(f"nbr bf16 ef={ef} W={w} it={it}", lambda qb: nbr_table_search(
            qb, tables["bf16"], nbr_sqn, adjacency, entries, ent_vecs, ent_sqn, K, ef=ef,
            expand=w, iters=it))
        print(f"nbr bf16 ef={ef} W={w} it={it}: {qps_n:10.0f} QPS  recall@{K}={rec_n:.4f}")
    print_check(rows=rows, best_recall=max(r["recall"] for r in rows.values()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
