"""The node beam over a neighbour-vector table: ten settings of (degree,
entry points, ef, expand, iterations, kept, table type) on random-20k,
each with its QPS over 20 batches of 256, its recall@20 on the first and
the table's size.

The table ``[N, R, d]`` (bf16 or f32) holds each node's neighbour vectors
contiguously, so an iteration gathers ``[B, W]`` rows of ``[R, d]`` instead
of ``B W R`` scattered corpus rows; the final ``k + 8`` candidates are
rescored against the f32 corpus. It bears on ``ops/graph.
build_neighbor_table`` and the beam's gather.

The counterpart of the JAX package's ``scripts/exp_beam_table_tune.py``:
the same module constants (``N``, ``D``, ``K``, ``B``, ``REPEATS``),
settings (``CONFIGS``), inputs (NumPy seed 42), graphs, entry points
(``ops/graph.pick_entry_points``, whose k-means runs kernel K3) and printed
lines, then one ``check`` line (``scripts/probes.print_check``) with every
setting's recall and QPS and the best recall. :func:`beam_nt` copies the
JAX script's beam: bf16 table values multiply the bf16-rounded query in
f32. ``approx_max_k`` is ``top_k_smallest``. Timing as ``exp_beam_tune``
(``scripts/probes.timed_batches``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_beam_table_tune [--device cpu]

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
    BEAM_PASS_QPS,
    BEAM_PASS_RECALL,
    beam_inputs,
    print_check,
    set_recall,
    timed_batches,
)
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

N, D, K = 20_000, 64, 20
B, REPEATS = 256, 20
# (degree, n_entry, ef, W, iters, keep, table dtype)
CONFIGS = (
    (64, 2048, 128, 24, 3, 96, torch.bfloat16),
    (64, 2048, 128, 24, 2, 96, torch.bfloat16),
    (64, 2048, 128, 16, 3, 96, torch.bfloat16),
    (64, 4096, 128, 16, 2, 96, torch.bfloat16),
    (64, 2048, 128, 24, 3, 96, torch.float32),
    (32, 2048, 128, 48, 3, 96, torch.bfloat16),
    (32, 1024, 128, 32, 4, 64, torch.bfloat16),
    (64, 2048, 96, 16, 3, 64, torch.bfloat16),
    (64, 4096, 128, 24, 2, 96, torch.bfloat16),
    (64, 4096, 128, 24, 3, 96, torch.bfloat16),
)


def beam_nt(queries, nbr_vecs, nbr_sqn, adjacency, entry_ids, entry_vecs, entry_sqn, vectors,
            k, ef, expand, iters, keep):
    """The JAX script's table beam: ``(dists [B, k], ids [B, k])``, the
    final ``k + 8`` candidates rescored against the f32 corpus."""
    b = queries.shape[0]
    r = adjacency.shape[1]
    e = entry_ids.shape[0]
    big = float("inf")
    qn = torch.sum(queries * queries, dim=-1)

    seed_dots = queries.to(entry_vecs.dtype) @ entry_vecs.T
    seed_d = qn[:, None] + entry_sqn[None, :] - 2.0 * seed_dots
    seed_d = torch.where(entry_ids[None, :] >= 0, seed_d, big)
    seed_ids = entry_ids[None, :].expand(b, e)
    beam_d, sel0 = top_k_smallest(seed_d, ef)
    beam_ids = torch.gather(seed_ids, 1, sel0)
    beam_exp = torch.zeros((b, ef), dtype=torch.bool, device=queries.device)
    q_cast = queries.to(nbr_vecs.dtype).float()

    for _ in range(iters):
        sel_d = torch.where(beam_exp | (beam_ids < 0), big, beam_d)
        _, sel = top_k_smallest(sel_d, expand)
        sel_ids = torch.gather(beam_ids, 1, sel)
        sel_valid = torch.isfinite(torch.gather(sel_d, 1, sel))
        beam_exp = beam_exp.scatter(1, sel, True)
        safe_sel = sel_ids.clamp(min=0)
        neigh = adjacency[safe_sel]  # [B, W, R]
        nvec = nbr_vecs[safe_sel].float()  # [B, W, R, d] one block gather
        nsqn = nbr_sqn[safe_sel]
        dots = torch.einsum("bwrd,bd->bwr", nvec, q_cast)
        nd = (qn[:, None, None] + nsqn - 2.0 * dots).reshape(b, expand * r)
        neigh = torch.where(sel_valid[:, :, None] & (neigh >= 0), neigh, -1).reshape(b, expand * r)
        nd = torch.where(neigh >= 0, nd, big)
        nd = torch.where(gops._member(neigh, beam_ids), big, nd)
        cand_d, cpos = top_k_smallest(nd, keep)
        cand_ids = torch.gather(neigh, 1, cpos)
        cand_d = torch.where(gops._earlier_equal(cand_ids) | (cand_ids < 0), big, cand_d)
        cat_ids = torch.cat([beam_ids, cand_ids], dim=1)
        cat_d = torch.cat([beam_d, cand_d], dim=1)
        cat_exp = torch.cat([beam_exp, torch.zeros_like(cand_ids, dtype=torch.bool)], dim=1)
        beam_d, pos = top_k_smallest(cat_d, ef)
        beam_ids = torch.gather(cat_ids, 1, pos)
        beam_exp = torch.gather(cat_exp, 1, pos)
        beam_ids = torch.where(torch.isfinite(beam_d), beam_ids, -1)
    # final: the top k + 8, rescored exactly in f32
    kk = min(k + 8, ef)
    _, pos = top_k_smallest(beam_d, kk)
    fids = torch.gather(beam_ids, 1, pos)
    diff = vectors[fids.clamp(min=0)] - queries[:, None, :]
    fd = torch.where(fids >= 0, torch.sum(diff * diff, dim=-1), big)
    out_d, opos = top_k_smallest(fd, k)
    return out_d, torch.gather(fids, 1, opos)


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
    sqn = dops.sq_norms(x)
    acache, ecache, rows = {}, {}, {}
    for r_, ne, ef, w, it, ck, dt in CONFIGS:
        if r_ not in acache:
            print(f"building degree-{r_} graph...")
            acache[r_] = gops.build_knn_graph(x, r_).long()
        if ne not in ecache:
            ecache[ne] = gops.pick_entry_points(x, ne, seed=42).long()
        adjacency, entries = acache[r_], ecache[ne]
        safe_adj = adjacency.clamp(min=0)
        nbr_vecs = x.to(dt)[safe_adj]
        nbr_sqn = sqn[safe_adj]
        safe_e = entries.clamp(min=0)
        evecs, esqn = x[safe_e], sqn[safe_e]
        mb = nbr_vecs.numel() * nbr_vecs.element_size() / 1e6
        ids, el = timed_batches(
            lambda qb: beam_nt(qb, nbr_vecs, nbr_sqn, adjacency, entries, evecs, esqn, x,
                               K, ef, w, it, ck), queries_r, device)
        qps = B * REPEATS / el
        rec = set_recall(ids, gt)
        flag = " <== PASS" if (qps > BEAM_PASS_QPS and rec >= BEAM_PASS_RECALL) else ""
        label = (f"R={r_:2d} E={ne:4d} ef={ef:3d} W={w:2d} it={it} keep={ck:3d} "
                 f"{str(dt).split('.')[-1]:8s}")
        print(f"{label} table={mb:5.0f}MB: {qps:8.0f} QPS recall={rec:.4f}{flag}")
        rows[label.rstrip()] = {"qps": qps, "recall": rec, "table_mb": mb}
    print_check(rows=rows, best_recall=max(r["recall"] for r in rows.values()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
