"""The node beam's knobs on random-20k: ten (degree, entry points, ef,
expand, iterations, candidates kept) settings through ``ops/graph.
graph_search``, each with its QPS over 20 batches of 256 and its
recall@20 on the first. A setting passes where it beats 23,886 QPS at
recall@20 >= 0.9156 (``BASELINE.md``'s random row, the FAISS CPU
reference). It bears on ``models/graph.py``'s ``beam_geometry``.

The counterpart of the JAX package's ``scripts/exp_beam_tune.py``: the
same module constants (``N``, ``D``, ``K``, ``B``, ``REPEATS``, ``R``),
settings (``CONFIGS``), inputs (NumPy seed 42), graphs (``ops/graph.
build_knn_graph``), entry points (``ops/graph.pick_entry_points``, whose
k-means runs kernel K3) and printed lines, then one ``check`` line
(``scripts/probes.print_check``) with every setting's recall and QPS and
the best recall. Timing: the JAX script scans the batches in one ``jit``;
here one untimed stream, then one timed stream ending in one synchronise
and one copy of the first batch's ids to the host (``scripts/probes.
timed_batches``); the host issues each iteration's operations.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_beam_tune [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import graph as gops
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
B = 256
REPEATS = 20
R = 32
# (degree, n_entry, ef, W, iters, cand_keep)
CONFIGS = (
    (32, 312, 128, 32, 5, 64),
    (32, 1024, 128, 32, 4, 64),
    (32, 2048, 128, 48, 3, 96),
    (48, 1024, 128, 24, 3, 64),
    (48, 1024, 128, 24, 4, 64),
    (48, 2048, 128, 32, 3, 96),
    (64, 1024, 128, 16, 3, 64),
    (64, 1024, 128, 24, 3, 96),
    (64, 2048, 128, 24, 2, 96),
    (64, 2048, 128, 24, 3, 96),
)


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
    for r_, ne, ef, w, it, ck in CONFIGS:
        if r_ not in acache:
            print(f"building degree-{r_} graph...")
            acache[r_] = gops.build_knn_graph(x, r_)
        if ne not in ecache:
            ecache[ne] = gops.pick_entry_points(x, ne, seed=42)
        adjacency, entries = acache[r_], ecache[ne]
        ids, el = timed_batches(
            lambda qb: gops.graph_search(qb, x, adjacency, entries, K, ef=ef, expand=w,
                                         iters=it, metric="l2", sqnorms=sqn, cand_keep=ck),
            queries_r, device)
        qps = B * REPEATS / el
        rec = set_recall(ids, gt)
        flag = " <== PASS" if (qps > BEAM_PASS_QPS and rec >= BEAM_PASS_RECALL) else ""
        label = f"R={r_:2d} E={ne:4d} ef={ef:3d} W={w:2d} it={it:2d} keep={ck:3d}"
        print(f"{label}: {qps:8.0f} QPS  recall@{K}={rec:.4f}{flag}")
        rows[label] = {"qps": qps, "recall": rec}
    print_check(rows=rows, best_recall=max(r["recall"] for r in rows.values()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
