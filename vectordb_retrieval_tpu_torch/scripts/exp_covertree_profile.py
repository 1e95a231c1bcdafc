"""Profile the cover-tree stream walk at the msmarco roster shape.

Questions: what does the tree look like (node count, depth sizes)? What
does one walk of the batch cost at each fold width ``kprime`` of the
running kth upper bound, and how many nodes does it score? Is its result
exact? It bears on ``ops/covertree.covertree_stream_search``.

The counterpart of the JAX package's ``scripts/exp_covertree_profile.py``:
the same options (``--device`` for ``--platform``, plus ``--data-dir`` for
the loader's cache), dataset options and printed lines, then one ``check``
line (``scripts/probes.print_check``): recall against the dataset's ground
truth and the largest difference from the exact scan, absolute and
relative to the largest exact distance. As in the JAX script, the
msmarco_surrogate's options set only ``n_train``, so the loader keeps its
default 200 queries of the 512 asked for. The walk is timed as the JAX
script times it: one untimed call, then one call, its result copied to
the host inside the clock (``scripts/probes.timed_passes`` with one pass).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_covertree_profile \\
        [--n 100000] [--queries 512] [--k 20] [--dataset msmarco_surrogate] \\
        [--subdir DIR] [--data-dir data] [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.models.covertree import CoverTree
from vectordb_retrieval_tpu_torch.ops import covertree as ctops
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--dataset", default="msmarco_surrogate")
    ap.add_argument("--subdir", default=None)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    opts = {"n_train": args.n}
    if args.subdir:
        opts["subdir"] = args.subdir
        opts["test_size"] = args.queries
        opts["ground_truth_k"] = args.k
    ds = Dataset(args.dataset, data_dir=args.data_dir, options=opts, device=device).load()
    x = np.asarray(ds.train_vectors[: args.n], np.float32)
    q = np.asarray(ds.test_vectors[: args.queries], np.float32)
    print(f"dataset {args.dataset}: corpus {x.shape} queries {q.shape} "
          f"metric {ds.metric}")

    model = CoverTree(dimension=x.shape[1], metric=ds.metric, device=device)
    t0 = time.time()
    model.build_index(x)
    print(f"build: {time.time() - t0:.1f} s")

    meta = model.artifact.metadata
    data = model.artifact.data
    m = meta["n_nodes"]
    print(f"nodes M={m} (N={args.n}, virtual={m - args.n})")
    print("depth sizes:", meta["depth_sizes"])

    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12) \
        if ds.metric == "cosine" else q
    qj = torch.as_tensor(qn, device=device)
    nq = q.shape[0]

    for kprime in (args.k + 12, 2 * args.k, args.k + 64, args.k + 236):
        walk = {}

        def run(qb, kprime=kprime, walk=walk):
            walk["res"] = ctops.covertree_stream_search(
                qb, data["slab"], data["point_ids"], data["is_real"],
                data["radii"], data["parent_rel"],
                depth_sizes=tuple(meta["depth_sizes"]),
                k=args.k, kprime=kprime,
            )
            return walk["res"].ids

        _, dt = timed_passes(run, qj, 1, device)
        res = walk["res"]
        print(f"stream kprime={kprime:4d}: {dt*1e3:8.1f} ms "
              f"({nq/dt:8.1f} QPS)  depths={int(res.iters)} "
              f"ndis/query={res.ndis.double().mean():.0f} "
              f"overflow={int(res.overflow.sum())}")

    # recall sanity vs ground truth at k
    ids = res.ids.cpu().numpy()
    gt = np.asarray(ds.ground_truth[:nq, : args.k])
    hits = np.mean([
        len(set(ids[i].tolist()) & set(gt[i].tolist())) / args.k
        for i in range(nq)
    ])
    print(f"recall@{args.k} vs dataset GT: {hits:.4f}")

    # distance-level exactness vs the exact scan (tie-proof check)
    vectors = data["slab"][data["row_pos"].long()]
    fd, _ = dops.exact_search(qj, vectors, args.k, metric="l2", refine=True, device=device)
    ed = np.sqrt(np.maximum(fd.cpu().numpy(), 0.0))
    err = np.abs(np.sort(res.dists.cpu().numpy(), 1) - np.sort(ed, 1))
    print(f"max |stream_d - exact_d| over top-{args.k}: {err.max():.2e}")
    print_check(recall=float(hits), max_abs_diff=float(err.max()),
                max_rel_diff=float(err.max() / max(float(ed.max()), 1e-30)),
                overflow=int(res.overflow.sum()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
