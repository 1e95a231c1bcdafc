"""Geometry sweep for the node-mode beam on the glove surrogate.

Follow-up to ``exp_glove_ceiling``: the JAX package's committed 0.9602 row
was a BUDGET artifact (recall 0.995 at saturation, in-degree-0 = 0), not a
graph hole. Sweeps (reverse_edges, ef, iters), 18 points, to find the
cheapest point >= the reference's 0.9750; the sweep set the shipped
``reverse_edges`` = 2M and the beam's 4 base iterations
(``models/graph.py``). The counterpart of the JAX package's
``scripts/exp_glove_geometry.py``: the same points and printed lines
(``rows/q``, the scored rows a query, ~ expand x degree x iters, is a
relative cost proxy; ``wall`` is the host clock of one search, the ids on
the host).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_glove_geometry \
        [--k 20] [--data-dir data] [--device cpu]

``--device`` defaults to the CUDA card and fails without one. The corpus is
cached under ``--data-dir``.
"""

from __future__ import annotations

import argparse
import itertools
import time
from typing import List, Optional

from vectordb_retrieval_tpu_torch.scripts.probes import GloveBeam
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

M = GloveBeam.M
REVS = (M, 2 * M)
EFS = (125, 160, 200)
ITERS = (3, 4, 5)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    beam = GloveBeam(args.k, args.data_dir, resolve_device(args.device))
    adjs = {rev: beam.graph(rev) for rev in REVS}
    for rev, ef, iters in itertools.product(REVS, EFS, ITERS):
        adj = adjs[rev]
        degree = adj.shape[1]
        expand = min(max(8, 1536 // degree), ef)
        t0 = time.time()
        r = beam.recall(beam.search(adj, ef=ef, iters=iters, expand=expand))
        rows = expand * degree * iters
        print(
            f"rev={rev:2d} ef={ef:3d} it={iters}  recall={r:.4f}"
            f"  rows/q~{rows:6d}  wall={time.time()-t0:5.1f}s"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
