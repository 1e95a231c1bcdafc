"""Diagnose the node-mode recall ceiling on the glove-shaped surrogate.

The JAX package's round-3 committed row read hnsw glove50 0.9602 against
the reference's 0.9750, the one recall column still below the reference.
The reverse-edge pass (``ops/graph.add_reverse_edges``) keeps only the
nearest ``rev`` INCOMING edges per node, so a boundary row whose forward
edges all point at popular hubs can lose every backlink and become
unreachable by any beam.

Measures, for each build variant: (a) the in-degree-zero count of the
concatenated adjacency, (b) recall at the committed geometry (ef 125,
iters 3), (c) recall at saturation (ef 512, iters 12), which isolates
reachability from budget. The counterpart of the JAX package's
``scripts/exp_glove_ceiling.py``: the same variants and printed lines. Its
``forced-backlink`` variant exists in neither package; both print that it
was skipped.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_glove_ceiling \
        [--k 20] [--data-dir data] [--device cpu]

``--device`` defaults to the CUDA card and fails without one. The corpus is
cached under ``--data-dir``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from vectordb_retrieval_tpu_torch.scripts.probes import GloveBeam
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

M = GloveBeam.M
# label -> incoming-link slots of the build (None: a variant not built)
VARIANTS = {
    "rev=M (committed)": M,
    "rev=2M": 2 * M,
    "rev=M forced-backlink": None,
}


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
    n = beam.x.shape[0]

    for label, rev in VARIANTS.items():
        if rev is None:
            print(f"{label}: (not implemented yet — skipped)")
            continue
        adj = beam.graph(rev)
        adj_np = adj.cpu().numpy()
        present = np.zeros(n, dtype=bool)
        flat = adj_np.reshape(-1)
        present[flat[flat >= 0]] = True
        n_unreach = int((~present).sum())
        r_comm = beam.recall(beam.search(adj, ef=125, iters=3))
        r_sat = beam.recall(beam.search(adj, ef=512, iters=12))
        print(
            f"{label:24s} deg={adj_np.shape[1]:3d} in-deg-0={n_unreach:5d}"
            f"  recall(ef125,it3)={r_comm:.4f}  recall(ef512,it12)={r_sat:.4f}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
