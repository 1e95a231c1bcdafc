"""Calibrate the ``manifold`` dataset (``data/datasets._load_manifold``)
against the reference's REAL-msmarco pq/ivf_pq pair — the inequality the
gaussian-mixture surrogates provably cannot reproduce:

    reference msmarco (real MiniLM 100k x 384d, topk=20):
        pq     0.7757   (benchmark_20260305_070532/benchmark_summary.md:48)
        ivf_pq 0.6986   (:46)

Sweeps the loader's structure knobs at the reference algorithm configs
(PQ64; IVF256,PQ64 nprobe=48 — reference benchmark_config.yaml grammar) on
``--device`` and prints one JSON line a setting: its options, ``pq``,
``ivf_pq`` (recall@k), each row's build + search seconds, ``gap`` and
``refdist``. The counterpart of the JAX package's
``scripts/calibrate_manifold.py``: the same arguments, default grid and
lines. Each corpus is cached under ``--data-dir``.

    python -m vectordb_retrieval_tpu_torch.scripts.calibrate_manifold \
        [--n 100000] [--queries 256] [--k 20] [--grid JSON] \
        [--data-dir data] [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import Dict, List, Optional

from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.scripts.calibration import factory_recall
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

REF = {"pq": 0.7757, "ivf_pq": 0.6986}

# default sweep: intrinsic dim x point_scale (the two difficulty axes);
# patch count fixed near the msmarco topic scale
GRID = {
    "intrinsic_dim": [8, 12, 16],
    "point_scale": [0.35, 0.5, 0.7],
}


def one(opts: Dict, n: int, queries: int, k: int, data_dir: str, device) -> Dict:
    """Recalls and seconds of the PQ64 and IVF256,PQ64 rows on one
    manifold corpus (100k-row defaults overridden by ``opts``)."""
    ds = Dataset(
        "manifold",
        data_dir=data_dir,
        options={
            "dim": 384,
            "train_limit": n,
            "test_size": queries,
            "ground_truth_k": k,
            "n_patches": 256,
            **opts,
        },
        device=device,
    ).load()
    x, q = ds.train_vectors, ds.test_vectors
    gt = ds.ground_truth[:, :k]
    out = {}
    for name, key, nprobe in (
        ("pq", "PQ64", None),
        ("ivf_pq", "IVF256,PQ64", 48),
    ):
        recall, _, _, seconds = factory_recall(x, q, gt, key, k, device, nprobe=nprobe)
        out[name] = round(recall, 4)
        out[f"{name}_s"] = round(seconds, 1)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--queries", type=int, default=256)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--grid", default="")
    p.add_argument("--data-dir", default="data")
    p.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = p.parse_args(argv)
    grid = json.loads(args.grid) if args.grid else GRID
    device = resolve_device(args.device)

    keys = list(grid)
    for combo in itertools.product(*(grid[k] for k in keys)):
        opts = dict(zip(keys, combo))
        r = one(opts, args.n, args.queries, args.k, args.data_dir, device)
        gap = r["pq"] - r["ivf_pq"]
        err = abs(r["pq"] - REF["pq"]) + abs(r["ivf_pq"] - REF["ivf_pq"])
        print(
            json.dumps({"opts": opts, **r, "gap": round(gap, 4),
                        "refdist": round(err, 4)}),
            flush=True,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
