"""``pq_rotations='auto'`` A/B and its decision threshold: rotations must
buy recall where per-list anisotropy exists, and the rule says when the
roster turns them on.

Two regimes, same reference algorithm config (IVF256,PQ64 nprobe 48 —
reference configs/benchmark_config.yaml grammar):

  manifold           per-list ORIENTED low-rank patches
                     (data/datasets._load_manifold) — the structure real
                     MiniLM embeddings carry and gaussian mixtures lack;
                     rotations must buy recall here.
  msmarco_surrogate  shared-frame gaussian mixture (the shipped roster
                     surrogate).

For each regime the tool builds plain / ``pq_rotations='auto'`` /
``pq_rotations=<bs>`` artifacts on ``--device``, reports end-to-end
recall@k, build seconds and the held-out reconstruction gain that drives
the auto decision (``ops/pq.rotation_gain``, recorded in the artifact's
``metadata['pq_rot_auto']``), and emits one JSON document (also written
to ``--out``). The counterpart of the JAX package's
``scripts/exp_manifold_rotations.py``: the same arguments, regimes, notes
and document; the committed record is
``benchmark_results/round5_rotations_ab/rotations_ab.json``.

The decision rule under test (``models/factory.FactoryIndexer``):
    enable rotations  iff  held-out residual-MSE gain >= PQ_ROT_AUTO_GAIN
measured at build time on the quantizer training sample — no search, no
labels, no extra data needed.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_manifold_rotations \
        [--n 100000] [--index-key IVF256,PQ64] [--out rotations_ab.json] \
        [--data-dir data] [--device cpu]

``--device`` defaults to the CUDA card and fails without one. Each corpus
is cached under ``--data-dir``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.scripts.calibration import factory_recall
from vectordb_retrieval_tpu_torch.utils.device import resolve_device


def regimes(n: int, queries: int, k: int) -> list:
    """(dataset name, loader options, expectation note) of each regime."""
    return [
        (
            "manifold",
            {
                "dim": 384,
                "train_limit": n,
                "test_size": queries,
                "ground_truth_k": k,
                "n_patches": 256,
                "intrinsic_dim": 12,
                "point_scale": 0.5,
            },
            "per-list oriented frames: rotations should WIN, auto ON",
        ),
        (
            "msmarco_surrogate",
            {
                "train_limit": n,
                "test_size": queries,
                "ground_truth_k": k,
            },
            # the JAX script's note, kept verbatim: its committed record
            # shows auto ON here (gain 0.2769 >= 0.05)
            "shared-frame gaussian mixture: rotations neutral, auto OFF",
        ),
    ]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--queries", type=int, default=256)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--nprobe", type=int, default=48)
    p.add_argument("--index-key", default="IVF256,PQ64")
    p.add_argument("--rot-bs", type=int, default=128)
    p.add_argument("--out", default="")
    p.add_argument("--data-dir", default="data")
    p.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    doc = {"args": vars(args), "regimes": {}}
    for name, opts, note in regimes(args.n, args.queries, args.k):
        ds = Dataset(name, data_dir=args.data_dir, options=dict(opts),
                     device=device).load()
        x, q = ds.train_vectors, ds.test_vectors
        gt = ds.ground_truth[:, : args.k]
        rows = {}
        for variant, rot in (
            ("plain", 0),
            ("auto", "auto"),
            (f"rot{args.rot_bs}", args.rot_bs),
        ):
            recall, art, build_s, _ = factory_recall(
                x, q, gt, args.index_key, args.k, device, nprobe=args.nprobe,
                pq_rotations=rot,
            )
            rows[variant] = {
                "recall": round(recall, 4),
                "build_s": round(build_s, 1),
                "pq_rot_auto": art.metadata.get("pq_rot_auto"),
                "rot_enabled": "list_rotations" in art.data,
            }
            print(name, variant, json.dumps(rows[variant]), flush=True)
        doc["regimes"][name] = {"note": note, "rows": rows}

    print(json.dumps(doc))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
        print("written", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
