"""Structure-sensitivity probe: can per-cluster ORIENTED low-rank scatter
reproduce the reference's pq > ivf_pq inequality, and do per-list
rotations recover it?

Hypothesis: real MiniLM embeddings concentrate near a global low-dim
manifold whose local tangent ORIENTATION varies by topic. Global PQ codes
absolute positions (it sees the global low-rank concentration: easy);
residual IVF-PQ codes per-list scatter with ONE shared codebook (it sees
mixed orientations: hard). Every energy-preserving gaussian-mixture knob
moves the two together (``scripts.calibrate_msmarco_surrogate``'s grid);
orientation heterogeneity is the axis none of them had. The regimes it
measures are what ``models/factory.FactoryIndexer.PQ_ROT_AUTO_GAIN``
separates.

Reference targets (benchmark_20260305_070532/benchmark_summary.md:46-48,
real MiniLM 100k x 384d): pq 0.7757 > ivf_pq 0.6986.

The counterpart of the JAX package's ``scripts/exp_manifold_structure.py``:
the same options, the same generator call for call (NumPy, seed 7: the
corpus and queries are bit-identical), the same rows (``PQ64``,
``IVF256,PQ64`` nprobe 48, ``IVF256,SQ8`` nprobe 48, ``IVF100,Flat``
nprobe 10, and ``IVF256,PQ64`` with ``pq_rotations=<--rot-bs>`` where it
is set) and printed lines. The JAX script does its work when imported;
this module does it in :func:`main`.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_manifold_structure \
        [--n 100000] [--d 384] [--rank 16] [--orient 1.0] [--global-rank 48] \
        [--clusters 512] [--queries 256] [--k 20] [--rot-bs 0] \
        [--center-scale 2.0] [--point-scale 0.55] [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Tuple

import numpy as np

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.scripts.calibration import factory_recall
from vectordb_retrieval_tpu_torch.utils.device import resolve_device


def make_corpus(args: argparse.Namespace) -> Tuple[np.ndarray, np.ndarray]:
    """``(x [n, d], q [queries, d])`` f32: a global low-rank manifold with
    per-cluster oriented tangents (the JAX script's generator)."""
    rng = np.random.default_rng(7)
    n, d, r = args.n, args.d, args.rank
    C = args.clusters

    # global manifold frame [d, global_rank]
    gq, _ = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float64))
    G = gq[:, : args.global_rank].astype(np.float32)
    centers = (
        rng.standard_normal((C, args.global_rank)).astype(np.float32)
        * args.center_scale
    ) @ G.T

    # per-cluster tangent frames: rank-r, interpolated between a SHARED
    # frame (orient=0) and fully random per-cluster frames (orient=1);
    # spectrum decays inside the tangent
    spec = (np.arange(1, r + 1, dtype=np.float32)) ** -0.5
    spec /= np.sqrt(np.mean(spec**2))
    shared = gq[:, : r].astype(np.float32)
    frames = np.empty((C, d, r), np.float32)
    for c in range(C):
        fq, _ = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float64))
        mix = (1.0 - args.orient) * shared + args.orient * fq[:, :r].astype(np.float32)
        mq, _ = np.linalg.qr(mix.astype(np.float64))
        frames[c] = mq[:, :r].astype(np.float32)

    assign = rng.integers(0, C, size=n)
    z = rng.standard_normal((n, r)).astype(np.float32) * spec * args.point_scale
    x = centers[assign] + np.einsum("ndr,nr->nd", frames[assign], z)
    x = np.ascontiguousarray(x, dtype=np.float32)

    qi = rng.choice(n, args.queries, replace=False)
    zq = (
        rng.standard_normal((args.queries, r)).astype(np.float32)
        * spec * 1.3 * args.point_scale
    )
    q = centers[assign[qi]] + np.einsum("ndr,nr->nd", frames[assign[qi]], zq)
    return x, np.ascontiguousarray(q, dtype=np.float32)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--d", type=int, default=384)
    p.add_argument("--rank", type=int, default=16, help="local tangent rank")
    p.add_argument("--orient", type=float, default=1.0,
                   help="0 = shared frame, 1 = fully per-cluster orientation")
    p.add_argument("--global-rank", type=int, default=48,
                   help="rank of the parent/manifold subspace")
    p.add_argument("--clusters", type=int, default=512)
    p.add_argument("--queries", type=int, default=256)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--rot-bs", type=int, default=0,
                   help="also run ivf_pq with pq_rotations=<bs>")
    p.add_argument("--center-scale", type=float, default=2.0,
                   help="cluster-center spread inside the global manifold")
    p.add_argument("--point-scale", type=float, default=0.55,
                   help="within-cluster tangent scatter")
    p.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    x, q = make_corpus(args)
    _, gt_i = dops.exact_search(q, x, args.k, "l2", device=device)
    gt = gt_i.cpu().numpy()

    rows = {}

    def run(name, index_key, nprobe=None, **indexer_kw):
        rec, _, bt, _ = factory_recall(x, q, gt, index_key, args.k, device,
                                       nprobe=nprobe, **indexer_kw)
        rows[name] = {"recall": round(rec, 4), "build_s": round(bt, 1)}
        print(name, rows[name], flush=True)

    # reference msmarco configs (benchmark_config.yaml:36-72 grammar)
    run("pq64", "PQ64")
    run("ivf_pq", "IVF256,PQ64", nprobe=48)
    run("ivf_sq8", "IVF256,SQ8", nprobe=48)
    run("ivf_flat", "IVF100,Flat", nprobe=10)
    if args.rot_bs:
        run(f"ivf_pq_rot{args.rot_bs}", "IVF256,PQ64", nprobe=48, pq_rotations=args.rot_bs)

    print(json.dumps({"args": vars(args), "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
