"""LSH recall/QPS tradeoff frontier on the 1M SIFT-shaped surrogate.

Every roster LSH row reads recall ~1.0 (the rerank multiplier and the exact
fallback make small-N LSH effectively exact), so the tradeoff the
reference's LSH story centres on (tuned recall 0.32-0.51, reference
src/algorithms/lsh.py:31-39 guarantee docstring) shows nowhere else. This
sweeps tables x hash_size x candidate_multiplier at 1M rows, where LSH
genuinely trades recall for probe work, and prints one frontier row per
setting with the sign-LSH / E2LSH collision-probability guarantee quoted
at the measured kth-NN difficulty.

Guarantee (reference lsh.py:31-39): for sign-LSH the per-table collision
probability of rows at angle theta is (1 - theta/pi)^hash_size; across T
independent tables P(candidate) = 1 - (1 - p)^T. For E2LSH with bucket
width w, p = collision prob of the floor-hash at distance r.

The counterpart of the JAX package's ``scripts/exp_lsh_frontier.py``: the
same settings, options, printed lines and table; its record (the JAX
package on a TPU) is ``benchmark_results/round3_lsh_frontier/README.md``.
Two differences. Timing: the JAX script times a ``lax.scan`` of the
repeats inside one ``jit``; here each setting calls the searcher's
``device_kernel`` once untimed, then ``--repeats`` times on the device,
synchronises and copies the last ids to the host once, inside the clock
(``bench/experiment._timed_search``'s protocol). Projections: the port
draws them from a seeded ``torch.Generator`` (``ops/lsh``), the JAX package
from ``jax.random``, so the recalls agree within ~0.02, not bit for bit.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_lsh_frontier \
        [--limit 1000000] [--queries 256] [--k 100] [--repeats 8] \
        [--data-dir data] [--device cpu]

Reads ``<data-dir>/sift1m_synth/sift_base.fvecs`` and ``sift_query.fvecs``,
which ``scripts.make_sift1m_surrogate`` writes. ``--device`` defaults to
the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
from vectordb_retrieval_tpu_torch.data.datasets import read_fvecs
from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.scripts.probes import timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

# Long hashes / few tables = few collisions (fast, lossy); short hashes /
# many tables = dense collisions (slow, high recall). Sign-LSH (cosine) is
# the reference's guarantee story (lsh.py:31-39); the E2LSH rows exercise
# the floor-hash family at a data-scaled bucket width (w ~ r and 2r).
SETTINGS = [
    dict(metric="cosine", num_tables=2, hash_size=18, candidate_multiplier=4.0),
    dict(metric="cosine", num_tables=4, hash_size=16, candidate_multiplier=4.0),
    dict(metric="cosine", num_tables=8, hash_size=16, candidate_multiplier=8.0),
    dict(metric="cosine", num_tables=8, hash_size=14, candidate_multiplier=8.0),
    dict(metric="cosine", num_tables=12, hash_size=14, candidate_multiplier=16.0),
    dict(metric="cosine", num_tables=12, hash_size=12, candidate_multiplier=16.0),
    dict(metric="cosine", num_tables=16, hash_size=12, candidate_multiplier=32.0),
    dict(metric="cosine", num_tables=24, hash_size=10, candidate_multiplier=32.0),
    dict(metric="cosine", num_tables=32, hash_size=8, candidate_multiplier=64.0),
    dict(metric="l2", num_tables=4, hash_size=6, width_r=1.0, candidate_multiplier=8.0),
    dict(metric="l2", num_tables=8, hash_size=6, width_r=1.0, candidate_multiplier=16.0),
    dict(metric="l2", num_tables=8, hash_size=8, width_r=2.0, candidate_multiplier=16.0),
    dict(metric="l2", num_tables=12, hash_size=8, width_r=2.0, candidate_multiplier=32.0),
]


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.vectorize(math.erf)(np.asarray(z) / math.sqrt(2.0)))


def sign_guarantee(num_tables: int, hash_size: int, theta_deg: float) -> float:
    """P(two rows at angle theta collide in >=1 of T sign-LSH tables)
    (reference lsh.py:31-39: p1 = (1 - theta/pi)^hash_size)."""
    p1 = (1.0 - np.deg2rad(theta_deg) / np.pi) ** hash_size
    return float(1.0 - (1.0 - p1) ** num_tables)


def e2lsh_guarantee(num_tables: int, hash_size: int, width: float, r: float) -> float:
    """P(collision in >=1 table) for E2LSH floor-hash at distance r.

    Per-hash (Datar et al. 2004): with u = w/r,
    p = 1 - 2*Phi(-u) - 2/(sqrt(2*pi)*u) * (1 - exp(-u^2/2)).
    """
    u = width / max(r, 1e-9)
    p = (1.0 - 2.0 * float(_norm_cdf(-u))
         - 2.0 / (np.sqrt(2 * np.pi) * u) * (1.0 - np.exp(-u * u / 2.0)))
    p1 = max(p, 0.0) ** hash_size
    return float(1.0 - (1.0 - p1) ** num_tables)


def kth_nn_difficulty(gt_l2_d: np.ndarray, gt_cos_d: np.ndarray) -> Tuple[float, float]:
    """``(median kth-NN angle in degrees, median kth-NN l2 distance)`` of
    the queries, from the l2 ground truth's squared distances and the
    normalised rows' ``ip`` ground truth (negated dots). The guarantee is
    quoted at the HARDEST in-set neighbour, the one recall@k needs."""
    med_cos = float(np.median(np.clip(-gt_cos_d[:, -1], -1.0, 1.0)))
    return float(np.degrees(np.arccos(med_cos))), float(np.sqrt(np.median(gt_l2_d[:, -1])))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--limit", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    sift = os.path.join(args.data_dir, "sift1m_synth")
    x = read_fvecs(os.path.join(sift, "sift_base.fvecs"), limit=args.limit)
    q = read_fvecs(os.path.join(sift, "sift_query.fvecs"), limit=args.queries)
    xd = torch.as_tensor(x, device=device)
    qd = torch.as_tensor(q, device=device)
    gt_l2_d, gt_l2 = (v.cpu().numpy() for v in dops.exact_search(qd, xd, args.k, device=device))
    xn, qn = dops.normalize(xd), dops.normalize(qd)
    gt_cos_d, gt_cos = (v.cpu().numpy()
                        for v in dops.exact_search(qn, xn, args.k, metric="ip", device=device))
    del xd, xn
    theta_deg, med_r = kth_nn_difficulty(gt_l2_d, gt_cos_d)
    print(f"corpus {x.shape} queries {q.shape} k={args.k} "
          f"median kth-NN angle={theta_deg:.1f}deg l2 r={med_r:.1f}",
          flush=True)

    rows = []
    for s in SETTINGS:
        metric = s["metric"]
        width = s.get("width_r", 1.0) * med_r
        algo = CompositeAlgorithm(
            dimension=x.shape[1],
            indexer={
                "type": "LSHIndexer", "metric": metric,
                "num_tables": s["num_tables"], "hash_size": s["hash_size"],
                "bucket_width": width, "seed": 42,
            },
            searcher={
                "type": "LSHSearcher", "metric": metric,
                "candidate_multiplier": s["candidate_multiplier"],
                "fallback_to_bruteforce": False,  # the tradeoff, not exact
            },
            metric=metric,
            device=device,
        )
        t0 = time.time()
        algo.build_index(x)
        bt = time.time() - t0
        ids, el = timed_passes(lambda qb: algo.device_kernel(qb, args.k), qd,
                               args.repeats, device)
        qps = args.queries * args.repeats / el
        rec = recall_at_k(gt_cos if metric == "cosine" else gt_l2, ids, args.k)
        if metric == "cosine":
            g = sign_guarantee(s["num_tables"], s["hash_size"], theta_deg)
        else:
            g = e2lsh_guarantee(s["num_tables"], s["hash_size"], width, med_r)
        row = {**s, "recall": round(float(rec), 4), "qps": round(qps, 1),
               "build_s": round(bt, 1), "p_collide_kthNN": round(g, 4)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(f"\n(P(collide) quoted at the measured kth-NN difficulty: "
          f"theta={theta_deg:.1f}deg / r={med_r:.1f})")
    print("| family | tables | bits | mult | P(collide,kthNN) "
          "| recall | QPS |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        fam = "sign" if r["metric"] == "cosine" else "e2lsh"
        print(f"| {fam} | {r['num_tables']} | {r['hash_size']} | "
              f"{r['candidate_multiplier']} | {r['p_collide_kthNN']} | "
              f"{r['recall']} | {r['qps']} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
