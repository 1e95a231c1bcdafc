"""Cover-tree hard-regime (ndis ~ N) A/B: the node-level stream walk
against the block-granular walk (``ops/covertree.covertree_blockwalk_search``)
on the 384d msmarco surrogate, where the JAX package's round-3 stream
descent bottomed out far below the exact scan.

High-d cosine data prunes poorly (cover radii stay comparable to
inter-point distances for many depths), so the walk scores nearly every
node: the descent's value over the exact scan is ~zero and its OVERHEAD is
what shows. The stream walk pays several [B, W] f32 transients and a
per-chunk [B, kp] top-k per depth; the block walk pays one fused K1 pair
launch (``dist_blockmin_pair``: two pens over the slab) and [B, M/w] block
arrays. This A/B is behind ``descent="auto"`` (``models/covertree.py``).

The counterpart of the JAX package's ``scripts/exp_covertree_hard.py``:
the same options, printed lines and ``--out`` document (its record, the
JAX package on a TPU: ``benchmark_results/round5_covertree_hard/ab.json``).
A descent that raises prints ``<descent>: FAILED ...`` and the tool goes on
to the next, as the JAX script does. Timing: the JAX script times a
``lax.scan`` of ``--iters`` passes inside one ``jit``; here the model's
``device_kernel`` runs once untimed, then ``--iters`` times on the device,
with one synchronise and one copy of the last ids to the host inside the
clock (``bench/experiment._timed_search``'s protocol). Recall is held to the
loader's exact ground truth.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_covertree_hard \
        [--k 20] [--iters 16] [--b 256] [--n 100000] \
        [--descents blockwalk,stream] [--out ab.json] [--data-dir data] \
        [--device cpu]

``--device`` defaults to the CUDA card and fails without one. The corpus is
cached under ``--data-dir``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import List, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.models.covertree import CoverTree
from vectordb_retrieval_tpu_torch.scripts.probes import timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--descents", default="blockwalk,stream")
    ap.add_argument("--out", default="")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds = Dataset(
        "msmarco_surrogate", data_dir=args.data_dir,
        options={"train_limit": args.n, "test_size": args.b,
                 "ground_truth_k": args.k},
        device=device,
    ).load()
    x = np.asarray(ds.train_vectors)
    q = np.asarray(ds.test_vectors[: args.b], np.float32)
    gt = np.asarray(ds.ground_truth[: args.b, : args.k])

    algo = CoverTree(dimension=x.shape[1], metric="cosine", device=device)
    t0 = time.time()
    algo.build_index(x)
    build_s = time.time() - t0
    print(f"build {build_s:.1f}s nodes={algo.artifact.metadata['n_nodes']}", flush=True)

    # cosine: the device kernel is given normalised queries
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    qd = torch.as_tensor(qn, device=device)

    rows = {}
    for descent in args.descents.split(","):
        algo.descent = descent
        try:
            ids, dt = timed_passes(lambda qb: algo.device_kernel(qb, args.k), qd,
                                   args.iters, device)
        except Exception as e:  # noqa: BLE001 -- report the descent, try the next
            traceback.print_exc()
            print(f"{descent}: FAILED {type(e).__name__}: {e}", flush=True)
            continue
        qps = args.b * args.iters / dt
        rec = recall_at_k(gt, ids, args.k)
        print(f"{descent}: {qps:,.0f} QPS  recall@{args.k} {rec:.4f}  "
              f"({dt*1e3/args.iters:.2f} ms/pass)", flush=True)
        rows[descent] = {"qps": qps, "recall": rec, "ms_per_pass": dt * 1e3 / args.iters}

    if args.out and rows:
        payload = {"dataset": f"msmarco_surrogate n={args.n} d={x.shape[1]}",
                   "k": args.k, "b": args.b, "iters": args.iters,
                   "build_s": build_s, "rows": rows}
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
