"""Matched-conditions QPS: the port's algorithms under the reference
system's own timing protocol.

The reference's committed QPS figures (BASELINE.md) come from
``time.time()`` around per-batch ``batch_search`` calls, batches of 128
and 256 queries in all (reference experiment_runner.py:430-464). This
script runs the port's algorithms with that protocol (the same datasets,
hyperparameters, batch size, query count and wall-clock formula), so a QPS
compared with the reference's published CPU rows shares its methodology.
``batch_search`` returns host arrays, so each batch's clock stops with its
ids on the host.

    python -m vectordb_retrieval_tpu_torch.scripts.matched_conditions \
        [--out results/matched_conditions_rows_torch.json] [--data-dir data] \
        [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device

# reference benchmark_config.yaml hyperparameters for the random/glove rows
ALGOS = {
    "exact": (
        {"type": "BruteForceIndexer"},
        {"type": "LinearSearcher"},
    ),
    "hnsw": (
        {"type": "GraphIndexer", "M": 16, "efConstruction": 200,
         "efSearch": 100},
        {"type": "ANNSearcher", "efSearch": 100},
    ),
    "ivf_flat": (
        {"type": "IVFIndexer", "index_type": "IVF100,Flat"},
        {"type": "ANNSearcher", "nprobe": 10},
    ),
    "ivf_pq": (
        {"type": "FactoryIndexer", "index_key": "IVF256,PQ{pqm}"},
        {"type": "ANNSearcher", "nprobe": 24},
    ),
    "ivf_sq8": (
        {"type": "FactoryIndexer", "index_key": "IVF256,SQ8"},
        {"type": "ANNSearcher", "nprobe": 24},
    ),
    "pq": (
        {"type": "FactoryIndexer", "index_key": "PQ{pqm}"},
        {"type": "ANNSearcher", "nprobe": 24},
    ),
}

DATASETS = {
    # name -> (dataset ctor args, pq m, reference QPS rows from BASELINE.md)
    "random": (
        {"name": "random", "options": {
            "dimensions": 64, "train_size": 20000, "test_size": 256,
            "ground_truth_k": 200, "seed": 7, "use_cache": False}},
        64,
        {"exact": 220.03, "hnsw": 23886, "ivf_flat": 111697,
         "ivf_pq": 43245, "ivf_sq8": 248897, "pq": 25606},
    ),
    "glove50_surrogate": (
        {"name": "glove50_surrogate", "options": {
            "train_limit": 20000, "test_size": 256, "ground_truth_k": 200,
            "seed": 11, "use_cache": False}},
        50,
        {"exact": 290.68, "hnsw": 213468, "ivf_flat": 259546,
         "ivf_pq": 95836, "ivf_sq8": 70534, "pq": 19837},
    ),
}

# not the JAX package's docs/matched_conditions_rows.json
DEFAULT_OUT = "results/matched_conditions_rows_torch.json"
BATCH = 128  # reference query_batch_size (reference configs/benchmark_config.yaml:221)
K = 20


def reference_protocol_qps(algo, queries: np.ndarray, k: int) -> Tuple[float, np.ndarray]:
    """QPS as the reference computes it: ``time.time()`` per batch,
    ``n_queries / sum(batch wall-clock)``."""
    total = 0.0
    ids = np.empty((queries.shape[0], k), dtype=np.int64)
    for start in range(0, queries.shape[0], BATCH):
        batch = queries[start : start + BATCH]
        t0 = time.time()
        _, bi = algo.batch_search(batch, k)
        total += time.time() - t0
        ids[start : start + BATCH] = bi
    return queries.shape[0] / max(total, 1e-12), ids


def run_rows(
    datasets: Dict[str, Any] = DATASETS,
    algos: Dict[str, Any] = ALGOS,
    data_dir: str = "data",
    device: DeviceLike = None,
    k: int = K,
) -> List[Dict[str, Any]]:
    """One row per dataset and algorithm: build, one untimed warm-up batch,
    then :func:`reference_protocol_qps` and recall@k against the dataset's
    ground truth."""
    device = resolve_device(device)
    rows = []
    for ds_name, (ds_args, pqm, ref_qps) in datasets.items():
        ds = Dataset(ds_args["name"], data_dir=data_dir, options=ds_args["options"],
                     device=device).load()
        x, q = ds.train_vectors, ds.test_vectors
        gt = ds.ground_truth[:, :k]
        for name, (idx, srch) in algos.items():
            idx = {
                k2: (v.format(pqm=pqm) if isinstance(v, str) else v)
                for k2, v in idx.items()
            }
            algo = CompositeAlgorithm(
                dimension=x.shape[1], indexer=idx, searcher=srch, metric="l2",
                device=device,
            )
            algo.build_index(x)
            algo.batch_search(q[:BATCH], k)  # warm-up, outside the clock
            qps, ids = reference_protocol_qps(algo, q, k)
            rows.append(
                {
                    "dataset": ds_name,
                    "algorithm": name,
                    "qps_reference_protocol": round(qps, 1),
                    "recall": round(float(recall_at_k(gt, ids, k)), 4),
                    "qps_reference_published_cpu": ref_qps[name],
                }
            )
            print(json.dumps(rows[-1]), flush=True)
    return rows


def _device_label(device: torch.device) -> str:
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU"
    return f"{name}, torch {torch.__version__}"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    try:
        import faiss  # noqa: F401

        faiss_state = "available"
    except ImportError as exc:
        faiss_state = f"unavailable ({exc})"

    rows = run_rows(data_dir=args.data_dir, device=device)
    out = {
        "protocol": "time.time() per 128-query batch, 256 queries, k=20 "
        "(reference experiment_runner.py:430-464)",
        "host": _device_label(device),
        "faiss_cpu": faiss_state,
        "rows": rows,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
