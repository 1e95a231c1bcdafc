"""Flagship benchmark: exact-search QPS on the MS MARCO-shaped workload.

    python -m vectordb_retrieval_tpu_torch.flagship [--device cpu]

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline",
"device", "power_limit_w"}``.

Workload: the reference's hardest exact-search row, 100,000 x 384 random
f32 vectors (MiniLM-sized), l2, top-20, 96 distinct batches of 256 queries,
all drawn from one NumPy generator seeded 7. Every batch runs
``ops/distances.exact_search`` with the rows' squared norms given, so the
fused distance + block-minimum kernel (``ops/kernels.dist_blockmin``, f32
mode) runs on every batch. Baseline: the reference's CPU FAISS IndexFlat
reached 550.41 QPS on the same shape at recall 1.0 (BASELINE.md,
benchmark_20260305_070532 msmarco row); exact search has recall 1.0 on
both sides.

Timing: the data is on the device before the clock. One batch runs first,
untimed, through every op the stream runs (the search, a stack of 96
id tensors and its copy to the host). The clock then covers all 96
batches and stops only after
``torch.cuda.synchronize()`` and the copy of every batch's ids to the host,
so the host holds the results when it reads the clock: stricter than
``bench.py``, whose clock stops before its ids are copied to the host. The
ids are then checked: shape ``[96, 256, 20]``, every id in ``[0, N)``.

``--device`` defaults to the CUDA card and fails without one; ``cpu`` runs
on the host (its QPS is the host's, labelled ``"device": "cpu"``).
:func:`run` takes the shapes as arguments, so tests run it small.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device, synchronize

BASELINE_QPS = 550.41  # reference exact/msmarco row, BASELINE.md
N, D, K = 100_000, 384, 20
BATCH = 256
REPEATS = 96
SEED = 7


def make_workload(
    n: int, d: int, batches: int, batch: int, seed: int, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(db [n, d], its squared norms [n], queries [batches, batch, d])``
    on ``device``, drawn as ``bench.py`` draws them (float64 normals cast to
    f32, the database first)."""
    rng = np.random.default_rng(seed)
    db = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32), device=device)
    queries = torch.as_tensor(
        rng.standard_normal((batches, batch, d)).astype(np.float32), device=device
    )
    return db, dops.sq_norms(db), queries


def timed_stream(
    db: torch.Tensor, sqn: torch.Tensor, queries: torch.Tensor, k: int
) -> Tuple[float, np.ndarray]:
    """Seconds for every batch of ``queries`` through exact search, after
    one untimed batch through the same ops: its search, then a stack of as
    many id tensors as the stream stacks and the copy to the host (CUDA
    loads a kernel's module at its first launch, and the many-input stack
    is a kernel of its own, which must not load inside the clock). The
    clock stops with the ids ``[batches, batch, k]`` on the host, which
    are returned."""
    dev = db.device

    def search(qb):
        return dops.exact_search(qb, db, k, metric="l2", db_sqnorms=sqn, device=dev)

    torch.stack([search(queries[0])[1]] * queries.shape[0]).cpu()
    synchronize(dev)
    t0 = time.perf_counter()
    ids = [search(queries[i])[1] for i in range(queries.shape[0])]
    synchronize(dev)
    ids_host = torch.stack(ids).cpu().numpy()
    return time.perf_counter() - t0, ids_host


def check_ids(ids: np.ndarray, batches: int, batch: int, k: int, n: int) -> None:
    if ids.shape != (batches, batch, k):
        raise AssertionError(f"ids shape {ids.shape} != {(batches, batch, k)}")
    if not ((ids >= 0).all() and (ids < n).all()):
        raise AssertionError("ids outside [0, N)")


def power_limit_w(device: torch.device) -> Optional[float]:
    """The card's power limit in watts from ``nvidia-smi`` (the first card
    it lists); None on the host."""
    if device.type != "cuda":
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(smi.stdout.strip().splitlines()[0])


def run(
    n: int = N, d: int = D, k: int = K, batch: int = BATCH, batches: int = REPEATS,
    seed: int = SEED, device: DeviceLike = None,
) -> Tuple[Dict[str, Any], np.ndarray]:
    """The flagship at the given shapes: ``(JSON record, ids)``."""
    dev = resolve_device(device)
    db, sqn, queries = make_workload(n, d, batches, batch, seed, dev)
    synchronize(dev)
    elapsed, ids = timed_stream(db, sqn, queries, k)
    check_ids(ids, batches, batch, k, n)
    qps = batch * batches / elapsed
    record = {
        "metric": f"exact_search_qps_{n // 1000}k_{d}d_top{k}",
        "value": round(qps, 2),
        "unit": "queries/s",
        "vs_baseline": round(qps / BASELINE_QPS, 2),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "power_limit_w": power_limit_w(dev),
    }
    return record, ids


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Exact-search flagship QPS")
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = parser.parse_args(argv)
    record, _ = run(device=args.device)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
