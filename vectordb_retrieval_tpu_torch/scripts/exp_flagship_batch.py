"""Flagship batch-size A/B: BATCH 256 (shipped) vs 512 at equal totals.

The flagship stream (``flagship.py``, ``BATCH``) searches ``TOTAL`` queries
in batches; the per-batch blockmin pass has a fixed per-batch cost, so
doubling B halves the batch count and may use the tensor cores better,
while the blockmin selection row and the candidate gather double. This
probe measures both back to back under one protocol (ABA order: 256, 512,
256) so drift shows.

The counterpart of the JAX package's ``scripts/exp_flagship_batch.py``:
the same module constants (``N``, ``D``, ``K``, ``TOTAL``; its ``UNROLL``,
a scan unroll, has no counterpart), inputs (NumPy seed 7, drawn anew for
each run, so both batch sizes search the same queries) and JSON lines,
then one ``check`` line (``scripts/probes.print_check``): the share of
certain ranks (distinct distances) at which each run's ids equal a dense
exact reference's (``scripts/probes.dense_reference``, the plain route, no
kernel). Timing: the JAX script scans the batches inside one ``jit`` and
keeps the best of two timed streams, copying a checksum to the host inside
the clock and the ids after it; here each of the two timed streams follows
an untimed one, with one synchronise and one copy of the last id to the
host inside the clock (``scripts/probes.timed_passes``), the ids after it.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_flagship_batch [--device cpu]

Prints one JSON line per variant. ``--device`` defaults to the CUDA card
and fails without one.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.scripts.probes import (
    agree_where_distinct,
    dense_reference,
    print_check,
    timed_passes,
)
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

N, D, K = 100_000, 384, 20
TOTAL = 24_576  # queries per measured stream (flagship.py: 96 x 256)
BATCHES = (256, 512, 256)  # ABA to expose drift


def make_inputs(batch: int) -> Tuple[np.ndarray, np.ndarray]:
    """The corpus ``[N, D]`` and ``TOTAL // batch`` batches of ``batch``."""
    rng = np.random.default_rng(7)
    db = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((TOTAL // batch, batch, D)).astype(np.float32)
    return db, queries


def run(batch: int, device: torch.device) -> Tuple[float, np.ndarray]:
    """``(best QPS of two timed streams, every batch's ids [TOTAL, K])``."""
    repeats = TOTAL // batch
    db_np, q_np = make_inputs(batch)
    db = torch.as_tensor(db_np, device=device)
    sqn = dops.sq_norms(db)
    queries = torch.as_tensor(q_np, device=device)

    kept = {}

    def stream(qs):
        kept["ids"] = torch.stack([
            dops.exact_search(qb, db, K, metric="l2", db_sqnorms=sqn, device=device)[1]
            for qb in qs
        ])
        return kept["ids"][-1, -1, -1]

    best = 0.0
    for _ in range(2):
        _, seconds = timed_passes(stream, queries, 1, device)
        best = max(best, TOTAL / seconds)
    ids = kept["ids"].cpu().numpy()
    assert ids.shape == (repeats, batch, K)
    assert (ids >= 0).all() and (ids < N).all()
    return best, ids.reshape(TOTAL, K)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    runs = []
    for batch in BATCHES:
        qps, ids = run(batch, device)
        print(json.dumps({"batch": batch, "qps": round(qps, 1)}))
        runs.append((batch, ids))
    db_np, q_np = make_inputs(BATCHES[0])
    db = torch.as_tensor(db_np, device=device)
    q = torch.as_tensor(q_np.reshape(TOTAL, D), device=device)
    ref_d, ref_i = zip(*(dense_reference(q[i:i + 256], db, K) for i in range(0, TOTAL, 256)))
    ref_d, ref_i = np.concatenate(ref_d), np.concatenate(ref_i)
    print_check(ids_agree=[{"batch": batch, "share": agree_where_distinct(ids, ref_i, ref_d)}
                           for batch, ids in runs])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
