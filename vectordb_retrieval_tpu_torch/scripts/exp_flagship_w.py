"""Flagship full-path sweep: blockmin width w and selection slack on the
bench.py workload (100k x 384d f32, k=20, B=256), bench-style chained
multi-batch amortisation. Recall is checked vs the exact-search oracle.
It bears on ``ops/distances.blockmin_width`` and ``_BLOCKMIN_SLACK``.

The counterpart of the JAX package's ``scripts/exp_flagship_w.py``: the
same module constants (``N``, ``D``, ``K``, ``B``, ``REPEATS``), inputs
(NumPy seed 7) and printed lines, then one ``check`` line
(``scripts/probes.print_check``): each setting's recall@K of the first
batch against ``exact_search`` and its max distance error. Stage 1 is
kernel K1 in its f32 mode. Timing: the JAX script scans the ``REPEATS``
batches inside one ``jit`` (each batch shifted by a zero carry); here one
untimed stream of the batches, then one timed stream, with one synchronise
and one copy of the last batch's ids to the host inside the clock
(``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_flagship_w [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

N, D, K, B, REPEATS = 100_000, 384, 20, 256, 64
# (w, slack) settings, in the JAX script's order
SETTINGS = ((8, 16), (8, 8), (16, 16), (32, 16), (32, 8))
CHUNK = 131072


def make_inputs() -> Tuple[np.ndarray, np.ndarray]:
    """The corpus ``[N, D]`` and ``REPEATS`` batches ``[REPEATS, B, D]``."""
    rng = np.random.default_rng(7)
    db = rng.standard_normal((N, D)).astype(np.float32)
    qs = rng.standard_normal((REPEATS, B, D)).astype(np.float32)
    return db, qs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    db_np, qs_np = make_inputs()
    db = torch.as_tensor(db_np, device=device)
    sqn = dops.sq_norms(db)
    qs = torch.as_tensor(qs_np, device=device)

    # oracle on the first batch
    od, oi = dops.exact_search(qs[0], db, K, metric="l2", db_sqnorms=sqn, device=device)
    od, oi = od.cpu().numpy(), oi.cpu().numpy()

    rows = {}
    for w, slack in SETTINGS:
        def search(qb, w=w, slack=slack):
            return dops._exact_search_blockmin(qb, db, sqn, K, "l2", CHUNK, w=w, slack=slack)

        def stream(qall, search=search):
            return [search(qall[r]) for r in range(REPEATS)][-1]

        _, dt = timed_passes(stream, qs, 1, device)
        d1, i1 = search(qs[0])
        d1, i1 = d1.cpu().numpy(), i1.cpu().numpy()
        err = float(np.max(np.abs(np.sort(d1, 1) - np.sort(od, 1))))
        print(
            f"w={w:2d} slack={slack:2d}  {B*REPEATS/dt:9.0f} QPS "
            f"({dt/REPEATS*1e3:6.3f} ms/batch)  max|d err|={err:.2e}",
            flush=True,
        )
        rows[f"w={w},slack={slack}"] = {"qps": B * REPEATS / dt,
                                        "ms_per_batch": dt / REPEATS * 1e3,
                                        "maxerr": err, "recall": recall_at_k(oi, i1, K)}
    print_check(rows=rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
