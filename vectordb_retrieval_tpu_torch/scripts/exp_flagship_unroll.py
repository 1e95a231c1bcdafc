"""The flagship stream (exact search, 100k x 384, k 20) over 96 and 192
batches of 256 queries: QPS and milliseconds a batch, best of two timed
streams.

The counterpart of the JAX package's ``scripts/exp_flagship_unroll.py``: the
same module constants (``N``, ``D``, ``K``), configurations (``CONFIGS``:
batch, batches, unroll), inputs (NumPy seed 7: the corpus, then one query
draw for each configuration in order) and printed lines, then one
``check`` line (``scripts/probes.print_check``): each stream's last batch
against the exact reference (``scripts/probes.dense_reference``), as the
share of certain ranks whose ids agree. The JAX script sweeps the unroll
of XLA's while loop over the batches; the port runs no compiled loop, so
the knob has no counterpart and the configurations that differ only in it
are one line, timed on the first of their draws. Timing: one untimed
stream, then two timed streams on the device, each ending in one
synchronise and one copy of the last batch's ids to the host inside the
clock (``scripts/probes.timed_passes``); the best is printed. Stage 1 is
kernel K1 in its f32 mode.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_flagship_unroll [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
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
# (batch, batches, unroll), in the JAX script's order
CONFIGS = ((256, 96, 8), (256, 96, 16), (256, 96, 32), (256, 192, 8))


def make_inputs() -> Tuple[np.ndarray, List[np.ndarray]]:
    """The corpus ``[N, D]`` and each configuration's queries ``[reps, B,
    D]``, drawn in that order from one generator (seed 7)."""
    rng = np.random.default_rng(7)
    db = rng.standard_normal((N, D)).astype(np.float32)
    return db, [rng.standard_normal((reps, b, D)).astype(np.float32) for b, reps, _ in CONFIGS]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    db_np, draws = make_inputs()
    db = torch.as_tensor(db_np, device=device)
    sqn = dops.sq_norms(db)

    def stream(qall):
        return [dops.exact_search(qb, db, K, metric="l2", db_sqnorms=sqn, device=device)[1]
                for qb in qall][-1]

    rows, done = {}, set()
    for (b, reps, _), qs_np in zip(CONFIGS, draws):
        if (b, reps) in done:
            continue
        done.add((b, reps))
        qs = torch.as_tensor(qs_np, device=device)
        ids, best = timed_passes(stream, qs, 1, device)
        best = min(best, timed_passes(stream, qs, 1, device)[1])
        print(f"B={b:4d} reps={reps:3d}  {b*reps/best:9.0f} QPS ({best/reps*1e3:6.3f} ms/batch)",
              flush=True)
        ref_d, ref_i = dense_reference(qs[-1], db, K)
        rows[f"{b}x{reps}"] = {"qps": b * reps / best, "ms_per_batch": best / reps * 1e3,
                               "ids_agree": agree_where_distinct(ids, ref_i, ref_d)}
    print_check(rows=rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
