"""Sweep blockmin width w and repeat count for the flagship bench shape
(100k x 384d, k = 20, batches of 256), with the ids of w = 16 and 32
against w = 8's. It bears on ``ops/distances.blockmin_width``.

The counterpart of the JAX package's ``scripts/exp_flagship_sweep.py``:
the same module constants (``N``, ``D``, ``K``, ``B``), inputs (NumPy seed
7, the corpus, then 20 and 64 batches) and printed lines, then one
``check`` line (``scripts/probes.print_check``) with every agreement.
Stage 1 is kernel K1 in its f32 mode. Timing: the JAX script scans the
batches inside one ``jit``; here one untimed stream of the batches, then
one timed stream, with one synchronise and one copy of the last batch's
result to the host inside the clock (``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_flagship_sweep [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

N, D, K = 100_000, 384, 20
B = 256
REPS = (20, 64)
WIDTHS = (8, 16, 32)
CHUNK = 262_144


def make_inputs() -> Tuple[np.ndarray, Dict[int, np.ndarray]]:
    """The corpus ``[N, D]`` and, for each of ``REPS``, that many batches
    ``[reps, B, D]``, drawn in that order from one generator (seed 7)."""
    rng = np.random.default_rng(7)
    db = rng.standard_normal((N, D)).astype(np.float32)
    return db, {reps: rng.standard_normal((reps, B, D)).astype(np.float32) for reps in REPS}


def timed(label, fn, qs, device) -> float:
    """Time ``fn`` over every batch of ``qs [reps, B, D]``; print the line."""
    reps = qs.shape[0]
    _, dt = timed_passes(lambda qall: [fn(qall[r]) for r in range(reps)][-1], qs, 1, device)
    print(f"{label:45s} {dt/reps*1e3:8.2f} ms/batch  {B*reps/dt:9.0f} QPS")
    return dt


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    db_np, batches = make_inputs()
    db = torch.as_tensor(db_np, device=device)
    sqn = dops.sq_norms(db)

    def blockmin(qb, w):
        return dops._exact_search_blockmin(qb, db, sqn, K, "l2", CHUNK, w=w)

    agree = {}
    for reps in REPS:
        qs = torch.as_tensor(batches[reps], device=device)
        for w in WIDTHS:
            timed(f"blockmin w={w:2d} reps={reps}", lambda qb, w=w: blockmin(qb, w), qs, device)
        # agreement check at this reps' first batch
        agree[str(reps)] = {}
        for w in (16, 32):
            _, i8 = blockmin(qs[0], 8)
            _, iw = blockmin(qs[0], w)
            same = float(np.mean(i8.cpu().numpy() == iw.cpu().numpy()))
            print(f"  ids agree w=8 vs w={w}: {same:.6f}")
            agree[str(reps)][str(w)] = same
    print_check(agree=agree)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
