"""Component profile of the flagship bench shape (100k x 384d, B=256, k=20).

Times, each over ``REPEATS`` batches:
  a) full blockmin exact search (the bench path)
  b) stage 1 only (the blockmin reduction): kernel K1, f32 mode
  c) raw f32 dot only: ``torch.matmul``, TF32 off
  d) raw bf16 dot only: ``torch.matmul`` on bf16 inputs
  e) stage 1 in bf16: kernel K1, bf16 mode
  f) selection only (top-k over [B, N/w])
  g) bf16 stage 1 + enlarged slack (40) + exact rescore, and its recall
     against exact search

The counterpart of the JAX package's ``scripts/exp_flagship_profile.py``:
the same module constants (``N``, ``D``, ``K``, ``B``, ``REPEATS``), width
``W`` and one-chunk row count ``CHUNK``, inputs (NumPy seed 7) and printed
labels, then one ``check`` line (``scripts/probes.print_check``): the share
of certain ranks at which (a)'s ids equal a dense exact reference's
(``scripts/probes.dense_reference``, no kernel) and (g)'s recall. The
TPU's precisions map so: HIGH (bf16x3) is K1's f32 mode (3xTF32) in (b)
and an f32 ``torch.matmul`` with TF32 off in (c); DEFAULT (one bf16 pass)
is K1's bf16 mode in (e) and (g) and a bf16 ``torch.matmul`` in (d), whose
bf16 copy of the corpus is made once, outside the clock, and whose output
is bf16 (the JAX script asks for f32). K1 omits the per-query ``||q||^2``
the JAX script's stage 1 adds (rank-equal). Timing: the JAX script scans
the batches inside one ``jit``, each batch's first output reduced to its
max; here the same reduction, one untimed stream of the batches, then one
timed stream, with one synchronise and one copy of the last batch's max to
the host inside the clock (``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_flagship_profile [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.scripts.probes import (
    agree_where_distinct,
    dense_reference,
    print_check,
    timed_passes,
)
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

N, D, K = 100_000, 384, 20
B = 256
REPEATS = 20
W = 8
CHUNK = 100352  # one chunk at this shape


def make_inputs() -> Tuple[np.ndarray, np.ndarray]:
    """The corpus ``[N, D]`` and ``REPEATS`` batches ``[REPEATS, B, D]``."""
    rng = np.random.default_rng(7)
    db = rng.standard_normal((N, D)).astype(np.float32)
    qs = rng.standard_normal((REPEATS, B, D)).astype(np.float32)
    return db, qs


def _checksum(out) -> torch.Tensor:
    """The max of a batch's first output, as the JAX script's carry."""
    first = out[0] if isinstance(out, tuple) else out
    return torch.max(first)


def timed(label, fn, qs, device) -> float:
    """Time ``fn`` over every batch of ``qs``; print the line."""
    _, dt = timed_passes(lambda qall: [_checksum(fn(qall[r])) for r in range(REPEATS)][-1],
                         qs, 1, device)
    print(f"{label:55s} {dt/REPEATS*1e3:8.2f} ms/batch  {B*REPEATS/dt:9.0f} QPS")
    return dt


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

    w = W
    pad = CHUNK - N
    dbp = F.pad(db, (0, 0, 0, pad))
    pen = F.pad(sqn, (0, pad), value=float("inf")).reshape(-1, w)
    dbp_bf = dbp.to(torch.bfloat16)

    def full(qb):
        return dops.exact_search(qb, db, K, metric="l2", db_sqnorms=sqn, device=device)

    timed("a) full blockmin exact (bench path)", full, qs, device)

    def stage1(qb):
        return kernels.dist_blockmin(qb, dbp, pen, w=w)

    timed("b) stage 1 blockmin only (HIGH)", stage1, qs, device)
    timed("c) raw dot HIGH", lambda qb: qb @ dbp.T, qs, device)
    timed("d) raw dot DEFAULT", lambda qb: qb.to(torch.bfloat16) @ dbp_bf.T, qs, device)

    def stage1_def(qb):
        return kernels.dist_blockmin(qb, dbp_bf, pen, w=w)

    timed("e) stage 1 blockmin DEFAULT", stage1_def, qs, device)

    bmins = stage1(qs[0])
    timed("f) selection approx_max_k over [B, N/w]",
          lambda qb: dops.top_k_smallest(bmins, K + 16)[0], qs, device)

    # g) full search with DEFAULT stage-1 + bigger slack + exact rescore
    blocks = dbp.reshape(-1, w, D)

    def full_default(qb):
        bm = stage1_def(qb)
        nb = K + 40
        _, blk = dops.top_k_smallest(bm, nb)
        diff = blocks[blk] - qb[:, None, None, :]
        cd = torch.sum(diff * diff, dim=-1)
        cand = (blk[:, :, None] * w + torch.arange(w, device=device)).reshape(B, nb * w)
        cd = torch.where(cand < N, cd.reshape(B, nb * w), float("inf"))
        vals, sel = dops.top_k_smallest(cd, K)
        return vals, torch.gather(cand, 1, sel)

    timed("g) DEFAULT stage1 + slack40 + exact rescore", full_default, qs, device)

    # recall check g vs exact
    _, gt_i = full(qs[0])
    _, g_i = full_default(qs[0])
    gt_i, g_i = gt_i.cpu().numpy(), g_i.cpu().numpy()
    rec = recall_at_k(gt_i, g_i, K)
    print(f"   g recall vs exact: {rec:.6f}")
    ref_d, ref_i = dense_reference(qs[0], db, K)
    print_check(a_ids_agree=agree_where_distinct(gt_i, ref_i, ref_d), g_recall=rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
