"""Stage-split timing of the blockmin exact path at the SIFT-1M shape.

Stages: (1) the stream producing per-block minima (kernel K1, f32 mode);
(2) + the top-(k+slack) block selection; (3) + the block gather and exact
rescore (the full path, ``ops/distances.exact_search``). Each stage is
timed on its own over ``--iters`` passes.

The counterpart of the JAX package's ``scripts/exp_blockmin_stages.py``:
the same options (``--device`` for ``--platform``; ``--w`` defaults to
``_BLOCKMIN_WIDTH``, 8, for stages 1-2, while stage 3 takes
``blockmin_width(n)`` as the search does), inputs (NumPy seed 0) and
printed lines, then one ``check`` line (``scripts/probes.print_check``):
the share of certain ranks at which stage 3's ids equal a dense exact
reference's (``scripts/probes.dense_reference``, no kernel). Stage 2 cuts
with ``top_k_smallest`` over the whole ``[B, N/w]`` row, as the JAX script
does (the search itself selects hierarchically, ``_select_blocks``).
Timing: the JAX script chains ``--iters`` passes in one ``jit``; here one
untimed pass, then ``--iters`` passes on the device with one synchronise
and one copy of the last result to the host inside the clock
(``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_blockmin_stages \\
        [--n 1000000] [--d 128] [--b 256] [--k 100] [--iters 8] [--w 8] \\
        [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.ops.distances import (
    _BLOCKMIN_SLACK,
    _BLOCKMIN_WIDTH,
    clamp_chunk,
    sq_norms,
    top_k_smallest,
)
from vectordb_retrieval_tpu_torch.scripts.probes import (
    agree_where_distinct,
    dense_reference,
    print_check,
    timed_passes,
)
from vectordb_retrieval_tpu_torch.utils.device import resolve_device


def make_inputs(n: int, d: int, b: int):
    """The corpus ``[n, d]`` and queries ``[b, d]`` (seed 0)."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.standard_normal((b, d), dtype=np.float32))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--w", type=int, default=_BLOCKMIN_WIDTH)
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    db_np, q_np = make_inputs(args.n, args.d, args.b)
    db = torch.as_tensor(db_np, device=device)
    q0 = torch.as_tensor(q_np, device=device)
    w, k, b, iters = args.w, args.k, args.b, args.iters
    n = args.n
    budget = max(4096, (1 << 26) // b)
    chunk = clamp_chunk(min(65_536, budget), n, align=max(512, w))
    chunk = max(w, (chunk // w) * w)
    s = kernels.dist_blockmin_pad_rows(n, w)
    dbp = F.pad(db, (0, 0, 0, s - n))
    pen = F.pad(sq_norms(db), (0, s - n), value=float("inf")).reshape(-1, w)

    def scan_bmins(q):
        return kernels.dist_blockmin(q, dbp, pen, w=w, chunk_rows=chunk)

    nb = k + _BLOCKMIN_SLACK

    def stage1(q):
        return torch.sum(scan_bmins(q), dim=1)  # force the reduce, skip selection

    def stage2(q):
        v, blk = top_k_smallest(scan_bmins(q), nb)
        return v[:, 0] + blk[:, 0].float()

    def stage3(q):
        v, i = dops.exact_search(q, db, k, metric="l2", device=device)
        return v[:, 0] + i[:, 0].float()

    for name, fn in (
        ("stage1 scan+blockmin", stage1),
        ("stage2 +selection", stage2),
        ("stage3 full exact_search", stage3),
    ):
        _, dt = timed_passes(fn, q0, iters, device)
        dt /= iters
        print(f"{name:<28s} {dt*1e3:8.2f} ms/pass  "
              f"({b/dt:9.1f} QPS)")

    _, ids = dops.exact_search(q0, db, k, metric="l2", device=device)
    ref_d, ref_i = dense_reference(q0, db, k)
    print_check(stage3_ids_agree=agree_where_distinct(ids.cpu().numpy(), ref_i, ref_d))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
