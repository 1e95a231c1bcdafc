"""Block-width sweep for the blockmin exact path.

The blockmin certificate holds at ANY block width w (any block containing
a true top-k element has blockmin <= d_k; at most k-1 blocks can rank
strictly below it). Widening w shrinks the selection problem (N/w block
minima per query) at the cost of more rescore candidates ((k+slack)*w),
which are cheap contiguous-slab gathers. This sweeps w at the flagship
(100k x 384d) and SIFT-1M (1M x 128d) shapes to find the QPS optimum,
checking exactness against the default width. It bears on
``ops/distances.blockmin_width`` (w = 8 at 100k rows, 32 at 1M).

The counterpart of the JAX package's ``scripts/exp_blockmin_width.py``:
the same options (``--device`` for ``--platform``), inputs (NumPy seed 0)
and printed lines, then one ``check`` line (``scripts/probes.print_check``):
for each shape and width the largest distance error relative to the
default width's, and the share of certain ranks (distances apart by more
than a float32 tie) whose ids equal the default width's. Stage 1 of every width is kernel K1 in its
f32 mode (``ops/kernels.dist_blockmin``). Timing: the JAX script times a
``lax.scan`` of ``--iters`` passes inside one ``jit``, each pass's queries
shifted by a zero carry; here one untimed pass, then ``--iters`` passes on
the device with one synchronise and one copy of the last ids to the host
inside the clock (``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_blockmin_width \\
        [--iters 12] [--k K] [--widths 8,16,32,64,128] \\
        [--shapes 100000x384x256x20,1000000x128x256x100] [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.scripts.probes import (
    agree_where_distinct,
    print_check,
    timed_passes,
)
from vectordb_retrieval_tpu_torch.utils.device import resolve_device


def make_inputs(n: int, d: int, b: int) -> Tuple[np.ndarray, np.ndarray]:
    """The corpus ``[n, d]`` and queries ``[b, d]`` (seed 0, as drawn by the
    JAX script)."""
    rng = np.random.default_rng(0)
    db = rng.standard_normal((n, d), dtype=np.float32)
    qs = rng.standard_normal((b, d), dtype=np.float32)
    return db, qs


def run_shape(n: int, d: int, b: int, k: int, iters: int, widths: Sequence[int],
              device: torch.device) -> dict:
    """Print the shape's lines; return width -> its check numbers."""
    db_np, q_np = make_inputs(n, d, b)
    db = torch.as_tensor(db_np, device=device)
    sqn = dops.sq_norms(db)
    qs = torch.as_tensor(q_np, device=device)

    budget = max(4096, (1 << 26) // b)
    chunk = min(dops.DEFAULT_CHUNK_ROWS, budget)

    # reference result (current default width) for exactness check
    ref_d, ref_i = dops._exact_search_blockmin(qs, db, sqn, k, "l2", chunk)
    ref_d, ref_i = ref_d.cpu().numpy(), ref_i.cpu().numpy()
    scale = max(float(np.max(np.abs(ref_d))), np.finfo(np.float32).tiny)

    print(f"== shape N={n} d={d} B={b} k={k} chunk={chunk}")
    rows = {}
    for w in widths:
        def search(q, w=w):
            return dops._exact_search_blockmin(q, db, sqn, k, "l2", chunk, w=w)

        _, dt = timed_passes(search, qs, iters, device)
        dt /= iters
        dv, iv = search(qs)
        dv, iv = dv.cpu().numpy(), iv.cpu().numpy()
        err = float(np.max(np.abs(dv - ref_d)))
        print(
            f"  w={w:4d}  {dt*1e3:8.2f} ms/pass  ({b/dt:9.1f} QPS)"
            f"  maxerr={err:.2e}"
        )
        rows[str(w)] = {"ms": dt * 1e3, "qps": b / dt, "maxerr": err,
                        "rel_err": err / scale,
                        "ids_agree": agree_where_distinct(iv, ref_i, ref_d)}
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--widths", default="8,16,32,64,128")
    ap.add_argument("--shapes", default="100000x384x256x20,1000000x128x256x100")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    widths = [int(x) for x in args.widths.split(",")]
    shapes = {}
    for spec in args.shapes.split(","):
        n, d, b, k = (int(x) for x in spec.split("x"))
        if args.k:
            k = args.k
        shapes[f"{n}x{d}x{b}x{k}"] = run_shape(n, d, b, k, args.iters, widths, device)
    print_check(default_w=dops._BLOCKMIN_WIDTH, shapes=shapes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
