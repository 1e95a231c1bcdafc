"""Micro-bench: one-level vs two-level blockmin selection at the 1M shape.

The 1M exact search is selection-heavy: top-(k+slack) over the [B, N/w]
blockmin matrix. Containment composes: the true top-k elements occupy at
most k SUPER-blocks of g consecutive block minima, so selecting s
super-blocks by super-min, gathering their s*g block minima, and selecting
s blocks from those is exactly as safe as the one-level selection with the
same s. This trades one wide top-k for a min-reduce and two narrow ones.
It bears on ``ops/distances._select_blocks`` (``_SEL_FLAT_MAX``, ``_SEL_SF``:
the search takes the two-level cut at g = 4 above 8,192 blocks). The JAX
package's v5e record: the two-level cut loses on the TPU (6.72 ms one-level
against 6.93-24.50).

The counterpart of the JAX package's ``scripts/exp_topk_twolevel.py``: the
same options (``--device`` for ``--platform``), input (NumPy seed 0),
bit-exactness assertion at g in 8/16/32 and printed lines, then one
``check`` line (``scripts/probes.print_check``): whether the two-level
values equal the one-level ones at each g, 64 included. The top-k is the
port's ``top_k_smallest`` (``torch.topk``; the JAX package's is
``approx_max_k`` at recall 1.0). Timing: the JAX script chains ``--iters``
passes in one ``jit`` (each pass's matrix shifted by ``1e-12`` of the last
values' sum); here one untimed pass, then ``--iters`` passes of the same
matrix on the device with one synchronise and one copy of the last values to
the host inside the clock (``scripts/probes.timed_passes``). The checksum
is the last pass's values summed.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_topk_twolevel \\
        [--nb 31250] [--b 256] [--s 116] [--iters 8] [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vectordb_retrieval_tpu_torch.ops.distances import top_k_smallest
from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device


def make_input(b: int, nb: int) -> np.ndarray:
    """The block-minimum matrix ``[b, nb]`` (seed 0)."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((b, nb)).astype(np.float32)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nb", type=int, default=31_250)  # 1M / w=32
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--s", type=int, default=116)  # k=100 + slack 16
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    b, nb, s, iters = args.b, args.nb, args.s, args.iters
    bm0 = torch.as_tensor(make_input(b, nb), device=device)

    def timed(name, step):
        v, dt = timed_passes(lambda x: step(x)[0], bm0, iters, device)
        out = float(v.sum(dtype=np.float64))
        dt /= iters
        print(f"{name:28s} {dt*1e3:8.2f} ms/pass  (checksum {out:.3f})")
        return dt

    def one_level(bm):
        return top_k_smallest(bm, s)

    def two_level(g):
        def f(bm):
            pad = (-nb) % g
            bp = F.pad(bm, (0, pad), value=float("inf")) if pad else bm
            nsb = (nb + pad) // g
            sm = bp.reshape(b, nsb, g).amin(dim=2)  # super minima
            ssb = min(s, nsb)
            _, sb = top_k_smallest(sm, ssb)  # [B, ssb] super-block ids
            col = (sb[:, :, None] * g + torch.arange(g, device=bm.device)).reshape(b, ssb * g)
            sub = torch.gather(bp, 1, col)
            v, p = top_k_smallest(sub, min(s, ssb * g))
            return v, torch.gather(col, 1, p)

        return f

    # correctness: identical selected block sets (values compared — ties
    # may reorder ids)
    v1, _ = one_level(bm0)
    equal = {}
    for g in (8, 16, 32, 64):
        v2, _ = two_level(g)(bm0)
        equal[str(g)] = bool(torch.equal(v1, v2))
    unequal = [g for g in ("8", "16", "32") if not equal[g]]
    if unequal:
        raise AssertionError(f"two-level values differ from one-level at g in {unequal}")
    print("two-level == one-level (bit-exact values) at g in 8/16/32")

    timed("one-level top_k", one_level)
    for g in (8, 16, 32, 64):
        timed(f"two-level g={g}", two_level(g))
    print_check(two_level_equal=equal)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
