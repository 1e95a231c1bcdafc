"""The cost of the selection primitives at the node beam's merge widths:
argsort, sort and top-k (k 8-128) over ``[256, C]``, C in 256, 384, 640
and 1664, and a merge of two sorted lists by counted ranks and a scatter,
each chained 5 times a batch over 8 batches. It bears on the node beam's
three top-k cuts an iteration (``ops/graph.NodeBeam.step``), which the JAX
package's sort-free beam was designed around.

The counterpart of the JAX package's ``scripts/exp_topk_cost.py``: the
same module constants (``B``, ``REPEATS``, ``ITERS``), widths, inputs
(NumPy seeds 1 and 0) and printed lines, then one ``check`` line
(``scripts/probes.print_check``): at every width and k, the top-k's values
equal the descending sort's first k, and the rank merge of two sorted
lists equals their sorted merge. ``approx_max_k`` and ``lax.top_k`` are
``torch.topk``, ``jnp.sort`` ``torch.sort``, ``.at[].set(mode="drop")`` a
``scatter`` into a buffer wide enough for every position, cut after.
Timing: the JAX script chains each body in one compiled scan; here Python
drives the chains, so the host paces these small operations
(``scripts/probes.time_selection``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_topk_cost [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from vectordb_retrieval_tpu_torch.scripts.probes import (
    print_check,
    selection_inputs,
    set_first,
    time_selection,
)
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

B, REPEATS, ITERS = 256, 8, 5
WIDTHS = (256, 384, 640, 1664)
MAX_K = (8, 16, 32, 64, 128)
TOP_K = (32, 128)
MERGES = ((128, 32), (128, 64))  # (ef, w): sorted lists of these lengths


def rank_merge(a: torch.Tensor, bvals: torch.Tensor) -> torch.Tensor:
    """The first ``ef`` of sorted rows ``a [B, ef]`` and ``bvals [B, w]``
    merged by counted ranks: each value's place is its index plus the
    count of the other list's values before it; places past ``ef`` are
    dropped."""
    ef, w = a.shape[1], bvals.shape[1]
    ra = torch.sum(bvals[:, None, :] < a[:, :, None], dim=2)
    rb = torch.sum(a[:, None, :] <= bvals[:, :, None], dim=2)
    pos_a = torch.arange(ef, device=a.device)[None, :] + ra
    pos_b = torch.arange(w, device=a.device)[None, :] + rb
    out = torch.full((a.shape[0], ef + w), float("inf"), device=a.device)
    out = out.scatter(1, pos_a, a).scatter(1, pos_b, bvals)
    return out[:, :ef]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    topk_equal, merge_equal = {}, {}

    def timed(body, c, label):
        vals0, qs = (torch.as_tensor(a, device=device) for a in selection_inputs(c, B, REPEATS))
        time_selection(body, label, vals0, qs, ITERS, device)
        return vals0

    for c in WIDTHS:
        def argsort_body(v):
            return torch.gather(v, 1, torch.argsort(v, dim=1)) + 1e-6

        vals0 = timed(argsort_body, c, f"argsort f32 [{B},{c}]")
        timed(lambda v: torch.sort(v, dim=1)[0] + 1e-6, c, f"jnp.sort vals [{B},{c}]")
        desc = torch.sort(vals0, dim=1, descending=True)[0]
        for k in MAX_K:
            if k >= c:
                continue

            def amk_body(v, k=k):
                return set_first(v, torch.topk(v, k, dim=1)[0] * (1 + 1e-6))

            timed(amk_body, c, f"approx_max_k k={k} [{B},{c}]")
            topk_equal[f"{c}/{k}"] = bool(torch.equal(torch.topk(vals0, k, dim=1)[0], desc[:, :k]))
        for k in TOP_K:
            if k >= c:
                continue
            timed(lambda v, k=k: set_first(v, torch.topk(v, k, dim=1)[0] * (1 + 1e-6)), c,
                  f"lax.top_k   k={k} [{B},{c}]")

    # the rank-merge primitive: counted ranks of two sorted lists + scatter
    for ef, w in MERGES:
        def merge_body(v, ef=ef, w=w):
            return set_first(v, rank_merge(v[:, :ef], v[:, ef:ef + w]) * (1 + 1e-6))

        vals0 = timed(merge_body, ef + w, f"rank-merge sorted {ef}+{w} (count+scatter)")
        a = torch.sort(vals0[:, :ef], dim=1)[0]
        bv = torch.sort(vals0[:, ef:ef + w], dim=1)[0]
        want = torch.sort(torch.cat([a, bv], dim=1), dim=1)[0][:, :ef]
        merge_equal[f"{ef}+{w}"] = bool(torch.equal(rank_merge(a, bv), want))
    print_check(topk_equals_sort=topk_equal, rank_merge_equals_sort=merge_equal)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
