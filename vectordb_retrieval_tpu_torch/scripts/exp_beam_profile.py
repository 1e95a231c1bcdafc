"""The node beam's iteration taken apart: what each part costs alone at the
production shapes (B = 256, ef 125, W 48, R 32, N = 20k, d = 64, 5
iterations), beside the full beam (``ops/graph.graph_search``).

Parts, each chained over 5 iterations a batch: the neighbour-table gather
of ``[B, W]`` rows of ``[R, d]``, the plain row gather of ``[B, W R]``
rows, the ``bwrd,bd`` product, an argsort of ``[B, ef + W R]`` keys with
two gathers, a top-ef of that width, and the scatter that marks expanded
entries. It bears on the node beam's gather (``ops/graph.
build_neighbor_table``) and its selections (``ops/graph.NodeBeam.step``).

The counterpart of the JAX package's ``scripts/exp_beam_profile.py``: the
same module constants (``N``, ``D``, ``K``, ``B``, ``REPEATS``, ``EF``,
``W``, ``ITERS``, ``R``), inputs (NumPy seed 42, drawn in the JAX script's
order, the draws its parts make included) and printed lines, then one
``check`` line (``scripts/probes.print_check``): each part's checksum (the
sum of its last output), whether all are finite, and whether the full
beam's ids lie in ``[0, N)``. ``approx_max_k`` is ``torch.topk``,
``take_along_axis`` a ``gather``, ``.at[].set`` a ``scatter``. Timing: the
JAX script scans the ``REPEATS`` batches in one ``jit``; here one untimed
stream, then one timed stream of Python-driven iterations, ending in one
synchronise and one copy of the last output to the host
(``scripts/probes.timed_passes``). The host issues every small operation,
so the host's pace is part of each time.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_beam_profile [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import graph as gops
from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

N, D, K = 20_000, 64, 20
B = 256
REPEATS = 8
EF, W, ITERS = 125, 48, 5
R = 32


def make_inputs() -> Dict[str, np.ndarray]:
    """Every array the JAX script draws from its generator (seed 42), in
    its order: the corpus, the query batches, the random adjacency, the
    beam ids, then those its parts draw (the row-gather ids, the argsort's
    keys and values, the top-k's values, the scatter's selections)."""
    rng = np.random.default_rng(42)
    c = EF + W * R
    out = {"x": rng.standard_normal((N, D)).astype(np.float32),
           "queries": rng.standard_normal((REPEATS, B, D)).astype(np.float32),
           "adjacency": rng.integers(0, N, size=(N, R)).astype(np.int32),
           "ids0": rng.integers(0, N, size=(B, EF)).astype(np.int32)}
    out["ids_wr"] = rng.integers(0, N, size=(B, W * R)).astype(np.int32)
    out["keys"] = rng.integers(0, 2 * N, size=(B, c)).astype(np.int32)
    out["vals"] = rng.standard_normal((B, c)).astype(np.float32)
    out["topk_vals"] = rng.standard_normal((B, c)).astype(np.float32)
    out["sel"] = rng.integers(0, EF, size=(B, W)).astype(np.int32)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t = {k: torch.as_tensor(v, device=device) for k, v in make_inputs().items()}
    x, queries_r = t["x"], t["queries"]
    adjacency = t["adjacency"].long()
    sqn = dops.sq_norms(x)
    nbr_vecs = x[adjacency]  # [N, R, d] f32
    ids0 = t["ids0"].long()
    c = EF + W * R  # the merge's width
    sums = {}

    def timed(fn, label):
        def stream(qs):
            return [fn(qs[r]) for r in range(REPEATS)][-1]

        out, elapsed = timed_passes(stream, queries_r, 1, device)
        print(f"{label:42s} {elapsed / REPEATS * 1000:9.2f} ms/batch   "
              f"{B*REPEATS/elapsed:9.0f} QPS")
        sums[label] = float(np.sum(out, dtype=np.float64))
        return out

    def v_gather_only(q):
        bid, acc = ids0, torch.zeros((B,), device=device)
        for _ in range(ITERS):
            sel = (bid[:, :W] + 1) % N
            acc = acc + torch.sum(nbr_vecs[sel], dim=(1, 2, 3))
            bid = (bid + acc[:, None].long()) % N
        return acc + 0.0 * q.sum()

    timed(v_gather_only, "nbr-table gather [B,W] rows only")

    ids_wr = t["ids_wr"].long()

    def row_gather_only(q):
        bid, acc = ids_wr, torch.zeros((B,), device=device)
        for _ in range(ITERS):
            acc = acc + torch.sum(x[(bid + 1) % N], dim=(1, 2))
            bid = (bid + acc[:, None].long()) % N
        return acc + 0.0 * q.sum()

    timed(row_gather_only, "plain gather [B,W*R] rows only")

    def einsum_only(q):
        nvec = nbr_vecs[ids0[:, :W]]
        acc = torch.zeros((), device=device)
        for _ in range(ITERS):
            dots = torch.einsum("bwrd,bd->bwr", nvec + acc * 0.0, q)
            acc = acc + dots.sum() * 1e-30
        return acc

    timed(einsum_only, "einsum bwrd,bd only")

    def sort_only(q):
        k_, v_ = t["keys"], t["vals"]
        for _ in range(ITERS):
            order = torch.argsort(k_, dim=1)
            sd = torch.gather(v_, 1, order)
            sk = torch.gather(k_, 1, order)
            k_, v_ = (sk + 1) % (2 * N), sd + 1.0
        return v_ + 0.0 * q.sum()

    timed(sort_only, f"argsort+2x take [B,{c}] only")

    def topk_only(q):
        v = t["topk_vals"]
        for _ in range(ITERS):
            nv, _ = torch.topk(v, EF, dim=1)
            v = torch.cat([nv, torch.zeros((B, c - EF), device=device)], dim=1) + 1e-6
        return v + 0.0 * q.sum()

    timed(topk_only, f"approx_max_k(EF) [B,{c}] only")

    def scatter_only(q):
        e = torch.zeros((B, EF), dtype=torch.bool, device=device)
        s = t["sel"].long()
        for _ in range(ITERS):
            e = e | torch.zeros_like(e).scatter(1, s, True)
            s = (s + torch.sum(e, dim=1, keepdim=True)) % EF
        return e.float() + 0.0 * q.sum()

    timed(scatter_only, "beam_exp scatter only")

    # the full production search for reference
    entries = torch.arange(256, dtype=torch.int32, device=device)

    def full(q):
        return gops.graph_search(q, x, adjacency, entries, K, ef=EF, expand=W, iters=ITERS,
                                 metric="l2", sqnorms=sqn)[1]

    ids = timed(full, "full production beam")
    print_check(checksums=sums, finite=bool(np.all(np.isfinite(list(sums.values())))),
                ids_in_range=bool(((ids >= 0) & (ids < N)).all()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
