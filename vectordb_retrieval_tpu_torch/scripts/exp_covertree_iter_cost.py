"""Micro-bench the cover-tree descent's per-iteration components.

Components at the msmarco profile shape (B=200, E=64, C=64, f_max=4096,
M=100k, d=384):
  a) children row gather [B, E*C, d] from [M, d]      (scattered rows)
  b) the same bytes as CSR slab slices [B, E, C, d]   (contiguous blocks)
  c) scalar metadata gathers [B, E*C] from [M] x4
  c2) the same as slab slices [B, E, C] x4
  d) frontier reselect top-k([B, f_max+E*C]) -> f_max
  e) expansion select top-k([B, f_max]) -> E
  f) best update top-k([B, k+E*C]) -> k
  g) / h) the gathers of (a) / (b) with the difference-form distance
It bears on the descents' gathers (``ops/covertree.py``: the stream walk's
alive gather, the block walk's block gathers).

The counterpart of the JAX package's ``scripts/exp_covertree_iter_cost.py``:
the same module constants (``B``, ``E``, ``C``, ``F``, ``M``, ``D``, ``K``,
``ITERS``), inputs (NumPy seed 0) and printed lines, then one ``check`` line
(``scripts/probes.print_check``): each component's checksum (the sum of its
last chained indices) and whether every one is finite and in ``[0, M)``.
A slab slice ``dynamic_slice(table, (o, 0), (C, D))`` is an index gather
of rows ``o .. o + C`` here. Timing, as in the JAX script: ``ITERS`` steps
chained, each step's indices ``(idx + out) % M`` from the last step's
output; the JAX script runs the chain in one ``jit``, here one untimed
chain, then one chain on the device with one synchronise and one copy of
the last indices to the host inside the clock
(``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_covertree_iter_cost [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops.distances import top_k_smallest
from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

B, E, C, F, M, D, K = 200, 64, 64, 4096, 100_000, 384, 20
ITERS = 20


def make_inputs() -> Dict[str, np.ndarray]:
    """The row table, scalar table, child indices, slab offsets, frontier
    scores and queries (seed 0, in the JAX script's order)."""
    rng = np.random.default_rng(0)
    return {
        "table": rng.standard_normal((M + C, D), dtype=np.float32),
        "scal": rng.standard_normal(M + C, dtype=np.float32),
        "idx0": rng.integers(0, M, (B, E * C)).astype(np.int32),
        "off0": rng.integers(0, M, (B, E)).astype(np.int32),
        "fd0": rng.standard_normal((B, F + E * C), dtype=np.float32),
        "q": rng.standard_normal((B, D), dtype=np.float32),
    }


def timed(name, fn, idx0, device) -> np.ndarray:
    host, dt = timed_passes(fn, idx0, 1, device)
    print(f"{name:<44s} {dt / ITERS * 1e3:8.2f} ms/iter")
    return host


def chain(step):
    """Run ITERS steps, each seeded from the previous output's low bits."""

    def fn(idx):
        for _ in range(ITERS):
            idx = (idx + step(idx)) % M
        return idx.to(torch.int32)  # copied at the JAX script's width

    return fn


def _to_index(s: torch.Tensor) -> torch.Tensor:
    """A float checksum per row as a nonnegative index ``[B, 1]`` (float
    to integer truncates toward zero, the remainder takes the divisor's
    sign, as in the JAX script)."""
    return s.to(torch.int32).long()[:, None] % M


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    arrays = {name: torch.as_tensor(a, device=device) for name, a in make_inputs().items()}
    table, scal, fd0, q = arrays["table"], arrays["scal"], arrays["fd0"], arrays["q"]
    idx0, off0 = arrays["idx0"].long(), arrays["off0"].long()
    cols = torch.arange(C, device=device)

    def slab(off):
        return table[off[:, :, None] + cols]  # [B, E, C, D]

    out = {}
    out["a"] = timed("a) row gather [B,E*C,d]", chain(
        lambda idx: _to_index(table[idx].sum(dim=(1, 2)))), idx0, device)
    out["b"] = timed("b) slab slices [B,E,C,d]", chain(
        lambda off: _to_index(slab(off).sum(dim=(1, 2, 3)))), off0, device)
    out["c"] = timed("c) scalar gathers [B,E*C] x4", chain(
        lambda idx: _to_index(sum(scal[(idx + j) % M] for j in range(4)).sum(dim=1))),
        idx0, device)
    out["c2"] = timed("c2) scalar slab slices x4", chain(
        lambda off: _to_index(sum(scal[((off + j) % M)[:, :, None] + cols]
                                  for j in range(4)).sum(dim=(1, 2)))), off0, device)

    def reselect(idx):
        v, _ = top_k_smallest(fd0 + idx[:, :1].float(), F)
        return _to_index(v[:, 0])

    out["d"] = timed(f"d) reselect top-{F} of {F+E*C}", chain(reselect), idx0, device)

    def expsel(idx):
        v, _ = top_k_smallest(fd0[:, :F] + idx[:, :1].float(), E)
        return _to_index(v[:, 0])

    out["e"] = timed(f"e) expand select top-{E} of {F}", chain(expsel), idx0, device)

    def bestup(idx):
        v, _ = top_k_smallest(fd0[:, : K + E * C] + idx[:, :1].float(), K)
        return _to_index(v[:, 0])

    out["f"] = timed(f"f) best top-{K} of {K+E*C}", chain(bestup), idx0, device)

    def score(idx):
        diff = table[idx] - q[:, None, :]
        return _to_index(torch.sqrt(torch.sum(diff * diff, dim=-1)).sum(dim=1))

    out["g"] = timed("g) gather+diff-score [B,E*C,d]", chain(score), idx0, device)

    def score_slab(off):
        diff = slab(off) - q[:, None, None, :]
        return _to_index(torch.sqrt(torch.sum(diff * diff, dim=-1)).sum(dim=(1, 2)))

    out["h"] = timed("h) slab+diff-score [B,E,C,d]", chain(score_slab), off0, device)
    checksums = {name: int(v.sum()) for name, v in out.items()}
    in_range = all(bool(((v >= 0) & (v < M)).all()) for v in out.values())
    print_check(checksums=checksums, finite_in_range=in_range)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
