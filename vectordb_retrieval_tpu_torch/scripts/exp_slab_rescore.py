"""The IVF rescore's block gather against kernel K2 (slab dot products).

The fused IVF path's rescore gathers ``[B, nb]`` blocks of ``[w = 32, d]``
bf16 and needs exact f32-grade L2 distances (``ops/ivf._rescore_blocks``).
Here, at B = 256, nb = 116, d = 128 over 48,000 blocks: the block gather
with the difference-form rescore and the top-100 tail, against K2
(``ops/kernels.slab_dots``: each popped slab read once, multiplied on the
tensor cores) with ``||q||^2 + ||x||^2 - 2 q.x`` and the same tail. First
K2's dots against float64 on four queries.

The counterpart of the JAX package's ``scripts/exp_slab_rescore.py``: the
same module constants (``B``, ``NB``, ``W``, ``D``, ``G``, ``K``,
``ITERS``), inputs (NumPy seed 0) and printed lines, then one ``check``
line (``scripts/probes.print_check``): K2's error against float64 beside
its tolerance, and the two tails' first distances. The JAX script's
ring-depth loop (32, 64) is a knob of its manual-DMA kernel; K2 has no
ring, so it is one line here. Timing: the JAX script chains ``ITERS``
passes in one ``scan``; here one untimed pass, then ``ITERS`` passes on the
device with one synchronise and one copy of the last result to the host
inside the clock (``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_slab_rescore [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

B, NB, W, D = 256, 116, 32, 128
G = 48_000
K = 100
ITERS = 16
# K2 against float64: f32 sums of exact products in another order
SLAB_REL_TOL = 1e-5


def make_inputs() -> Dict[str, np.ndarray]:
    """The slabs ``[G, W, D]`` (f32 draws, stored as bf16 by the caller),
    the slot ids ``[G, W]``, the popped blocks ``[B, NB]`` and the queries
    ``[B, D]`` (seed 0, in the JAX script's order)."""
    rng = np.random.default_rng(0)
    return {
        "payload": rng.normal(size=(G, W, D)).astype(np.float32),
        "slot_ids": rng.integers(0, G * W, size=(G, W)).astype(np.int32),
        "blk": rng.integers(0, G, size=(B, NB)).astype(np.int32),
        "q": rng.normal(size=(B, D)).astype(np.float32),
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    inputs = make_inputs()
    payload = torch.as_tensor(inputs["payload"], device=device).to(torch.bfloat16)
    del inputs["payload"]
    sqn = torch.sum(payload.float() ** 2, dim=-1)  # [G, W]
    slot_ids = torch.as_tensor(inputs["slot_ids"], device=device)
    blk = torch.as_tensor(inputs["blk"], device=device)
    q = torch.as_tensor(inputs["q"], device=device)

    # -- numerical check: slab dots vs f64 ------------------------------
    dots = kernels.slab_dots(q, payload, blk)  # [B, NB, W]
    b4 = blk[:4].long()
    v64 = payload[b4].double()
    ref = torch.einsum("bnwd,bd->bnw", v64, q[:4].double())
    err = float((dots[:4].double() - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"slab dots max|err| = {err:.3e} (abs, |dot|~{scale:.1f})", flush=True)

    def tail(cd, b):
        cand = slot_ids.reshape(-1, W)[b.long()].reshape(B, -1)
        v, s = dops.top_k_smallest(cd, K)
        return v, torch.gather(cand, 1, s)

    def hlo_tail(b):
        diff = payload[b.long()].float() - q[:, None, None, :]
        return tail(torch.sum(diff * diff, dim=-1).reshape(B, -1), b)

    def slab_tail(b):
        qn = torch.sum(q * q, dim=-1)
        cd = (qn[:, None, None] + sqn[b.long()] - 2.0 * kernels.slab_dots(q, payload, b))
        return tail(cd.reshape(B, -1), b)

    _, t = timed_passes(hlo_tail, blk, ITERS, device)
    print(f"HLO  gather rescore+tail  {t / ITERS * 1e3:7.3f} ms/pass", flush=True)
    _, t2 = timed_passes(slab_tail, blk, ITERS, device)
    print(f"SLAB gather rescore+tail  {t2 / ITERS * 1e3:7.3f} ms/pass", flush=True)

    first_hlo, first_slab = hlo_tail(blk)[0][:, 0], slab_tail(blk)[0][:, 0]
    first_scale = float(first_hlo.abs().max())
    print_check(slab_max_abs_err=err, slab_max_abs_dot=scale, slab_tol=SLAB_REL_TOL * scale,
                first_rel_diff=float((first_hlo - first_slab).abs().max()) / first_scale,
                ms={"gather": t / ITERS * 1e3, "slab": t2 / ITERS * 1e3})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
