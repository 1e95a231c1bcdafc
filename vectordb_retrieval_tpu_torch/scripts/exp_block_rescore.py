"""A/B the fused-IVF block rescore formulations.

``exp_ivf_fused_profile`` puts most of an IVF batch in the block rescore
at B=256, nb=124, w=32, d=128; one suspect is the [B, nb, w, d] f32
difference intermediate. Candidates:
  a. diff-sum : sum((v32 - q)^2)            (the search's rescore)
  b. mul-sum  : qn + sqn - 2*sum(v32 * q)   (no difference tensor)
  c. mxu-hilo : qn + sqn - 2*(v.q_hi + v.q_lo) with the query split into
                two bf16 limbs: f32-grade dots against the bf16-stored
                vectors, as one batched product per limb
All variants share the same block gather so the A/B isolates the
arithmetic. It bears on ``ops/ivf._rescore_blocks`` and ``_exact_scores``.

The counterpart of the JAX package's ``scripts/exp_block_rescore.py``: the
same module constants (``B``, ``NB``, ``W``, ``D``, ``G``, ``ITERS``),
inputs (NumPy seed 0), float64 reference on a 4 x 4 slice and printed
lines, then one ``check`` line (``scripts/probes.print_check``) with each
variant's max error relative to the reference's largest distance. The
limb products of (c) are f32 ``einsum``s of the bf16-valued operands
(exact products, f32 sums, TF32 off), the JAX script's bf16 dot with an
f32 result; ``torch`` has no bf16 product with an f32 result. Timing: the
JAX script scans ``ITERS`` passes in one ``jit``, chaining the block ids
through a zero shift; here one untimed pass, then ``ITERS`` passes on the
device with one synchronise and one copy of the last result to the host
inside the clock (``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_block_rescore [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

B, NB, W, D = 256, 124, 32, 128
G = 48_000  # blocks in the payload (1.5M slots / 32)
ITERS = 16


def make_inputs() -> Dict[str, np.ndarray]:
    """The payload ``[G, W, D]`` (f32, to be rounded to bf16), queries
    ``[B, D]`` and selected blocks ``[B, NB]`` (seed 0, in the JAX
    script's order)."""
    rng = np.random.default_rng(0)
    return {
        "payload": rng.normal(size=(G, W, D)).astype(np.float32),
        "q": rng.normal(size=(B, D)).astype(np.float32),
        "blk": rng.integers(0, G, size=(B, NB)).astype(np.int32),
    }


def rescore_diff(q, vecs, sqn):
    v32 = vecs.float()
    diff = v32 - q[:, None, None, :]
    return torch.sum(diff * diff, dim=-1)


def rescore_mul(q, vecs, sqn):
    v32 = vecs.float()
    qn = torch.sum(q * q, dim=-1)
    dots = torch.sum(v32 * q[:, None, None, :], dim=-1)
    return qn[:, None, None] + sqn - 2.0 * dots


def rescore_mxu(q, vecs, sqn):
    q_hi = q.to(torch.bfloat16)
    q_lo = (q - q_hi.float()).to(torch.bfloat16)
    qn = torch.sum(q * q, dim=-1)
    v32 = vecs.float()
    dots = (torch.einsum("bnwd,bd->bnw", v32, q_hi.float())
            + torch.einsum("bnwd,bd->bnw", v32, q_lo.float()))
    return qn[:, None, None] + sqn - 2.0 * dots


VARIANTS = {
    "a.diff-sum": rescore_diff,
    "b.mul-sum": rescore_mul,
    "c.mxu-hilo": rescore_mxu,
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
    q = torch.as_tensor(inputs["q"], device=device)
    blk0 = torch.as_tensor(inputs["blk"], device=device).long()

    # correctness vs f64 on a tiny slice
    sl = blk0[:4, :4]
    v_np = payload[sl].double().cpu().numpy()
    q_np = q[:4].double().cpu().numpy()
    ref = ((v_np - q_np[:, None, None, :]) ** 2).sum(-1)

    errs = {}
    for name, fn in VARIANTS.items():
        def run(blk, fn=fn):
            cd = fn(q, payload[blk], sqn[blk])
            return cd[:, 0, 0]

        _, dt = timed_passes(run, blk0, ITERS, device)
        dt = dt / ITERS * 1e3
        cd4 = fn(q[:4], payload[sl], sqn[sl])
        err = float(np.max(np.abs(cd4.double().cpu().numpy() - ref)))
        rel = err / float(np.max(ref))
        print(f"{name:12s} {dt:7.3f} ms/pass   max|err|={rel:.2e} (rel)",
              flush=True)
        errs[name] = rel
    print_check(max_rel_err=errs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
