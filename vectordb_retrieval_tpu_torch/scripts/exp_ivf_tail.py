"""Decompose the fused-IVF tail (the stage 4 -> 5 delta of
``exp_ivf_fused_profile``).

Candidates for the cost: (a) the slot-id block gather [G, w] i32 ->
[B, nb, w], (b) the top-k over [B, nb*w], (c) the whole tail (a, b and the
final id gather), (d) the vector gather and exact rescore, (e) packing the
ids into the vector gather as two bf16 lanes (hi/lo base-256 limbs) so the
separate slot gather disappears, (f) the same tail with the slot gather
split out. It bears on ``ops/ivf._rescore_blocks``.

The counterpart of the JAX package's ``scripts/exp_ivf_tail.py``: the same
module constants (``B``, ``NB``, ``W``, ``D``, ``G``, ``K``, ``ITERS``),
inputs (NumPy seed 0) and printed lines, then one ``check`` line
(``scripts/probes.print_check``): whether (b)'s top-k values equal (c)'s,
whether (e)'s equal (f)'s (one rescore, two gathers), and the share of
(e)'s ids that equal (f)'s. A bf16 limb holds integers exactly only up to
256, so the packed ids are exact only below 65,536: at ``G * W`` = 1.5M
slot ids most differ (the JAX script's note says 2^19). Block ids index as
int64 (``torch`` indexing). Timing: the JAX script scans ``ITERS`` passes
in one ``jit``, chaining the block ids through a zero bump; here one
untimed pass, then ``ITERS`` passes on the device with one synchronise and
one copy of the last result to the host inside the clock
(``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_ivf_tail [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

B, NB, W, D = 256, 124, 32, 128
G = 48_000
K = 100
ITERS = 16


def make_inputs() -> Dict[str, np.ndarray]:
    """The payload ``[G, W, D]`` (f32, to be rounded to bf16), slot ids
    ``[G, W]``, selected blocks ``[B, NB]``, candidate scores
    ``[B, NB * W]`` and queries ``[B, D]`` (seed 0, in the JAX script's
    order)."""
    rng = np.random.default_rng(0)
    return {
        "payload": rng.normal(size=(G, W, D)).astype(np.float32),
        "slot_ids": rng.integers(0, G * W, size=(G, W)).astype(np.int32),
        "blk": rng.integers(0, G, size=(B, NB)).astype(np.int32),
        "cd": rng.normal(size=(B, NB * W)).astype(np.float32),
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
    payload = torch.as_tensor(inputs.pop("payload"), device=device).to(torch.bfloat16)
    slot_ids = torch.as_tensor(inputs["slot_ids"], device=device)
    blk = torch.as_tensor(inputs["blk"], device=device).long()
    cd = torch.as_tensor(inputs["cd"], device=device)
    q = torch.as_tensor(inputs["q"], device=device)

    # packed payload: vectors + id limbs (hi=id//256, lo=id%256)
    ids_f = slot_ids.float()
    hi = torch.floor(ids_f / 256.0).to(torch.bfloat16)
    lo = torch.remainder(ids_f, 256.0).to(torch.bfloat16)
    packed = torch.cat([payload, hi[:, :, None], lo[:, :, None]], dim=-1)  # [G, W, D+2]

    def timed(fn):
        _, dt = timed_passes(fn, blk, ITERS, device)
        return dt / ITERS * 1e3

    t = timed(lambda b: slot_ids.reshape(-1, W)[b].reshape(B, -1)[:, 0].float())
    print(f"a. slot block gather          {t:7.3f} ms/pass", flush=True)

    def topk(b):
        v, s = dops.top_k_smallest(cd + b[:, :1].float() * 0, K)
        return v[:, 0] + s[:, 0].float()

    t = timed(topk)
    print(f"b. top-k [B,{NB*W}] k={K}      {t:7.3f} ms/pass", flush=True)

    def full_tail(b, with_vals=False):
        cand = slot_ids.reshape(-1, W)[b].reshape(B, -1)
        v, s = dops.top_k_smallest(cd + b[:, :1].float() * 0, K)
        ids = torch.gather(cand, 1, s)
        return (v, ids) if with_vals else v[:, 0] + ids[:, 0].float()

    t = timed(full_tail)
    print(f"c. full tail (a+b+take)       {t:7.3f} ms/pass", flush=True)

    def gather_rescore(b):
        v32 = payload[b].float()
        diff = v32 - q[:, None, None, :]
        cdx = torch.sum(diff * diff, dim=-1)
        return cdx[:, 0, 0]

    t = timed(gather_rescore)
    print(f"d. vec gather+rescore         {t:7.3f} ms/pass", flush=True)

    def packed_tail(b, with_vals=False):
        vecs = packed[b]  # [B, NB, W, D+2]
        v32 = vecs[..., :D].float()
        ids = (vecs[..., D].float() * 256.0 + vecs[..., D + 1].float()).to(torch.int32)
        diff = v32 - q[:, None, None, :]
        cdx = torch.sum(diff * diff, dim=-1).reshape(B, -1)
        v, s = dops.top_k_smallest(cdx, K)
        out = torch.gather(ids.reshape(B, -1), 1, s)
        return (v, out) if with_vals else v[:, 0] + out[:, 0].float()

    t = timed(packed_tail)
    print(f"e. PACKED gather+rescore+tail {t:7.3f} ms/pass", flush=True)

    def split_tail(b, with_vals=False):
        v32 = payload[b].float()
        diff = v32 - q[:, None, None, :]
        cdy = torch.sum(diff * diff, dim=-1).reshape(B, -1)
        cand = slot_ids.reshape(-1, W)[b].reshape(B, -1)
        v, s = dops.top_k_smallest(cdy, K)
        ids = torch.gather(cand, 1, s)
        return (v, ids) if with_vals else v[:, 0] + ids[:, 0].float()

    t = timed(split_tail)
    print(f"f. SPLIT  gather+rescore+tail {t:7.3f} ms/pass", flush=True)

    b_vals, _ = dops.top_k_smallest(cd, K)
    c_vals, _ = full_tail(blk, with_vals=True)
    e_vals, e_ids = packed_tail(blk, with_vals=True)
    f_vals, f_ids = split_tail(blk, with_vals=True)
    print_check(b_equals_c=bool(torch.equal(b_vals, c_vals)),
                e_equals_f=bool(torch.equal(e_vals, f_vals)),
                packed_ids_exact=float((e_ids == f_ids).float().mean()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
