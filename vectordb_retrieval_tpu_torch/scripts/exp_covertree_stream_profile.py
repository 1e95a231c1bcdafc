"""Stage-profile the depth-synchronous cover-tree stream walk at 1M.

The stream walk streams [B, chunk] f32 products over the depth-major
slab, and per chunk pays (a) a full-width top-k merge of the candidates
into the running [B, kprime] set, (b) a [B, Wc] alive-mask gather (by
parent position), (c) the band and prune elementwise work. This script
times those pieces in isolation at the production shape, on a synthetic
depth-major slab (most nodes in the last two depths): the full walk, the
walk with each merge (full width, a blockmin pre-cut of 16 or 64 columns,
none: the floor), and the walk without the alive gather. It bears on
``ops/covertree.covertree_stream_search``.

The counterpart of the JAX package's
``scripts/exp_covertree_stream_profile.py``: the same options (``--device``
for ``--platform``), inputs (NumPy seed 0) and printed lines, then one
``check`` line (``scripts/probes.print_check``): each variant's sum of its
final ``[B, kprime]`` upper bounds (the JAX script's checksum), and
whether the blockmin merges' sums equal the full-width merge's (the same
kprime smallest values). "full" is the search function itself, whose sum
is over its k exact distances. Timing: the JAX script chains ``--iters``
passes in one ``jit`` (each pass's queries shifted by ``1e-12`` of the
last sum); here one untimed pass, then ``--iters`` passes of the same
queries on the device with one synchronise and one copy of the last sum to
the host inside the clock (``scripts/probes.timed_passes``); the printed
checksum is ``--iters`` times that sum.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_covertree_stream_profile \\
        [--m 1200000] [--d 128] [--b 256] [--k 100] [--iters 4] [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vectordb_retrieval_tpu_torch.ops.covertree import (
    DEFAULT_ERR_C,
    _STREAM_CHUNK,
    covertree_stream_search,
)
from vectordb_retrieval_tpu_torch.ops.distances import top_k_smallest
from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device


def make_inputs(m: int, d: int, b: int) -> Tuple[Tuple[int, ...], Dict[str, np.ndarray]]:
    """``(depth_sizes, arrays)``: a geometric depth profile like a real 1M
    tree (depths aligned to 32, the slab layout contract; ``m`` rounded
    down to keep it), the slab, radii, parent positions and queries."""
    rng = np.random.default_rng(0)
    sizes = []
    s = 32
    while sum(sizes) + s < m:
        sizes.append(s)
        s = min(s * 8, m - sum(sizes))
    tail = m - sum(sizes)
    m = sum(sizes) + (tail // 32) * 32
    sizes.append(m - sum(sizes))
    depth_sizes = tuple(int(x) for x in sizes if x > 0)

    slab = rng.standard_normal((m, d)).astype(np.float32)
    radii = (rng.random(m) * 0.05).astype(np.float32)
    # parent positions: random valid index into the previous depth
    prel = np.zeros(m, np.int32)
    off = 0
    prev_w = 1
    for w in depth_sizes:
        prel[off: off + w] = rng.integers(0, prev_w, size=w)
        prev_w = w
        off += w
    queries = rng.standard_normal((b, d)).astype(np.float32)
    return depth_sizes, {"slab": slab, "radii": radii, "parent_rel": prel, "queries": queries}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=1_200_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    d, b, k = args.d, args.b, args.k
    kp = max(2 * k, k + 256)
    depth_sizes, arrays = make_inputs(args.m, d, b)
    slab = torch.as_tensor(arrays["slab"], device=device)
    m = slab.shape[0]
    point_ids = torch.arange(m, dtype=torch.int32, device=device)
    is_real = torch.ones((m,), dtype=torch.bool, device=device)
    radii = torch.as_tensor(arrays["radii"], device=device)
    parent_rel = torch.as_tensor(arrays["parent_rel"], device=device)
    queries = torch.as_tensor(arrays["queries"], device=device)
    iters = args.iters
    inf = float("inf")

    def timed(name, fn):
        r, dt = timed_passes(fn, queries, iters, device)
        out = float(r) * iters
        per = dt / iters
        print(
            f"{name:32s} {dt*1e3:9.1f} ms total  {per*1e3:8.1f} ms/pass"
            f"  -> {b/per:8.0f} QPS  (checksum {out:.3f})"
        )
        return float(r)

    # ---- full current stream search -------------------------------------
    def full(q):
        res = covertree_stream_search(
            q, slab, point_ids, is_real, radii, parent_rel,
            depth_sizes=depth_sizes, k=k, kprime=kp,
        )
        return torch.sum(torch.where(torch.isfinite(res.dists), res.dists, 0.0))

    # ---- shared chunk-stream scaffolding ---------------------------------
    def stream(q, with_alive, select):
        """One full slab walk; ``select(best_h, best_i, cand, s0)`` merges
        a chunk's candidates into the running (best_h, best_i)."""
        qn2 = torch.sum(q * q, dim=-1)
        qn = torch.sqrt(qn2)
        best_h = torch.full((b, kp), inf, dtype=torch.float32, device=device)
        best_i = torch.full((b, kp), -1, dtype=torch.int64, device=device)
        kept_prev = torch.ones((b, 1), dtype=torch.bool, device=device)
        off = 0
        for w in depth_sizes:
            kept_parts = []
            for c0 in range(0, w, _STREAM_CHUNK):
                wc = min(_STREAM_CHUNK, w - c0)
                s0 = off + c0
                blk = slab[s0: s0 + wc]
                r_blk = radii[s0: s0 + wc]
                prel_blk = parent_rel[s0: s0 + wc].long()
                bn2 = torch.sum(blk * blk, dim=-1)
                dot = q @ blk.T
                d2 = qn2[:, None] + bn2[None, :] - 2.0 * dot
                band2 = (2.0 * DEFAULT_ERR_C) * qn[:, None] * torch.sqrt(bn2)[None, :]
                d2_lo = torch.clamp(d2 - band2, min=0.0)
                d2_hi = d2 + band2
                if with_alive:
                    alive = kept_prev[:, prel_blk]
                else:
                    alive = torch.ones((b, wc), dtype=torch.bool, device=device)
                cand = torch.where(alive, d2_hi, inf)
                best_h, best_i = select(best_h, best_i, cand, s0)
                kth_ub = torch.sqrt(best_h[:, k - 1])
                kept_parts.append(
                    alive & (torch.sqrt(d2_lo) - r_blk[None, :] <= kth_ub[:, None])
                )
            kept_prev = kept_parts[0] if len(kept_parts) == 1 else torch.cat(kept_parts, dim=1)
            off += w
        return torch.sum(torch.where(torch.isfinite(best_h), best_h, 0.0))

    def sel_full(best_h, best_i, cand, s0):
        wc = cand.shape[1]
        pos = (torch.arange(wc, device=device) + s0).expand(b, wc)
        cat_d = torch.cat([best_h, cand], dim=1)
        cat_i = torch.cat([best_i, pos], dim=1)
        bh, p = top_k_smallest(cat_d, kp)
        return bh, torch.gather(cat_i, 1, p)

    def make_sel_blockmin(wblk):
        def sel(best_h, best_i, cand, s0):
            wc = cand.shape[1]
            if wc <= 4 * kp:
                return sel_full(best_h, best_i, cand, s0)
            pad = (-wc) % wblk
            cp = F.pad(cand, (0, pad), value=inf) if pad else cand
            nb = (wc + pad) // wblk
            bm = cp.reshape(b, nb, wblk).amin(dim=2)
            sblk = min(kp, nb)
            _, bsel = top_k_smallest(bm, sblk)
            col = (bsel[:, :, None] * wblk + torch.arange(wblk, device=device)).reshape(
                b, sblk * wblk)
            sub = torch.gather(cp, 1, col)
            cat_d = torch.cat([best_h, sub], dim=1)
            cat_i = torch.cat([best_i, col + s0], dim=1)
            bh, p = top_k_smallest(cat_d, kp)
            return bh, torch.gather(cat_i, 1, p)

        return sel

    def sel_none(best_h, best_i, cand, s0):
        # running elementwise min only — the floor: no candidate set
        wc = cand.shape[1]
        pad = (-wc) % kp
        if pad:
            cand = F.pad(cand, (0, pad), value=inf)
        folded = cand.reshape(b, -1, kp).amin(dim=1)
        return torch.minimum(best_h, folded), best_i

    print(
        f"shape: M={m} d={d} B={b} k={k} kprime={kp} "
        f"chunks={sum((w + _STREAM_CHUNK - 1)//_STREAM_CHUNK for w in depth_sizes)} "
        f"depths={len(depth_sizes)}"
    )

    def variant(with_alive, select):
        return lambda q: stream(q, with_alive, select)

    sums = {
        "full": timed("full covertree_stream_search", full),
        "fullwidth": timed("stream+fullwidth select", variant(True, sel_full)),
        "blockmin16": timed("stream+blockmin16 select", variant(True, make_sel_blockmin(16))),
        "blockmin64": timed("stream+blockmin64 select", variant(True, make_sel_blockmin(64))),
        "none": timed("stream+no select (floor)", variant(True, sel_none)),
        "no_alive_blockmin16": timed("stream no-alive blockmin16",
                                     variant(False, make_sel_blockmin(16))),
    }
    ref = sums["fullwidth"]
    rel = {name: abs(sums[name] - ref) / max(abs(ref), 1e-30)
           for name in ("blockmin16", "blockmin64")}
    print_check(sums=sums, rel_diff_to_fullwidth=rel)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
