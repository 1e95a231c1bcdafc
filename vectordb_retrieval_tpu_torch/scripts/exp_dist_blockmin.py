"""Exact search's stage 1 by kernel K1 against the plain scan, then the
selections and the full path built on it, at the SIFT-1M shape.

Measures, at 1M x 128, k 100, w 32 (or the options' shape):
  1. the plain stage 1: ``ops/distances.pairwise_distances`` over the exact
     path's row chunks, then the block minimum
  2. K1 f32 (``ops/kernels.dist_blockmin``, 3xTF32)
  3. K1 bf16 (the IVF stream's mode)
  4. + selection: K1, then the top ``k + 16`` blocks
  5. the full path: K1, selection, block gather and exact rescore
  6. - 9. the same with a hierarchical (superblock) selection, a
     split-column selection, the split selection merged by a sort, and
     the hierarchical selection over 4-wide member rows
then each full path's distances against ``ops/distances.exact_search``.
It bears on ``ops/distances._select_blocks``.

The counterpart of the JAX package's ``scripts/exp_dist_blockmin.py``: the
same options (``--device`` for ``--platform``), inputs (NumPy seed 0, the
corpus padded to a multiple of ``8 w`` rows as in the JAX script, so the
block ids match) and printed lines (the JAX script's labels, "xla" and
"pallas" naming its two routes), then one ``check`` line
(``scripts/probes.print_check``) with the five agreements.
``approx_max_k`` / ``top_k`` are ``top_k_smallest``, ``lax.sort`` with one
key a stable sort and a gather. Timing: the JAX script chains ``--iters``
passes in one ``fori_loop``; here one untimed pass, then ``--iters`` passes
on the device with one synchronise and one copy of the last result to the
host inside the clock (``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_dist_blockmin \\
        [--n 1000000] [--d 128] [--b 256] [--k 100] [--iters 8] [--w 32] \\
        [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.scripts.probes import pad_rows, print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

SF = 4  # superblock factor of the hierarchical selections
P = 4  # column parts of the split selections


def make_inputs(n: int, d: int, b: int, w: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The queries ``[b, d]``, the corpus padded with zero rows to ``S``
    (a multiple of ``8 w``) and its pens ``[S]`` (+inf past ``n``), seed 0
    as the JAX script draws them (the corpus first)."""
    rng = np.random.default_rng(0)
    s = pad_rows(n, w)
    db = rng.standard_normal((n, d), dtype=np.float32)
    dbp = np.zeros((s, d), np.float32)
    dbp[:n] = db
    xn = np.full((s,), np.inf, np.float32)
    xn[:n] = (db * db).sum(1)
    q = rng.standard_normal((b, d), dtype=np.float32)
    return q, dbp, xn


def rescore(q, dbp, blk, n, k, w):
    """The blocks' rows rescored by the difference form: ``(vals, ids)``."""
    b, nb = blk.shape
    d = dbp.shape[1]
    bvecs = dbp.reshape(-1, w, d)[blk]  # [B, nb, w, d]
    diff = bvecs - q[:, None, None, :]
    cd = torch.sum(diff * diff, dim=-1).reshape(b, nb * w)
    cand = (blk[:, :, None] * w + torch.arange(w, device=q.device)).reshape(b, nb * w)
    cd = torch.where(cand < n, cd, torch.inf)
    vals, sel = dops.top_k_smallest(cd, k)
    return vals, torch.gather(cand, 1, sel)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--w", type=int, default=32)
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n, d, b, k, w, iters = args.n, args.d, args.b, args.k, args.w, args.iters
    q_np, dbp_np, xn_np = make_inputs(n, d, b, w)
    s = dbp_np.shape[0]
    q0 = torch.as_tensor(q_np, device=device)
    db_j = torch.as_tensor(dbp_np, device=device)
    db16 = db_j.to(torch.bfloat16)
    xn = torch.as_tensor(xn_np, device=device)
    pen = xn.reshape(s // w, w)
    nb = k + 16
    ng = s // w

    def time_fn(name, fn):
        _, dt = timed_passes(fn, q0, iters, device)
        dt /= iters
        print(f"{name:<34s} {dt*1e3:8.2f} ms/pass ({b/dt:10.1f} QPS)", flush=True)

    # 1. the plain stage 1 over the exact path's row chunks
    chunk = dops.clamp_chunk(min(262_144, max(4096, (1 << 26) // b)), n, align=max(512, w))
    chunk = max(w, (chunk // w) * w)
    nc = -(-n // chunk)
    pad = nc * chunk - n
    dbx = F.pad(db_j[:n], (0, 0, 0, pad)).reshape(nc, chunk, d)
    penx = F.pad(xn[:n], (0, pad), value=float("inf")).reshape(nc, chunk)

    def xla_stage1(q):
        bms = [torch.amin(dops.pairwise_distances(q, dbx[c], "l2", penx[c])
                          .reshape(b, chunk // w, w), dim=-1) for c in range(nc)]
        return torch.sum(torch.cat(bms, dim=1), dim=1)

    time_fn("xla stage1 (HIGH scan)", xla_stage1)
    del dbx, penx

    # 2/3. K1, the minima only
    time_fn("pallas f32 3-pass",
            lambda q: torch.sum(kernels.dist_blockmin(q, db_j, pen, w=w), dim=1))
    time_fn("pallas bf16",
            lambda q: torch.sum(kernels.dist_blockmin(q, db16, pen, w=w), dim=1))

    # 4. + selection
    def pl_sel(q):
        v, blk = dops.top_k_smallest(kernels.dist_blockmin(q, db_j, pen, w=w), nb)
        return v[:, 0] + blk[:, 0].float()

    time_fn("pallas f32 + selection", pl_sel)

    # 5. the full path: kernel + selection + block gather + rescore
    def pl_full_vi(q):
        _, blk = dops.top_k_smallest(kernels.dist_blockmin(q, db_j, pen, w=w), nb)
        return rescore(q, db_j, blk, n, k, w)

    # 6. hierarchical selection: superblock minima -> top-nb superblocks ->
    #    their blocks' minima -> top-nb blocks -> rescore
    def pl_hier_vi(q):
        bm = kernels.dist_blockmin(q, db_j, pen, w=w)
        sb = torch.amin(bm.reshape(b, ng // SF, SF), dim=-1)
        _, sblk = dops.top_k_smallest(sb, nb)
        mem = (sblk[:, :, None] * SF + torch.arange(SF, device=device)).reshape(b, nb * SF)
        _, msel = dops.top_k_smallest(torch.gather(bm, 1, mem), nb)
        return rescore(q, db_j, torch.gather(mem, 1, msel), n, k, w)

    # 7. split-column selection: [B, G] -> [B P, G/P], one batched top-nb,
    #    then the P nb part-candidates merged by a small top-nb
    gp = -(-ng // P)

    def parts(q):
        bm = kernels.dist_blockmin(q, db_j, pen, w=w)
        bmp = F.pad(bm, (0, P * gp - ng), value=float("inf")).reshape(b * P, gp)
        pv, pi = dops.top_k_smallest(bmp, nb)
        gblk = (pi.reshape(b, P, nb)
                + torch.arange(P, device=device)[None, :, None] * gp).reshape(b, P * nb)
        return pv.reshape(b, P * nb), gblk

    def pl_split_vi(q):
        pv, gblk = parts(q)
        _, msel = dops.top_k_smallest(pv, nb)
        return rescore(q, db_j, torch.gather(gblk, 1, msel), n, k, w)

    # 8. the split selection merged by a sort of (value, block) pairs
    def pl_sort_vi(q):
        pv, gblk = parts(q)
        _, order = torch.sort(pv, dim=-1, stable=True)
        return rescore(q, db_j, torch.gather(gblk, 1, order)[:, :nb], n, k, w)

    # 9. hierarchical over 4-wide member rows, merged by a sort
    def pl_hier4_vi(q):
        bm4 = kernels.dist_blockmin(q, db_j, pen, w=w).reshape(b, ng // SF, SF)
        _, sblk = dops.top_k_smallest(torch.amin(bm4, dim=-1), nb)
        mv = torch.gather(bm4, 1, sblk[:, :, None].expand(b, nb, SF)).reshape(b, nb * SF)
        mem = (sblk[:, :, None] * SF + torch.arange(SF, device=device)).reshape(b, nb * SF)
        _, order = torch.sort(mv, dim=-1, stable=True)
        return rescore(q, db_j, torch.gather(mem, 1, order)[:, :nb], n, k, w)

    fulls = (("pallas f32 FULL exact proto", pl_full_vi), ("pallas f32 FULL hier-sel", pl_hier_vi),
             ("pallas f32 FULL split-sel", pl_split_vi), ("pallas f32 FULL sortmerge", pl_sort_vi),
             ("pallas f32 FULL hier4-sort", pl_hier4_vi))
    vals = []
    for label, fn in fulls:
        time_fn(label, lambda q, fn=fn: (lambda vi: vi[0][:, 0] + vi[1][:, 0].float())(fn(q)))
        vals.append(fn(q0)[0].cpu().numpy())

    # correctness against the exact path
    v_ref, _ = dops.exact_search(q0, db_j[:n], k, metric="l2", device=device)
    v_ref = v_ref.cpu().numpy()
    agree = {name: float(np.mean(np.abs(v - v_ref) < 1e-3))
             for name, v in zip(("full", "hier-sel", "split-sel", "sortmerge", "hier4-sort"), vals)}
    print(f"distance agreement vs exact_search: {agree['full']:.6f}")
    print(f"hier-sel distance agreement:        {agree['hier-sel']:.6f}")
    print(f"split-sel distance agreement:       {agree['split-sel']:.6f}")
    for nm in ("sortmerge", "hier4-sort"):
        print(f"{nm} distance agreement:       {agree[nm]:.6f}")
    print_check(agreement=agree)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
