"""K1 f32 against its matmul floor (K5), and K1 f32 by block width.

At a given (n, d, b, w): the full kernel (K1 f32, ``ops/kernels.
dist_blockmin``: distance, pen and block minimum), then the matmul floor
(K5, ``ops/kernels.matmul_floor``: K1 f32's 3xTF32 products of every row
at the same shapes, with no pen and no minimum, in a kernel of its own
built the card's way: TMA into an mbarrier ring fed by a producer warp),
so that K1 f32's time less K5's is what K1 loses to the card's product
loop, epilogue included, then K1 at the other widths. Run at the flagship
shape (100k x 384, w 8) and the SIFT shape (``--n 1000000 --d 128 --w
32``).

The counterpart of the JAX package's ``scripts/exp_dbm_tune.py``: the same
options, inputs (NumPy seed 0, the corpus padded to ``S`` rows by the JAX
rule, a multiple of ``8 w``, with +inf pens) and printed lines, then one
``check`` line (``scripts/probes.print_check``): the floor against its
plain version, relative to the largest |dot|, and each line's times. What
the JAX script sweeps of Mosaic has no counterpart here: the floor's tile
(the CUDA kernel walks fixed 128-row tiles, so the floor runs at every
``S``; the JAX script skips it where ``S`` is not a multiple of its VMEM
tile) and the transposed output (K1 writes ``[B, S/w]`` directly). The
width sweep keeps the JAX script's own skip, ``S % (8 w2) != 0``. Timing:
the JAX script chains ``--iters`` passes in one ``fori_loop``; here one
untimed pass, then ``--iters`` passes on the device with one synchronise
and one copy of the last result (summed to one value a query, as the JAX
script's chain consumes it) to the host inside the clock
(``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_dbm_tune \\
        [--n 100000] [--d 384] [--b 256] [--w 8] [--iters 24] [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.scripts.probes import pad_rows, print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

WIDTHS = (8, 16, 32, 64)


def make_inputs(n: int, d: int, b: int, w: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The padded corpus ``[S, d]``, its pens ``[S]`` (+inf past ``n``) and
    the queries ``[b, d]`` (seed 0, as the JAX script draws them)."""
    rng = np.random.default_rng(0)
    s = pad_rows(n, w)
    db = np.zeros((s, d), np.float32)
    db[:n] = rng.standard_normal((n, d), dtype=np.float32)
    pen = np.full((s,), np.inf, np.float32)
    pen[:n] = (db[:n] * db[:n]).sum(1)
    q = rng.standard_normal((b, d), dtype=np.float32)
    return db, pen, q


def timed(name: str, fn, q: torch.Tensor, iters: int, device: torch.device) -> float:
    _, dt = timed_passes(fn, q, iters, device)
    dt /= iters
    print(f"{name:<40s} {dt*1e3:8.2f} ms/pass", flush=True)
    return dt


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--w", type=int, default=8)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n, d, b, w = args.n, args.d, args.b, args.w
    db_np, pen_np, q_np = make_inputs(n, d, b, w)
    s = db_np.shape[0]
    db = torch.as_tensor(db_np, device=device)
    pen = torch.as_tensor(pen_np, device=device)
    q0 = torch.as_tensor(q_np, device=device)
    gbytes = s * d * 4 / 1e9
    ms = {}

    # each pass's result is reduced to one value a query before the clock's
    # copy to the host, as the JAX script's chain consumes it
    def full(q, w=w):
        return torch.sum(kernels.dist_blockmin(q, db, pen.reshape(s // w, w), w=w), dim=1)

    dt = timed(f"full kernel w={w}", full, q0, args.iters, device)
    print(f"  -> {gbytes/dt:.0f} GB/s effective")
    ms[f"full w={w}"] = dt * 1e3

    dt2 = timed("matmul floor", lambda q: torch.sum(kernels.matmul_floor(q, db, w), dim=0), q0,
                args.iters, device)
    print(f"  -> {gbytes/dt2:.0f} GB/s effective")
    ms["floor"] = dt2 * 1e3

    for w2 in WIDTHS:
        if w2 == w or s % (8 * w2):
            continue
        dt3 = timed(f"full kernel w={w2}", lambda q, w2=w2: full(q, w2), q0, args.iters, device)
        ms[f"full w={w2}"] = dt3 * 1e3

    floor = kernels.matmul_floor(q0, db, w)
    ref = kernels.matmul_floor_reference(q0, db, w)
    scale = max(float(ref.abs().max()), np.finfo(np.float32).tiny)
    print_check(shape=[b, s, d, w], floor_rel_err=float((floor - ref).abs().max()) / scale,
                floor_finite=bool(torch.isfinite(floor).all()), ms=ms)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
