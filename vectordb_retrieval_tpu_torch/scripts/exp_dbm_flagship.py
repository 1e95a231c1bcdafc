"""Kernel K1 at the flagship shape (100k x 384, B = 256) by block width:
its f32 mode (exact search's stage 1) and its bf16 mode (the IVF stream's),
milliseconds and effective GB/s over the payload's bytes, at w 8, 16 and 32.

The counterpart of the JAX package's ``scripts/exp_dbm_flagship.py``: the
same module constants (``N``, ``D``, ``B``, ``ITERS``), inputs (NumPy seed
0, the corpus padded to a multiple of ``8 w`` rows with +inf pens, as the
JAX package pads it) and printed lines, then one ``check`` line
(``scripts/probes.print_check``): whether every block that holds real
rows came out finite, and
each width's times. The JAX script's second loop, over the VMEM tile
budget, sweeps a Mosaic knob with no counterpart here (K1's tiles are
fixed 128 x 128 ``wgmma`` tiles): one line a width. Timing: the JAX script
chains ``ITERS`` passes in one ``scan``; here one untimed pass, then
``ITERS`` passes on the device with one synchronise and one copy of the
last result (the minima summed to one value a query, as the JAX script's
chain consumes them) to the host inside the clock
(``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_dbm_flagship [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.scripts.probes import pad_rows, print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

N, D, B = 100_000, 384, 256
ITERS = 32
WIDTHS = (8, 16, 32)


def make_inputs() -> Tuple[np.ndarray, np.ndarray]:
    """The corpus ``[N, D]`` and queries ``[B, D]`` (seed 0, as drawn by
    the JAX script)."""
    rng = np.random.default_rng(0)
    db = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    return db, q


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    db_np, q_np = make_inputs()
    db = torch.as_tensor(db_np, device=device)
    q = torch.as_tensor(q_np, device=device)
    dbb = db.to(torch.bfloat16)
    xn = torch.sum(db * db, dim=-1)
    finite, ms = True, {}
    for w in WIDTHS:
        s = pad_rows(N, w)
        dbp = F.pad(db, (0, 0, 0, s - N))
        dbpb = F.pad(dbb, (0, 0, 0, s - N))
        pen = F.pad(xn, (0, s - N), value=float("inf")).reshape(-1, w)
        times = []
        for payload in (dbp, dbpb):
            # each pass's minima summed to one value a query before the
            # clock's copy to the host, as the JAX script's chain consumes them
            _, dt = timed_passes(
                lambda qq, p=payload: torch.sum(kernels.dist_blockmin(qq, p, pen, w=w), dim=1),
                q, ITERS, device)
            times.append(dt / ITERS * 1e3)
            # the blocks holding real rows (the padding's blocks are +inf)
            out = kernels.dist_blockmin(q, payload, pen, w=w)[:, : -(-N // w)]
            finite = finite and bool(torch.isfinite(out).all())
        t32, tb16 = times
        gbs32 = N * D * 4 / t32 / 1e6
        gbs16 = N * D * 2 / tb16 / 1e6
        print(
            f"w={w:2d}  "
            f"f32 {t32:6.3f} ms ({gbs32:5.0f} GB/s)   "
            f"bf16 {tb16:6.3f} ms ({gbs16:5.0f} GB/s)",
            flush=True,
        )
        ms[str(w)] = {"f32": t32, "bf16": tb16}
    print_check(finite=finite, ms=ms)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
