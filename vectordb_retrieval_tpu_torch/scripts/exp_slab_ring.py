"""Kernel K2's milliseconds a wave and effective bandwidth at the block
beam's two wave shapes: msmarco-like (512 queries x 96 popped slabs of 128
x 384 bf16 over 784 slabs) and SIFT-like (256 x 96 of 128 x 128 bf16 over
7,816 slabs). Effective GB/s counts every pair's slab bytes, as the JAX
script does; K2 reads each distinct popped slab once.

The counterpart of the JAX package's ``scripts/exp_slab_ring.py``: the same
module constant ``REPEATS``, shapes (``SHAPES``), inputs (NumPy seed 0 a
shape) and printed lines, then one ``check`` line
(``scripts/probes.print_check``): each shape's first wave against
``ops/kernels.slab_dots_reference``, relative to the largest |dot|, and
its times. The JAX script sweeps the depth of its manual-DMA ring (8-64);
K2 groups the pairs by slab and loads each slab once into shared memory,
with no ring: one line a shape. Timing: the JAX script scans the
``REPEATS`` waves in one ``jit``; here one untimed stream of the waves,
then one timed stream on the device with one synchronise and one copy of
the waves' maxima (the JAX script's consume) to the host inside the clock
(``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_slab_ring [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

REPEATS = 16
# (label, B, W, Nb, L, d), bf16 slabs
SHAPES = (("msmarco", 512, 96, 784, 128, 384), ("sift1m", 256, 96, 7816, 128, 128))


def make_inputs(b: int, w: int, nb: int, length: int, d: int) -> Tuple[np.ndarray, ...]:
    """The slabs ``[nb, length, d]`` (f32 draws, stored as bf16), the
    queries ``[REPEATS, b, d]`` and the popped ids ``[REPEATS, b, w]``
    (seed 0 a shape, in the JAX script's order)."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((nb, length, d)).astype(np.float32)
    queries = rng.standard_normal((REPEATS, b, d)).astype(np.float32)
    sels = rng.integers(0, nb, size=(REPEATS, b, w)).astype(np.int32)
    return vecs, queries, sels


def run_shape(label, b, w, nb, length, d, device) -> dict:
    vecs_np, q_np, s_np = make_inputs(b, w, nb, length, d)
    vecs = torch.as_tensor(vecs_np, device=device).to(torch.bfloat16)
    queries = torch.as_tensor(q_np, device=device)
    sels = torch.as_tensor(s_np, device=device)
    slab_bytes = b * w * length * d * vecs.element_size()
    print(f"\n== {label}: B={b} W={w} L={length} d={d} bfloat16 "
          f"({slab_bytes/1e6:.0f} MB/wave) ==")

    def stream(qs):  # each wave consumed by its maximum, as in the JAX script
        return torch.stack([kernels.slab_dots(qs[r], vecs, sels[r]).amax()
                            for r in range(REPEATS)]).sum()

    _, dt = timed_passes(stream, queries, 1, device)
    gbps = slab_bytes * REPEATS / dt / 1e9
    ms = dt / REPEATS * 1e3
    print(f"{ms:7.2f} ms/wave  {gbps:7.1f} GB/s effective")
    out = kernels.slab_dots(queries[0], vecs, sels[0])
    ref = kernels.slab_dots_reference(queries[0], vecs, sels[0])
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if err > 1e-5 * scale:
        print(f"  !! mismatch vs the plain version: maxrelerr={err / scale:.3g}")
    return {"ms": ms, "gbps": gbps, "max_abs_err": err, "max_abs_plain": scale}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    print("devices:", [name])
    shapes = {label: run_shape(label, *shape, device) for label, *shape in SHAPES}
    print_check(shapes=shapes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
