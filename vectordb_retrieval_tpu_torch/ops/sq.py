"""Scalar quantization (SQ8): per-dimension uint8 affine codes.

Counterpart of ``vectordb_retrieval_tpu/ops/sq.py``. ``sq_encode`` rounds
half to even, as ``jnp.round`` does, so the same ``x`` gives bit-identical
codes in both packages. ``sq_search`` is the bare ``SQ8`` index's scan:
decode a chunk, one f32 product against the queries, running top-k.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops

_SCAN_CHUNK = 65_536


def sq_train(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-dim ``(vmin, step)``: FAISS QT_8bit-style min/max range fit."""
    vmin = torch.amin(x, dim=0)
    vmax = torch.amax(x, dim=0)
    # XLA folds the JAX package's ``/ 255.0`` into a product with the f32
    # reciprocal; multiplying here keeps ``step``, and so the codes,
    # bit-identical to it
    step = torch.clamp(vmax - vmin, min=1e-12) * (1.0 / 255.0)
    return vmin, step


def sq_encode(x: torch.Tensor, vmin: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    q = torch.round((x - vmin[None, :]) / step[None, :])
    return torch.clamp(q, 0, 255).to(torch.uint8)


def sq_decode(codes: torch.Tensor, vmin: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    return vmin[None, :] + codes.to(torch.float32) * step[None, :]


def sq_search(
    queries: torch.Tensor,
    codes: torch.Tensor,
    vmin: torch.Tensor,
    step: torch.Tensor,
    code_sqnorms: torch.Tensor,
    k: int,
    chunk: int = _SCAN_CHUNK,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over SQ8 codes: decode chunk -> f32 product -> running top-k."""
    n = codes.shape[0]
    b = queries.shape[0]
    chunk = dops.clamp_chunk(chunk, n)
    dev = queries.device
    qn = torch.sum(queries * queries, dim=-1)
    best_d = torch.full((b, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        dots = queries @ sq_decode(codes[c0:c1], vmin, step).T
        if metric == "l2":
            dist = qn[:, None] + code_sqnorms[None, c0:c1] - 2.0 * dots
        else:
            dist = -dots
        ids = torch.arange(c0, c1, dtype=torch.int64, device=dev)
        cat_d = torch.cat([best_d, dist], dim=1)
        cat_i = torch.cat([best_i, ids.expand(b, -1)], dim=1)
        best_d, sel = dops.top_k_smallest(cat_d, k)
        best_i = torch.gather(cat_i, 1, sel)
    return best_d, best_i
