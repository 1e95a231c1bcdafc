"""The SIFT1M surrogate: 128-d non-negative integer-valued rows.

A frozen NumPy copy of the draws of
``vectordb_retrieval_tpu_torch/scripts/make_sift1m_surrogate.py``: the same
generator, parents, children, Zipf weights and row recipe, the base rows in
chunks of 250,000 and then the queries, so ``generate(seed, n, queries)``
gives the bytes that script writes for ``--seed seed --n n --queries
queries``. It keeps the rows in memory and writes no file.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

CHUNK = 250_000


def _rows(rng, n, children, probs, point_scale):
    d = children.shape[-1]
    assign = rng.choice(children.shape[0], size=n, p=probs)
    pts = children[assign] + point_scale * rng.standard_normal((n, d), dtype=np.float32)
    pts = np.maximum(pts, 0.0)
    norms = np.linalg.norm(pts, axis=1, keepdims=True)
    pts = pts / np.maximum(norms, 1e-6) * 512.0
    pts *= rng.normal(1.0, 0.03, size=(n, 1)).astype(np.float32)
    return np.round(np.clip(pts, 0, 255)).astype(np.float32)


def generate(seed: int, n: int, queries: int, pool_seed=None) -> Tuple[np.ndarray, np.ndarray]:
    """``(base [n, 128], queries [queries, 128])`` float32 from ``seed``
    (the queries from ``pool_seed`` where given)."""
    rng = np.random.default_rng(seed)
    d = 128
    n_parents, children_per = 256, 16
    parents = np.maximum(rng.standard_normal((n_parents, d), dtype=np.float32) + 0.3, 0.0)
    support = rng.random((n_parents, d)) < 0.55
    parents *= support
    children = (
        parents[:, None, :]
        + 0.45 * rng.standard_normal((n_parents, children_per, d), dtype=np.float32)
    ).reshape(n_parents * children_per, d)
    ranks = np.arange(1, children.shape[0] + 1, dtype=np.float64)
    probs = ranks**-0.7
    probs /= probs.sum()
    base = np.empty((n, d), dtype=np.float32)
    for start in range(0, n, CHUNK):
        stop = min(start + CHUNK, n)
        base[start:stop] = _rows(rng, stop - start, children, probs, 0.6)
    if pool_seed is not None:
        rng = np.random.default_rng(pool_seed)
    pool = _rows(rng, queries, children, probs, 0.6)
    return base, pool
