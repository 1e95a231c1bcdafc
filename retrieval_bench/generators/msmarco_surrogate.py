"""The MS MARCO MiniLM-L6-v2 surrogate: unit 384-d rows, cosine.

A frozen NumPy copy of the draws of ``_load_msmarco_surrogate`` in
``vectordb_retrieval_tpu_torch/data/datasets.py`` (the calibrated recipe:
a power-law spectrum in a random basis, Zipf-occupied topic clusters with
per-cluster radii, stray points, queries drawn near the clusters), without
its ground truth. ``generate(seed, n, queries, **options)`` gives the
``train_vectors`` / ``test_vectors`` that loader gives for the options
``{"seed": seed, "train_limit": n, "test_size": queries, **options}``.
With ``pool_seed`` the queries come from a generator of their own, seeded
with it, over the same clusters: another pool for one corpus.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def generate(
    seed: int,
    n: int,
    queries: int,
    pool_seed=None,
    dim: int = 384,
    anisotropy: float = 0.45,
    n_parents: int = 384,
    children_per_parent: int = 8,
    child_scale: float = 0.9,
    point_scale: float = 0.55,
    query_scale: float = 0.8,
    zipf: float = 0.45,
    spectrum_align: float = 0.0,
    cluster_var: float = 0.0,
    radius_var: float = 0.85,
    tail_df: float = 0.0,
    outlier_frac: float = 0.03,
    outlier_scale: float = 6.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(corpus [n, dim], queries [queries, dim])`` float32 unit rows."""
    d = dim
    rng = np.random.default_rng(seed)

    def scatter(*shape: int) -> np.ndarray:
        if tail_df > 2.0:
            out = rng.standard_t(tail_df, size=shape)
            out /= np.sqrt(tail_df / (tail_df - 2.0))
            return out.astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    spectrum = (np.arange(1, d + 1, dtype=np.float32)) ** (-anisotropy)
    spectrum /= np.sqrt(np.mean(spectrum**2))
    basis, _ = np.linalg.qr(rng.standard_normal((d, d)))
    if spectrum_align:
        basis = (1.0 - spectrum_align) * basis + spectrum_align * np.eye(d)
        basis /= np.maximum(np.linalg.norm(basis, axis=0, keepdims=True), 1e-12)
    basis = (basis * spectrum[None, :]).astype(np.float32)

    parents = rng.standard_normal((n_parents, d)).astype(np.float32)
    children = (
        parents[:, None, :]
        + child_scale
        * rng.standard_normal((n_parents, children_per_parent, d)).astype(np.float32)
    ).reshape(n_parents * children_per_parent, d)
    ranks = np.arange(1, children.shape[0] + 1, dtype=np.float64)
    probs = ranks**-zipf
    probs /= probs.sum()
    if cluster_var:
        shapes = np.exp(cluster_var * rng.standard_normal((children.shape[0], d))).astype(
            np.float32
        )
        shapes /= np.sqrt(np.mean(shapes**2, axis=1, keepdims=True))
    else:
        shapes = np.ones((children.shape[0], d), np.float32)
    if radius_var:
        radii = np.exp(radius_var * rng.standard_normal(children.shape[0])).astype(np.float32)
        radii /= np.sqrt(np.mean(radii**2))
        shapes = shapes * radii[:, None]
    assign = rng.choice(children.shape[0], size=n, p=probs)
    point_mult = np.ones((n, 1), np.float32)
    if outlier_frac > 0.0:
        stray = rng.random(n) < outlier_frac
        point_mult[stray] = outlier_scale
    pts = children[assign] + point_scale * point_mult * shapes[assign] * scatter(n, d)
    if pool_seed is not None:
        rng = np.random.default_rng(pool_seed)
    q_assign = rng.choice(children.shape[0], size=queries, p=probs)
    qs = children[q_assign] + query_scale * shapes[q_assign] * scatter(queries, d)

    def shape(v: np.ndarray) -> np.ndarray:
        v = v @ basis.T
        return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)

    return np.ascontiguousarray(shape(pts)), np.ascontiguousarray(shape(qs))
