"""The GloVe-50 surrogate: 50-d word-vector-like rows (searched here under
cosine, as ann-benchmarks' ``glove-50-angular``).

A frozen NumPy copy of the draws of ``_load_glove50_surrogate`` in
``vectordb_retrieval_tpu_torch/data/datasets.py`` (the calibrated recipe:
Zipf-weighted hierarchical clusters, an optional anisotropic spectrum, a
common mean offset and a log-normal radial spread rescaled to a mean norm),
without its ground truth. ``generate(seed, n, queries, **options)`` gives
the ``train_vectors`` / ``test_vectors`` that loader gives for the options
``{"seed": seed, "train_limit": n, "test_size": queries, **options}``: the
loader draws corpus and queries as one set and splits it by a permutation.
With ``pool_seed`` the corpus is the same, and the queries come from a
generator of their own, seeded with it, by the same recipe over the same
clusters (the offset and the scale the corpus draw fixed): another pool for
one corpus.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

D = 50


def generate(
    seed: int,
    n: int,
    queries: int,
    pool_seed=None,
    anisotropy: float = 0.0,
    n_parents: int = 160,
    children_per_parent: int = 6,
    child_scale: float = 1.2,
    point_scale: float = 1.7,
    mean_norm: float = 4.4,
    background_frac: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(corpus [n, 50], queries [queries, 50])`` float32 rows."""
    d = D
    rng = np.random.default_rng(seed)
    total = n + queries
    spectrum = (np.arange(1, d + 1, dtype=np.float32)) ** (-anisotropy)
    spectrum /= np.sqrt(np.mean(spectrum**2))

    parents = rng.standard_normal((n_parents, d)).astype(np.float32)
    children = (
        parents[:, None, :]
        + child_scale
        * rng.standard_normal((n_parents, children_per_parent, d)).astype(np.float32)
    ).reshape(n_parents * children_per_parent, d)
    ranks = np.arange(1, children.shape[0] + 1, dtype=np.float64)
    probs = ranks**-0.85
    probs /= probs.sum()

    def draw(g: np.random.Generator, count: int) -> np.ndarray:
        assign = g.choice(children.shape[0], size=count, p=probs)
        return children[assign] + point_scale * g.standard_normal((count, d)).astype(np.float32)

    def background(g: np.random.Generator, pts: np.ndarray, bg_scale) -> None:
        n_bg = int(pts.shape[0] * background_frac)
        rows = g.choice(pts.shape[0], size=n_bg, replace=False)
        pts[rows] = bg_scale * g.standard_normal((n_bg, d)).astype(np.float32)

    pts = draw(rng, total)
    bg_scale = None
    if background_frac > 0:
        bg_scale = float(np.linalg.norm(pts, axis=1).mean()) / np.sqrt(d)
        background(rng, pts, bg_scale)
    pts *= spectrum[None, :]
    mu_dir = rng.standard_normal(d).astype(np.float32) * spectrum
    mu_dir /= np.linalg.norm(mu_dir)
    offset = 0.35 * np.linalg.norm(pts, axis=1).mean() * mu_dir[None, :]
    pts += offset
    radial = rng.lognormal(0.0, 0.28, size=total).astype(np.float32)
    pts *= radial[:, None]
    scale = mean_norm / np.linalg.norm(pts, axis=1).mean()
    pts *= scale

    perm = rng.permutation(total)
    corpus = np.ascontiguousarray(pts[perm[:n]])
    if pool_seed is None:
        return corpus, np.ascontiguousarray(pts[perm[n:]])
    g = np.random.default_rng(pool_seed)
    qs = draw(g, queries)
    if background_frac > 0:
        background(g, qs, bg_scale)
    qs *= spectrum[None, :]
    qs += offset
    qs *= g.lognormal(0.0, 0.28, size=queries).astype(np.float32)[:, None]
    qs *= scale
    return corpus, np.ascontiguousarray(qs)
