"""Vector helpers on host arrays.

A copy of ``vectordb_retrieval_tpu/utils/vector_utils.py``: the same NumPy
arithmetic, so the same inputs give bit-identical results in both packages.
Distances follow the framework's conventions: squared l2, negated dot for
ip and cosine.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def normalize_vectors(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """L2-normalise rows of a host array."""
    x = np.asarray(x, dtype=np.float32)
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norms, eps)


def compute_distance(a: np.ndarray, b: np.ndarray, metric: str = "l2") -> float:
    """Distance between two vectors: ``l2`` -> squared Euclidean;
    ``ip``/``cosine`` -> negated (normalised) dot product."""
    a = np.asarray(a, dtype=np.float32).ravel()
    b = np.asarray(b, dtype=np.float32).ravel()
    if metric == "l2":
        d = a - b
        return float(np.dot(d, d))
    if metric == "ip":
        return float(-np.dot(a, b))
    if metric == "cosine":
        na = a / max(np.linalg.norm(a), 1e-12)
        nb = b / max(np.linalg.norm(b), 1e-12)
        return float(-np.dot(na, nb))
    raise ValueError(f"unknown metric {metric!r}")


def random_unit_vectors(
    n: int, dim: int, seed: Optional[int] = None
) -> np.ndarray:
    """Uniform random points on the unit sphere."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return normalize_vectors(x)
