"""Lloyd k-means on the device: the trainer of the IVF coarse quantizer.

Counterpart of ``vectordb_retrieval_tpu/ops/kmeans.py``, with the same
defaults and rules: init from ``k`` distinct random points, empty clusters
keep their previous centroid, ``spherical=True`` renormalises the
centroids every iteration, and FAISS-style training subsampling
(``MAX_POINTS_PER_CENTROID``) is applied by the caller.

Each iteration assigns every point with the hand-written kernel
:func:`~vectordb_retrieval_tpu_torch.ops.kernels.assign` (its plain version
on CPU tensors) and updates the centroids with the JAX package's one-hot
product ``one_hot(assign).T @ x`` over row chunks: a plain matrix product,
so the sums, and with them the centroids, are the same from run to run
(an atomic scatter-add would not be).

Random draws come from a ``torch.Generator`` on the CPU seeded with the
JAX package's integers (``seed``, ``seed ^ 0x5EED``). They are not
``jax.random``'s draws, so builds agree with the JAX package in recall and
cost, not bit for bit; :func:`_lloyd` runs from a given init, for tests
that start both packages from the same centroids.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vectordb_retrieval_tpu_torch.ops import kernels

DEFAULT_ITERS = 20
MAX_POINTS_PER_CENTROID = 256
_CHUNK = 16_384


def _permutation(n: int, seed: int) -> torch.Tensor:
    """A seeded permutation of ``range(n)`` (CPU generator, so the card and
    the host draw the same rows)."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    return torch.randperm(n, generator=gen)


def _normalize(c: torch.Tensor) -> torch.Tensor:
    return c / torch.clamp(torch.linalg.norm(c, dim=1, keepdim=True), min=1e-12)


def _lloyd(
    x: torch.Tensor,
    init: torch.Tensor,
    iters: int = DEFAULT_ITERS,
    spherical: bool = False,
    chunk: int = _CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd steps from ``init``; returns ``(centroids, cost)``,
    the cost being the summed squared distance of the last assignment."""
    k, d = init.shape
    n = x.shape[0]
    centroids = init
    cost = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        ids, dmin = kernels.assign(x, centroids)
        sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
        counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
        for c0 in range(0, n, chunk):
            onehot = F.one_hot(ids[c0 : c0 + chunk], k).to(torch.float32)
            sums += onehot.T @ x[c0 : c0 + chunk]
            counts += onehot.sum(dim=0)
        cost = dmin.sum()
        new = torch.where(
            counts[:, None] > 0,
            sums / torch.clamp(counts[:, None], min=1.0),
            centroids,
        )
        centroids = _normalize(new) if spherical else new
    return centroids, cost


def kmeans_fit(
    x: torch.Tensor,
    k: int,
    seed: int = 0,
    iters: int = DEFAULT_ITERS,
    spherical: bool = False,
    chunk: int = _CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit ``k`` centroids to ``x [N, d]``; returns ``(centroids, cost)``.

    Init = ``k`` distinct points drawn with ``seed``. ``spherical=True``
    renormalises centroids each iteration (cosine / inner-product training).
    """
    n = x.shape[0]
    perm = _permutation(n, seed)[:k].to(x.device)
    init = x[perm]
    if spherical:
        init = _normalize(init)
    return _lloyd(x, init, iters, spherical, chunk)


def kmeans_assign(
    x: torch.Tensor, centroids: torch.Tensor, chunk: Optional[int] = None
) -> torch.Tensor:
    """Nearest-centroid id per row of ``x`` (int64)."""
    return kernels.assign(x, centroids, chunk_rows=chunk)[0]


def kmeans_assign2(
    x: torch.Tensor, centroids: torch.Tensor, chunk: int = _CHUNK
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two nearest centroids per row: ``(a1 [n], a2 [n], margin [n])``.

    ``margin = d2 - d1``, the squared-L2 gap between the runner-up and the
    winner (the block graph's spilled assignment clones the rows with the
    smallest margin). Plain chunked PyTorch, as the JAX package's is XLA:
    ``||x||^2 + ||c||^2 - 2 x.c`` per chunk, the winner the first minimum
    and the runner-up the first minimum of the rest (``lax.top_k``'s order
    among equal distances). Ids are int64.
    """
    n = x.shape[0]
    cn = torch.sum(centroids * centroids, dim=-1)
    a1s, a2s, margins = [], [], []
    for c0 in range(0, n, max(1, chunk)):
        xc = x[c0 : c0 + chunk]
        dist = torch.sum(xc * xc, dim=-1)[:, None] + cn[None, :] - 2.0 * (xc @ centroids.T)
        a1 = torch.argmin(dist, dim=1)
        d1 = torch.gather(dist, 1, a1[:, None])
        rest = dist.scatter(1, a1[:, None], float("inf"))
        a2 = torch.argmin(rest, dim=1)
        d2 = torch.gather(rest, 1, a2[:, None])
        a1s.append(a1)
        a2s.append(a2)
        margins.append((d2 - d1)[:, 0])
    if not a1s:
        empty = torch.empty((0,), dtype=torch.int64, device=x.device)
        return empty, empty.clone(), torch.empty((0,), dtype=torch.float32, device=x.device)
    return torch.cat(a1s), torch.cat(a2s), torch.cat(margins)


def training_sample(
    n: int, k: int, seed: int, max_ppc: int = MAX_POINTS_PER_CENTROID
) -> Optional[torch.Tensor]:
    """FAISS-style train subsample row ids (CPU int64), or None to use all
    points."""
    cap = k * max_ppc
    if n <= cap:
        return None
    return _permutation(n, seed ^ 0x5EED)[:cap]
