"""Product quantisation: codebook training, encoding, ADC search, OPQ and
per-list residual rotations.

Counterpart of ``vectordb_retrieval_tpu/ops/pq.py`` with the same contracts
and defaults (``KSUB = 256`` codes a subspace, uint8 codes, ``[m, ksub,
dsub]`` f32 codebooks):

* :func:`pq_train` fits one codebook per subspace with the port's own
  :func:`~vectordb_retrieval_tpu_torch.ops.kmeans.kmeans_fit` (every
  subspace from the same ``seed``, as the JAX package's ``vmap`` does), so
  each Lloyd step assigns with the hand-written kernel
  :func:`~vectordb_retrieval_tpu_torch.ops.kernels.assign` at
  ``d = dsub``, ``K = 256``;
* :func:`pq_encode` is the chunked ``cmd,mkd->cmk`` product and the first
  argmin; :func:`pq_reconstruct` decodes by gather (the JAX package's
  ``pq_reconstruct_gather``; its one-hot product is a TPU idiom and gives
  the same f32 values: one nonzero term);
* :func:`pq_search` is the flat ADC scan with a running top-k;
* :func:`opq_train` alternates PQ training with an orthogonal Procrustes
  step (Ge et al.); :func:`train_per_list_rotations` learns one block-
  diagonal rotation per coarse list against ONE shared codebook, and
  :func:`rotation_gain` is the held-out A/B behind ``pq_rotations='auto'``.

Every f32 product here runs with TF32 off (the JAX package's f32 or
``Precision.HIGHEST``). Segment sums over lists (the rotations' covariances)
are per-list products over rows sorted by list, never atomics, so a build
is the same from run to run. Random draws are the k-means inits: a
``torch.Generator`` on the CPU, not ``jax.random``, so builds agree with the
JAX package in quantisation error and recall, not bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops.kmeans import kmeans_fit

KSUB = 256  # 8-bit codes, FAISS default
_ENCODE_CHUNK = 32_768
_SCAN_CHUNK = 65_536
# bounds the [chunk, m, ksub] f32 distance block of one encode step (the
# JAX chunk of 32,768 rows would take 6.4 GB at m = 192)
_ENCODE_BYTES = 256 << 20


def split_dim(d: int, m: int) -> int:
    if d % m != 0:
        raise ValueError(f"dimension {d} not divisible by m={m} subquantizers")
    return d // m


def pq_train(
    x: torch.Tensor, m: int, ksub: int = KSUB, seed: int = 0, iters: int = 20
) -> torch.Tensor:
    """Train per-subspace codebooks ``[m, ksub, dsub]``: one k-means a
    subspace, each initialised from the same ``seed``."""
    n, d = x.shape
    dsub = split_dim(d, m)
    if n < ksub:
        raise ValueError(f"pq_train needs at least ksub={ksub} rows, got {n}")
    books = []
    for j in range(m):
        sub = x[:, j * dsub : (j + 1) * dsub].contiguous()
        books.append(kmeans_fit(sub, ksub, seed=seed, iters=iters)[0])
    return torch.stack(books)


def pq_encode(
    x: torch.Tensor, codebooks: torch.Tensor, chunk: int = _ENCODE_CHUNK
) -> torch.Tensor:
    """Encode ``x [N, d]`` -> ``codes [N, m] uint8`` (nearest sub-centroid
    under ``||c||^2 - 2 x.c``, the first on ties)."""
    n = x.shape[0]
    m, ksub, dsub = codebooks.shape
    cb_sqn = torch.sum(codebooks * codebooks, dim=-1)  # [m, ksub]
    rows = max(1, min(chunk, _ENCODE_BYTES // (m * ksub * 4)))
    codes = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    for c0 in range(0, n, rows):
        xc = x[c0 : c0 + rows].reshape(-1, m, dsub)
        dots = torch.einsum("cmd,mkd->cmk", xc, codebooks)
        dist = cb_sqn[None] - 2.0 * dots  # ||x||^2 is constant per row
        codes[c0 : c0 + rows] = torch.argmin(dist, dim=-1).to(torch.uint8)
    return codes


def pq_reconstruct(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Decode ``codes [C, m]`` -> ``x_hat [C, m*dsub]`` f32 by gather."""
    m = codebooks.shape[0]
    sub = torch.arange(m, device=codes.device)
    return codebooks[sub[None, :], codes.long()].reshape(codes.shape[0], -1)


def pq_code_sqnorms(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """``||x_hat||^2 [N]`` from codes: built once, stored with the index."""
    cb_sqn = torch.sum(codebooks * codebooks, dim=-1)  # [m, ksub]
    sub = torch.arange(codebooks.shape[0], device=codes.device)
    return torch.sum(cb_sqn[sub[None, :], codes.long()], dim=1)


def opq_train(
    x: torch.Tensor,
    m: int,
    ksub: int = KSUB,
    seed: int = 0,
    iters: int = 12,
    opq_iters: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """OPQ: a rotation ``R [d, d]`` and codebooks ``[m, ksub, dsub]``
    minimising quantisation error. Alternates: hold ``R``, train and encode
    PQ on ``x @ R``; hold the codes, solve the orthogonal Procrustes
    problem ``R = U V^T`` from ``svd(x^T x_hat)``."""
    d = x.shape[1]
    r = torch.eye(d, dtype=torch.float32, device=x.device)
    for _ in range(opq_iters):
        y = x @ r
        cb = pq_train(y, m, ksub=ksub, seed=seed, iters=iters)
        y_hat = pq_reconstruct(pq_encode(y, cb), cb)
        u, _, vt = torch.linalg.svd(x.T @ y_hat, full_matrices=False)
        r = u @ vt
    return r, pq_train(x @ r, m, ksub=ksub, seed=seed, iters=iters)


# ---------------------------------------------------------------------------
# Per-list block-diagonal residual rotations (the JAX package's IVF-PQ
# recall lever): every coarse list l gets an orthogonal R_l of nb blocks of
# [bs, bs]; residuals encode as PQ(R_l r) against ONE shared codebook and
# decode applies R_l^T. Training alternates shared-codebook PQ with a
# Procrustes step per (list, block), from a PCA + eigenvalue-allocation
# init.
# ---------------------------------------------------------------------------


def polar_orthogonalize(c: torch.Tensor) -> torch.Tensor:
    """Batched orthogonal polar factor ``U V^T`` of ``c [..., bs, bs]`` by
    SVD (its null-space completion of a rank-deficient input is still
    Procrustes-optimal); near-zero inputs keep the identity."""
    bs = c.shape[-1]
    eye = torch.eye(bs, dtype=torch.float32, device=c.device)
    norm = torch.sqrt(torch.sum(c * c, dim=(-2, -1), keepdim=True))
    u, _, vt = torch.linalg.svd(c / torch.clamp(norm, min=1e-20), full_matrices=True)
    ok = norm[..., 0, 0] > 1e-12
    return torch.where(ok[..., None, None], u @ vt, eye)


def _as_blocks(x: torch.Tensor, bs: int) -> torch.Tensor:
    n, d = x.shape
    if d % bs:
        raise ValueError(f"dimension {d} not divisible by rotation block {bs}")
    return x.reshape(n, d // bs, bs)


def rotate_blocks(x: torch.Tensor, rot_rows: torch.Tensor) -> torch.Tensor:
    """``y_i = blockdiag(rot_rows[i]) @ x_i``, each row with its own
    rotation blocks ``rot_rows [N, nb, bs, bs]``."""
    y = torch.einsum("nbf,nbef->nbe", _as_blocks(x, rot_rows.shape[-1]), rot_rows)
    return y.reshape(x.shape)


def unrotate_blocks(y: torch.Tensor, rot_rows: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rotate_blocks` (the orthogonal transpose)."""
    x = torch.einsum("nbe,nbef->nbf", _as_blocks(y, rot_rows.shape[-1]), rot_rows)
    return x.reshape(y.shape)


class _ListRows:
    """Rows grouped by coarse list: a stable sort by list id, and each
    list's slice of the sorted rows (one host read of the counts). Segment
    sums become one product per list over contiguous rows: deterministic,
    with no ``[N, nb, bs, bs]`` per-row transient."""

    def __init__(self, assignments: torch.Tensor, nlist: int):
        a = assignments.long()
        self.order = torch.argsort(a, stable=True)
        counts = torch.bincount(a, minlength=nlist)[:nlist]
        self.counts = counts
        bounds = [0] + torch.cumsum(counts, 0).tolist()
        self.spans: List[Tuple[int, int, int]] = [
            (l, bounds[l], bounds[l + 1]) for l in range(nlist) if bounds[l + 1] > bounds[l]
        ]

    def rotate(self, x: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
        """Every row rotated by its list's blocks (``rotate_blocks`` with
        ``rots[assignment]``), in the original row order."""
        bs = rots.shape[-1]
        xs = _as_blocks(x[self.order], bs)
        ys = torch.empty_like(xs)
        for l, s, e in self.spans:
            ys[s:e] = torch.einsum("nbf,bef->nbe", xs[s:e], rots[l])
        y = torch.empty_like(x)
        y[self.order] = ys.reshape(-1, x.shape[1])
        return y

    def outer_sums(self, a: torch.Tensor, b: torch.Tensor, nlist: int, bs: int) -> torch.Tensor:
        """``out[l, blk] = sum_{i in l} a_i,blk b_i,blk^T`` ``[nlist, nb,
        bs, bs]`` (zero for empty lists)."""
        ab = _as_blocks(a[self.order], bs)
        bb = _as_blocks(b[self.order], bs)
        out = torch.zeros((nlist, ab.shape[1], bs, bs), dtype=torch.float32, device=a.device)
        for l, s, e in self.spans:
            out[l] = torch.einsum("nbe,nbf->bef", ab[s:e], bb[s:e])
        return out


def _pca_init(cov: torch.Tensor, counts: torch.Tensor, d: int, m: int, bs: int) -> torch.Tensor:
    """Each list's block rotated to its principal frame (rows = axes,
    variance-descending, each eigenvector's largest-|entry| made positive),
    its axes then permuted so log-eigenvalue mass is balanced greedily
    across the subquantizers inside the block; lists with fewer than ``bs``
    rows keep the identity."""
    eig, v = torch.linalg.eigh(cov)  # ascending
    eig = torch.flip(eig, dims=(-1,))
    v = torch.flip(v, dims=(-1,))  # columns: principal axes, descending
    pick = torch.argmax(torch.abs(v), dim=-2, keepdim=True)
    v = v * torch.sign(torch.gather(v, -2, pick))
    rot = v.transpose(-1, -2)  # rows = axes: y = V^T r
    dsub = d // m
    if bs % dsub == 0 and bs > dsub:
        msub = bs // dsub  # subquantizers inside one rotation block
        logs = torch.log(torch.clamp(eig, min=1e-12))
        lead = eig.shape[:-1]
        cap = torch.zeros(lead + (msub,), dtype=torch.int64, device=cov.device)
        load = torch.zeros(lead + (msub,), dtype=torch.float32, device=cov.device)
        perm = torch.zeros(lead + (bs,), dtype=torch.int64, device=cov.device)
        for i in range(bs):
            s = torch.argmin(torch.where(cap < dsub, load, float("inf")), dim=-1, keepdim=True)
            pos = s * dsub + torch.gather(cap, -1, s)
            perm.scatter_(-1, pos, i)
            cap.scatter_(-1, s, torch.gather(cap, -1, s) + 1)
            load.scatter_(-1, s, torch.gather(load, -1, s) + logs[..., i : i + 1])
        rot = torch.gather(rot, -2, perm[..., None].expand(lead + (bs, bs)))
    eye = torch.eye(bs, dtype=torch.float32, device=cov.device)
    return torch.where((counts >= bs)[:, None, None, None], rot, eye)


def train_per_list_rotations(
    residuals: torch.Tensor,
    assignments: torch.Tensor,
    nlist: int,
    m: int,
    bs: int,
    ksub: int = KSUB,
    seed: int = 0,
    iters: int = 12,
    alt_iters: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rotations [nlist, nb, bs, bs], codebooks [m, ksub, dsub])``, the
    codebooks trained on the FINAL rotated residuals (use the pair
    together: encode ``PQ(R_l r)``, decode ``R_l^T``).

    Init: each list's block covariance to its principal frame with the
    eigenvalue allocation (:func:`_pca_init`). Then ``alt_iters`` rounds:
    train and encode the shared codebook on the rotated residuals, sum
    ``C = y_hat y^T`` per (list, block) in the rotated frame, and compose
    the incremental Procrustes ``polar(C) @ R``.
    """
    d = residuals.shape[1]
    if d % bs:
        raise ValueError(f"dimension {d} not divisible by rotation block {bs}")
    groups = _ListRows(assignments, nlist)
    cov = groups.outer_sums(residuals, residuals, nlist, bs)
    rot = _pca_init(cov, groups.counts, d, m, bs)
    for _ in range(alt_iters):
        y = groups.rotate(residuals, rot)
        cb = pq_train(y, m, ksub=ksub, seed=seed, iters=iters)
        y_hat = pq_reconstruct(pq_encode(y, cb), cb)
        upd = polar_orthogonalize(groups.outer_sums(y_hat, y, nlist, bs))
        rot = upd @ rot
    y = groups.rotate(residuals, rot)
    return rot, pq_train(y, m, ksub=ksub, seed=seed, iters=iters)


def auto_rotation_block(d: int) -> int:
    """Largest preferred rotation block dividing ``d`` (else ``d``)."""
    for bs in (128, 96, 64, 48, 32, 16, 8):
        if d % bs == 0:
            return bs
    return d


def rotation_gain(
    residuals: torch.Tensor,
    assignments: torch.Tensor,
    nlist: int,
    m: int,
    bs: int,
    seed: int = 0,
    iters: int = 12,
    holdout: int = 8,
) -> Tuple[float, float, float, torch.Tensor, torch.Tensor]:
    """Held-out reconstruction A/B of per-list rotations against one shared
    codebook: ``(gain, err_plain, err_rot, rots, cb_rot)``.

    Rows with ``i % holdout == 0`` are held out and both codings train on
    the rest; ``gain = 1 - err_rot / err_plain`` on the held-out per-row
    MSE (the rotations are orthogonal, so the rotated-frame error is the
    original-frame error). ``(rots, cb_rot)`` is the trained rotated coding.
    """
    n = residuals.shape[0]
    val = (torch.arange(n, device=residuals.device) % holdout) == 0
    r_tr, a_tr = residuals[~val], assignments[~val]
    r_va, a_va = residuals[val], assignments[val].long()

    cb_plain = pq_train(r_tr, m, seed=seed, iters=iters)
    rots, cb_rot = train_per_list_rotations(r_tr, a_tr, nlist, m, bs, seed=seed, iters=iters)

    def _mse(rows, cb):
        err = rows - pq_reconstruct(pq_encode(rows, cb), cb)
        return float(torch.mean(torch.sum(err * err, dim=-1)))

    err_plain = _mse(r_va, cb_plain)
    err_rot = _mse(rotate_blocks(r_va, rots[a_va.clamp(0, nlist - 1)]), cb_rot)
    gain = 1.0 - err_rot / max(err_plain, 1e-30)
    return float(gain), err_plain, err_rot, rots, cb_rot


def pq_encode_rotated(
    residuals: torch.Tensor,
    assignments: torch.Tensor,
    rotations: torch.Tensor,
    codebooks: torch.Tensor,
) -> torch.Tensor:
    """Encode ``PQ(R_{assign[i]} r_i)``, rotating the rows list by list
    (no per-row ``[N, nb, bs, bs]`` rotation gather)."""
    nlist = rotations.shape[0]
    groups = _ListRows(assignments.long().clamp(0, nlist - 1), nlist)
    return pq_encode(groups.rotate(residuals, rotations), codebooks)


def pq_search(
    queries: torch.Tensor,
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    code_sqnorms: torch.Tensor,
    k: int,
    chunk: int = _SCAN_CHUNK,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC top-k over PQ codes ``(dists [B, k], ids [B, k] int64)``,
    streamed over chunks of reconstructions with a running top-k merge.

    ``l2`` scores ``||q||^2 + ||x_hat||^2 - 2 q.x_hat``; ``ip`` (and cosine
    after normalisation) scores ``-q.x_hat``. One f32 product a chunk.
    """
    n = codes.shape[0]
    b = queries.shape[0]
    dev = queries.device
    chunk = dops.clamp_chunk(chunk, n)
    qn = torch.sum(queries * queries, dim=-1)
    best_d = torch.full((b, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        dots = queries @ pq_reconstruct(codes[c0:c1], codebooks).T
        if metric == "l2":
            dist = qn[:, None] + code_sqnorms[None, c0:c1] - 2.0 * dots
        else:
            dist = -dots
        ids = torch.arange(c0, c1, dtype=torch.int64, device=dev)
        best_d, sel = dops.top_k_smallest(torch.cat([best_d, dist], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, ids.expand(b, -1)], dim=1), 1, sel)
    return best_d, best_i
