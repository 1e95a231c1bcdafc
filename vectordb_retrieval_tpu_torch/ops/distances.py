"""Pairwise distances, top-k and exact search — the load-bearing compute path.

PyTorch counterpart of ``vectordb_retrieval_tpu/ops/distances.py``: the same
functions, constants and conventions, on tensors of any device.

Distance conventions (FAISS-compatible):
  * ``l2``     -> squared Euclidean distance (ascending = better)
  * ``ip``     -> negated inner product      (ascending = better)
  * ``cosine`` -> negated cosine similarity; both sides are L2-normalised

:func:`exact_search` takes one of three paths: a dense ``[B, N]`` product
and top-k for small databases, and above ``_DENSE_PATH_MAX_ROWS`` rows the
blockmin certificate path, whose stage 1 is the hand-written kernel
:func:`~vectordb_retrieval_tpu_torch.ops.kernels.dist_blockmin` (its plain
version on CPU tensors). ``_exact_search_streamed`` is the running-top-k
scan kept for callers that bound memory by chunks.

Precision: f32 matrix products run in full FP32 (TF32 off, see
``utils/device.py``); stage 1's kernel forms f32-class products by 3xTF32
(``ops/kernels.split_tf32``), never plain TF32. Exact rescoring is an elementwise f32 difference sum,
never a product: the expansion ``||q||^2+||x||^2-2qx`` loses ~1e-3 relative
precision to cancellation, enough to flip near-ties at the top-k boundary.
The blockmin path's stage 3 is the kernel
:func:`~vectordb_retrieval_tpu_torch.ops.kernels.block_rescore`, which keeps
this rule.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device
from vectordb_retrieval_tpu_torch.utils.profiling import span

METRICS = ("l2", "ip", "cosine")

# Below this many database rows the full [B, N] distance matrix is
# materialised in one shot; above it the blockmin certificate path runs.
_DENSE_PATH_MAX_ROWS = 32_768
# Rows per step of the streamed scan.
DEFAULT_CHUNK_ROWS = 262_144


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")


def clamp_chunk(chunk: int, n: int, align: int = 512) -> int:
    """Never let a streaming chunk exceed the (aligned) dataset size."""
    aligned_n = -(-max(n, 1) // align) * align
    return max(align, min(chunk, aligned_n))


def _to_device(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise rows (cosine preprocessing)."""
    norms = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norms, min=eps)


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms ``[N]`` — precompute once per database."""
    return torch.sum(x * x, dim=-1)


def pairwise_distances(
    queries: torch.Tensor,
    database: torch.Tensor,
    metric: str = "l2",
    db_sqnorms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense ``[B, N]`` distance matrix (ascending = closer).

    ``cosine`` assumes *both* sides are already unit-normalised (callers
    normalise the database once at build time and queries per batch).
    """
    _check_metric(metric)
    dots = queries @ database.T
    if metric == "l2":
        qn = torch.sum(queries * queries, dim=-1)
        xn = db_sqnorms if db_sqnorms is not None else sq_norms(database)
        d = qn[:, None] + xn[None, :].float() - 2.0 * dots
        return torch.clamp(d, min=0.0)
    return -dots


def _gather_rows(database: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``database[ids]`` for ``ids [B, K]`` (negative ids read row 0)."""
    return database[torch.where(ids >= 0, ids, torch.zeros_like(ids))]


def rescore(
    queries: torch.Tensor, database: torch.Tensor, ids: torch.Tensor, metric: str
) -> torch.Tensor:
    """Exact rescoring of candidate ids under any metric (elementwise f32)."""
    if metric == "l2":
        return rescore_l2(queries, database, ids)
    vecs = _gather_rows(database, ids)
    d = -torch.sum(vecs * queries[:, None, :], dim=-1)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def rescore_l2(
    queries: torch.Tensor, database: torch.Tensor, ids: torch.Tensor
) -> torch.Tensor:
    """Cancellation-free squared-L2 rescoring of candidate ids:
    ``sum((q - x)^2)`` over the gathered rows, exact to f32 rounding."""
    diff = _gather_rows(database, ids) - queries[:, None, :]
    d = torch.sum(diff * diff, dim=-1)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def refine_topk_l2(
    queries: torch.Tensor, database: torch.Tensor, ids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank a top-k candidate list with accurate L2 distances."""
    d = rescore_l2(queries, database, ids)
    nd, sel = top_k_smallest(d, d.shape[1])
    return nd, torch.gather(ids, 1, sel)


def top_k_smallest(
    distances: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Values/indices (int64) of the k smallest entries per row, ascending.
    The order among tied values is unspecified: compare distances."""
    return torch.topk(distances, k, dim=1, largest=False, sorted=True)


def top_k_smallest_by_id(
    vals: torch.Tensor, ids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of ``vals [B, M]`` (f32), equal
    values taken in ascending ``ids`` (int64 in ``[0, 2^32)``, distinct in
    a row, ``[B, M]`` or ``[1, M]``): ``(values, positions)`` ``[B, k]``.

    A top-k's own tie order differs between the card and the host; one
    top-k over int64 keys (the value's order-preserving bits, then the id)
    has no ties, so both keep the same entries. With column indices for
    ``ids`` it keeps the lower index among equals, as ``jax.lax.top_k``
    does.
    """
    bits = (vals + 0.0).view(torch.int32).long()  # + 0.0: -0.0 -> +0.0
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # ordered like the floats
    _, pos = torch.topk((key << 32) | ids, k, dim=1, largest=False, sorted=True)
    return torch.gather(vals, 1, pos), pos


def _exact_search_dense(
    queries: torch.Tensor,
    database: torch.Tensor,
    db_sqnorms: Optional[torch.Tensor],
    k: int,
    metric: str,
    refine_to: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    d = pairwise_distances(queries, database, metric, db_sqnorms)
    dists, ids = top_k_smallest(d, k)
    if refine_to is not None and metric == "l2":
        dists, ids = refine_topk_l2(queries, database, ids)
        dists, ids = dists[:, :refine_to], ids[:, :refine_to]
    return dists, ids


def _exact_search_streamed(
    queries: torch.Tensor,
    database: torch.Tensor,
    db_sqnorms: Optional[torch.Tensor],
    k: int,
    metric: str,
    chunk_rows: int,
    refine_to: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stream database chunks with a running top-k merge."""
    n = database.shape[0]
    b = queries.shape[0]
    dev = queries.device
    xn = None
    if metric == "l2":
        xn = db_sqnorms if db_sqnorms is not None else sq_norms(database)
    best_d = torch.full((b, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk_rows):
        c1 = min(c0 + chunk_rows, n)
        d = pairwise_distances(
            queries, database[c0:c1], metric, None if xn is None else xn[c0:c1]
        )
        ids = torch.arange(c0, c1, dtype=torch.int64, device=dev)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, ids.expand(b, -1)], dim=1)
        best_d, sel = top_k_smallest(cat_d, k)
        best_i = torch.gather(cat_i, 1, sel)
    if refine_to is not None and metric == "l2":
        best_d, best_i = refine_topk_l2(queries, database, best_i)
        best_d, best_i = best_d[:, :refine_to], best_i[:, :refine_to]
    return best_d, best_i


REFINE_OVERFETCH = 16
_BLOCKMIN_WIDTH = 8
_BLOCKMIN_SLACK = 16
# Wider blocks trade (k+slack)*w rescore rows for an N/w-times-narrower
# selection; the certificate holds at any width. The rule keeps the
# blockmin row near 32k columns, clamped to [8, 32].
_BLOCKMIN_WIDTH_CAP = 32


def blockmin_width(n: int) -> int:
    """Blockmin width for an ``n``-row database."""
    w = _BLOCKMIN_WIDTH
    while w < _BLOCKMIN_WIDTH_CAP and n > 32_768 * w:
        w *= 2
    return w


# Wide-row block selection goes hierarchical: superblock minima (factor
# _SEL_SF), top-nb superblocks, then sort their nb*_SEL_SF member blocks by
# value. Certificate: any (super)block containing a true top-k element has
# min <= d_k at both levels.
_SEL_FLAT_MAX = 8192
_SEL_SF = 4


def _select_blocks(bmins: torch.Tensor, nb: int) -> torch.Tensor:
    """Top-``nb`` block ids per row of the blockmin matrix ``[B, G]``."""
    b, g = bmins.shape
    if g <= _SEL_FLAT_MAX or nb * _SEL_SF >= g:
        _, blk = top_k_smallest(bmins, nb)
        return blk
    sf = _SEL_SF
    gpad = -(-g // sf) * sf
    bmp = F.pad(bmins, (0, gpad - g), value=float("inf")) if gpad != g else bmins
    bm4 = bmp.reshape(b, gpad // sf, sf)
    _, sblk = top_k_smallest(bm4.amin(dim=-1), nb)  # [B, nb] superblocks
    mvals = torch.gather(bm4, 1, sblk[:, :, None].expand(b, nb, sf))
    mem = (
        sblk[:, :, None] * sf + torch.arange(sf, device=bmins.device)
    ).reshape(b, nb * sf)
    order = torch.argsort(mvals.reshape(b, nb * sf), dim=-1, stable=True)
    return torch.gather(mem, 1, order[:, :nb])


def _blockmin_blocks(
    queries: torch.Tensor,
    database: torch.Tensor,
    db_sqnorms: Optional[torch.Tensor],
    k: int,
    metric: str,
    chunk_rows: int,
    w: int = _BLOCKMIN_WIDTH,
    slack: int = _BLOCKMIN_SLACK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 1 and 2 of :func:`_exact_search_blockmin`: ``(payload, blk)``,
    the database padded to whole ``w``-row blocks (``[S, d]``) and the top
    ``k+slack`` block ids of each query (``[B, nb]`` int64)."""
    n = database.shape[0]
    dev = database.device
    s = kernels.dist_blockmin_pad_rows(n, w)
    payload = F.pad(database, (0, 0, 0, s - n)) if s != n else database
    if metric == "l2":
        xn = db_sqnorms if db_sqnorms is not None else sq_norms(database)
        pen = xn.float()
    else:
        # the kernel scores pen - 2*dot: rank-equal to the -dot convention
        # (positive scale); exact values come from the rescore
        pen = torch.zeros((n,), dtype=torch.float32, device=dev)
    if s != n:
        # +inf pens keep padded rows out of every block minimum
        pen = F.pad(pen, (0, s - n), value=float("inf"))
    bmins = kernels.dist_blockmin(
        queries.contiguous(), payload.contiguous(),
        pen.reshape(-1, w).contiguous(), w=w, chunk_rows=chunk_rows,
    )  # [B, S/w]
    nb = min(k + slack, bmins.shape[1])
    return payload, _select_blocks(bmins, nb)


def _exact_search_blockmin(
    queries: torch.Tensor,
    database: torch.Tensor,
    db_sqnorms: Optional[torch.Tensor],
    k: int,
    metric: str,
    chunk_rows: int,
    w: int = _BLOCKMIN_WIDTH,
    slack: int = _BLOCKMIN_SLACK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k via the blockmin certificate (large-N path).

    (1) ``kernels.dist_blockmin`` computes per-``w``-row block minima of the
    shifted scores; the ``[B, N]`` matrix never reaches device memory
    (``chunk_rows`` bounds the plain version's score block on the CPU).
    (2) the top ``k+slack`` blocks per query provably contain every true
    top-k element (any block holding one has blockmin <= d_k, and at most
    k-1 blocks rank strictly below it — ``slack`` absorbs exact ties).
    (3) ``kernels.block_rescore`` rescores those blocks whole, exactly
    (elementwise f32), reading each once.
    """
    payload, blk = _blockmin_blocks(queries, database, db_sqnorms, k, metric,
                                    chunk_rows, w, slack)
    with span("vrt.rescore"):
        # ip/cosine: the negated dot (cosine's rows are normalised)
        cd, cand = kernels.block_rescore(
            queries.contiguous(), payload.contiguous(), blk, database.shape[0], w,
            "l2" if metric == "l2" else "ip",
        )  # [B, nb*w] each; padding rows +inf / -1
        vals, sel = top_k_smallest(cd, k)
        ids = torch.gather(cand, 1, sel)
        ids = torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))
    return vals, ids


def exact_search(
    queries,
    database,
    k: int,
    metric: str = "l2",
    db_sqnorms=None,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    refine: bool = False,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN: ``(dists[B, k], ids[B, k])``, ascending distance.

    Inputs (tensors or arrays) are moved to ``device`` (``None``: the CUDA
    card, raising when there is none). Dense path for small databases,
    blockmin certificate path for large ones.

    ``refine=True`` (l2, dense path) overfetches candidates and re-ranks them
    with the cancellation-free rescore so near-ties at the k boundary
    resolve exactly; the blockmin path rescores exactly by construction and
    ignores it.
    """
    _check_metric(metric)
    dev = resolve_device(device)
    queries = _to_device(queries, dev)
    database = _to_device(database, dev)
    if db_sqnorms is not None:
        db_sqnorms = _to_device(db_sqnorms, dev)
    n = database.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds database size {n}")
    refine_to: Optional[int] = None
    fetch_k = k
    if refine and metric == "l2":
        refine_to = k
        fetch_k = min(k + REFINE_OVERFETCH, n)
    if n <= _DENSE_PATH_MAX_ROWS:
        return _exact_search_dense(
            queries, database, db_sqnorms, fetch_k, metric, refine_to
        )
    # bound the plain stage 1's transient [B, chunk] score block to ~256 MB
    b = queries.shape[0]
    budget = max(4096, (1 << 26) // max(b, 1))
    return _exact_search_blockmin(
        queries, database, db_sqnorms, k, metric, min(chunk_rows, budget),
        w=blockmin_width(n),
    )
