"""Cover-tree exact k-NN: depth-synchronous descents over a depth-major slab.

Counterpart of ``vectordb_retrieval_tpu/ops/covertree.py`` with the same
constants, contracts and certificates. The tree is stored depth-major
(``models/covertree.depth_slab_layout``): every BFS depth is one contiguous
block of the slab, padded with inert rows to a multiple of ``SLAB_ALIGN``,
and each node records its parent's position within the parent's depth.

Two descents, one result (:class:`CoverTreeSearchResult`):

  * :func:`covertree_stream_search` walks the nodes depth by depth: a dense
    f32 product of the queries with each depth's slice (in column chunks
    of ``_STREAM_CHUNK``), an alive mask carried from parent to child, the
    prune test ``d_lo(q, v) - r(v) > kth_ub`` and a folded kth upper bound
    over ``[B, kprime]`` slots. No kernel.
  * :func:`covertree_blockwalk_search` first runs one fused blockmin
    product over a bf16 copy of the whole slab with two pens (kernel K1,
    :func:`~vectordb_retrieval_tpu_torch.ops.kernels.dist_blockmin_pair`,
    bf16 mode, one launch): block minima over all non-inert nodes and over
    real nodes only.
    The descent then runs on ``[B, M/w]`` block arrays; a block's aliveness
    is the inclusive OR over its parents' block range, two gathers of an
    exclusive cumulative sum.

Both end alike: one top-``(k+16)`` selection of candidate blocks, a gather of
those whole blocks from the f32 slab, an exact rescore in difference form,
and a certificate that flags (``overflow``) every query whose rescored kth
distance is not provably below every unselected block. The caller re-runs
flagged queries with exact search, so exactness is never lost silently.

The numeric band: a dot product of bf16-rounded inputs with f32 sums differs
from the exact one by at most ``err_c * |q| * |x|`` (``DEFAULT_ERR_C`` =
6e-3, about 1.5x the worst nearest-rounding bound at d = 384). The port's K1
bf16 mode rounds the f32 queries to bf16 exactly as the TPU kernel casts
them and forms exact products with f32 sums, so the band carries over. The
stream walk's products run in plain f32 (TF32 stays off), well inside it.

``ndis`` counts algorithmically required distance evaluations per query:
alive nodes in the stream walk, the non-inert nodes of alive blocks in the
block walk.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.ops.distances import blockmin_width, top_k_smallest

_INF = float("inf")


class CoverTreeSearchResult(NamedTuple):
    dists: torch.Tensor  # [B, k] exact L2 distances (not squared), ascending
    ids: torch.Tensor  # [B, k] database rows (int32), -1 where none
    ndis: torch.Tensor  # [B] scored distance evaluations
    overflow: torch.Tensor  # [B] bool: certificate failed, result may be inexact
    iters: int  # depths walked


# certified bound on |dot_bf16(q, x) - dot(q, x)| / (|q| |x|) (module docstring)
DEFAULT_ERR_C = 6e-3

# column chunk of the stream walk: bounds its [B, chunk] f32 transients. Must
# stay a multiple of the largest blockmin width (32).
_STREAM_CHUNK = 131_072

# depth blocks of the slab are padded to this width, so every chunk start is
# blockmin-aligned and candidate blocks are contiguous [w, d] slabs; the
# blockmin widths 8, 16 and 32 all divide it
SLAB_ALIGN = 32

# candidate blocks selected beyond k (as exact search's blockmin slack)
_BLOCK_SLACK = 16


def _check_layout(m: int, depth_sizes: Sequence[int], w: int) -> None:
    off = 0
    for wd in depth_sizes:
        if off % w or wd % w:
            raise ValueError(
                f"depth block at offset {off} (width {wd}) is not aligned "
                f"to blockmin width {w}; rebuild the slab with "
                f"depth_slab_layout (SLAB_ALIGN={SLAB_ALIGN})"
            )
        off += wd
    if off != m:
        raise ValueError(f"depth_sizes sum {off} != slab rows {m}")


def _fold(best_f: torch.Tensor, cand: torch.Tensor, kp: int) -> torch.Tensor:
    """Fold ``cand [B, W]`` into the ``[B, kp]`` running minimum: minima of
    disjoint column sets, so the kth smallest slot upper-bounds the kth
    smallest candidate (the JAX module's disjoint-slot argument)."""
    pad = (-cand.shape[1]) % kp
    cf = F.pad(cand, (0, pad), value=_INF) if pad else cand
    return torch.minimum(best_f, cf.reshape(cand.shape[0], -1, kp).amin(dim=1))


def rescore_blocks(
    queries: torch.Tensor,
    slab: torch.Tensor,
    is_real: torch.Tensor,
    point_ids: torch.Tensor,
    blk_idx: torch.Tensor,  # [B, s] selected block ids
    w: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the selected whole blocks from the f32 slab and rescore their
    real rows exactly (f32 difference form): ``(dists [B, k], ids [B, k])``,
    ids -1 where the distance is not finite."""
    b, s = blk_idx.shape
    g, dim = slab.shape[0] // w, slab.shape[1]
    bvecs = slab.reshape(g, w, dim)[blk_idx]  # [B, s, w, d], a fresh copy
    breal = is_real.reshape(g, w)[blk_idx]
    bpid = point_ids.reshape(g, w)[blk_idx]
    diff = bvecs.sub_(queries[:, None, None, :])
    d_ex = torch.sqrt(torch.sum(diff.mul_(diff), dim=-1))
    d_ex = torch.where(breal, d_ex, torch.full_like(d_ex, _INF)).reshape(b, s * w)
    out_d, sel = top_k_smallest(d_ex, k)
    out_i = torch.gather(bpid.reshape(b, s * w), 1, sel)
    out_i = torch.where(torch.isfinite(out_d), out_i, torch.full_like(out_i, -1))
    return out_d, out_i


def certify(
    out_d: torch.Tensor,
    t: torch.Tensor,  # [B] the s-th selected block value
    qn: torch.Tensor,
    max_xn: torch.Tensor,
    err_c: float,
    k: int,
) -> torch.Tensor:
    """``overflow [B]``: every real point outside the selected blocks has
    true ``d^2 >= t - 2 * band_max``; the result is exact iff the rescored
    kth clears that floor, or ``t`` is infinite (no candidate left out)."""
    floor2 = t - 4.0 * err_c * qn * max_xn
    kth_ex = out_d[:, k - 1]
    return ~((kth_ex * kth_ex <= floor2) | ~torch.isfinite(t))


def covertree_stream_search(
    queries: torch.Tensor,  # [B, d] f32
    slab: torch.Tensor,  # [M, d] f32 node points, depth-major aligned order
    point_ids: torch.Tensor,  # [M] int32 node -> db row
    is_real: torch.Tensor,  # [M] bool node contributes its point to top-k
    radii: torch.Tensor,  # [M] f32 exact subtree cover radii (<0 marks padding)
    parent_rel: torch.Tensor,  # [M] int32 parent position within its depth block
    depth_sizes: Tuple[int, ...],
    k: int,
    kprime: int,
    err_c: float = DEFAULT_ERR_C,
    block_w: int = 0,
) -> CoverTreeSearchResult:
    """Exact k-NN by the per-node depth walk (module docstring).

    ``depth_sizes`` are the padded per-depth widths of
    ``models/covertree.depth_slab_layout``; padding rows carry ``radii < 0``
    and ``is_real=False`` and are inert. ``kprime`` is the fold width of the
    running kth upper bound (any width is sound; wider prunes more).
    """
    b = queries.shape[0]
    m = slab.shape[0]
    w = block_w if block_w else blockmin_width(m)
    _check_layout(m, depth_sizes, w)
    assert _STREAM_CHUNK % w == 0
    dev = slab.device

    kp = max(int(kprime), k)
    qn2 = torch.sum(queries * queries, dim=-1)
    qn = torch.sqrt(qn2)
    best_f = torch.full((b, kp), _INF, dtype=torch.float32, device=dev)
    ndis = torch.zeros((b,), dtype=torch.int64, device=dev)
    kept_prev = torch.ones((b, 1), dtype=torch.bool, device=dev)  # the root's virtual parent
    max_xn = torch.sqrt(torch.max(torch.sum(slab * slab, dim=-1)))

    bm_parts = []  # per-chunk [B, wc/w] block minima of d2_hi
    off = 0
    for wd in depth_sizes:
        kept_parts = []
        for c0 in range(0, wd, _STREAM_CHUNK):
            wc = min(_STREAM_CHUNK, wd - c0)
            s0 = off + c0
            blk = slab[s0 : s0 + wc]
            r_blk = radii[s0 : s0 + wc]
            real_blk = is_real[s0 : s0 + wc]
            prel_blk = parent_rel[s0 : s0 + wc].long()

            bn2 = torch.sum(blk * blk, dim=-1)
            dot = queries @ blk.T  # plain f32 (TF32 off), inside the band
            d2 = qn2[:, None] + bn2[None, :] - 2.0 * dot
            band2 = (2.0 * err_c) * qn[:, None] * torch.sqrt(bn2)[None, :]
            d2_lo = torch.clamp(d2 - band2, min=0.0)
            d2_hi = d2 + band2

            alive = kept_prev[:, prel_blk]  # [B, wc]
            # padding rows (radius < 0, not real) are never alive or counted
            alive = alive & (real_blk | (r_blk >= 0.0))[None, :]
            ndis = ndis + alive.sum(dim=1)

            cand = torch.where(alive & real_blk[None, :], d2_hi,
                               torch.full_like(d2_hi, _INF))
            best_f = _fold(best_f, cand, kp)
            kth_ub = torch.sqrt(top_k_smallest(best_f, k)[0][:, k - 1])
            bm_parts.append(cand.reshape(b, wc // w, w).amin(dim=2))
            kept_parts.append(
                alive & (torch.sqrt(d2_lo) - r_blk[None, :] <= kth_ub[:, None])
            )
        kept_prev = kept_parts[0] if len(kept_parts) == 1 else torch.cat(kept_parts, 1)
        off += wd

    bm = bm_parts[0] if len(bm_parts) == 1 else torch.cat(bm_parts, 1)
    s = min(k + _BLOCK_SLACK, bm.shape[1])
    bm_sel, blk_idx = top_k_smallest(bm, s)
    out_d, out_i = rescore_blocks(queries, slab, is_real, point_ids, blk_idx, w, k)
    overflow = certify(out_d, bm_sel[:, -1], qn, max_xn, err_c, k)
    return CoverTreeSearchResult(out_d, out_i, ndis, overflow, len(depth_sizes))


class BlockWalkPrep(NamedTuple):
    """What the block walk derives from an artifact alone (once per built
    or loaded artifact, never per batch); ``G = M / w`` blocks."""

    w: int
    depth_sizes: Tuple[int, ...]
    slab_bf: torch.Tensor  # [M, d] bf16 copy of the slab (K1's payload)
    pen_all: torch.Tensor  # [G, w] ||x||^2 of non-inert nodes, +inf elsewhere
    pen_real: torch.Tensor  # [G, w] ||x||^2 of real nodes, +inf elsewhere
    rmax_blk: torch.Tensor  # [G] largest subtree radius of the block's nodes
    xnmax_blk: torch.Tensor  # [G] largest ||x||^2 of its nodes (0 if none)
    n_noninert_blk: torch.Tensor  # [G] int64 nodes in the block
    has_real_blk: torch.Tensor  # [G] bool
    has_node_blk: torch.Tensor  # [G] bool
    pblk_lo: torch.Tensor  # [G] int64 first parent block in the parent depth
    pblk_hi: torch.Tensor  # [G] int64 last parent block in the parent depth
    max_xn: torch.Tensor  # [] largest node norm

    def nbytes(self) -> int:
        return sum(
            int(t.numel() * t.element_size())
            for t in self if isinstance(t, torch.Tensor)
        )


def blockwalk_prep(
    slab: torch.Tensor,
    is_real: torch.Tensor,
    radii: torch.Tensor,
    parent_rel: torch.Tensor,
    depth_sizes: Tuple[int, ...],
    block_w: int = 0,
) -> BlockWalkPrep:
    """The bf16 slab, both pens and the per-block metadata of an artifact.

    The layout's depth blocks are multiples of ``w``, so ``M % w == 0`` and
    K1 needs no padding rows (``dist_blockmin_pad_rows(M, w) == M``).
    """
    m = slab.shape[0]
    w = block_w if block_w else blockmin_width(m)
    _check_layout(m, depth_sizes, w)
    g = m // w
    xn = torch.sum(slab * slab, dim=-1)
    noninert = is_real | (radii >= 0.0)
    inf = torch.full_like(xn, _INF)
    pblk = parent_rel.long() // w
    big = torch.full_like(pblk, torch.iinfo(torch.int32).max)
    rmax_blk = torch.where(noninert, radii, torch.full_like(radii, -_INF))
    n_noninert = noninert.reshape(g, w).sum(dim=1)
    xnmax_blk = torch.where(noninert, xn, torch.zeros_like(xn)).reshape(g, w).amax(1)
    return BlockWalkPrep(
        w=w,
        depth_sizes=tuple(int(s) for s in depth_sizes),
        slab_bf=slab.to(torch.bfloat16).contiguous(),
        pen_all=torch.where(noninert, xn, inf).reshape(g, w).contiguous(),
        pen_real=torch.where(is_real, xn, inf).reshape(g, w).contiguous(),
        rmax_blk=rmax_blk.reshape(g, w).amax(dim=1),
        xnmax_blk=xnmax_blk,
        n_noninert_blk=n_noninert,
        has_real_blk=is_real.reshape(g, w).any(dim=1),
        has_node_blk=n_noninert > 0,
        pblk_lo=torch.where(noninert, pblk, big).reshape(g, w).amin(dim=1),
        pblk_hi=torch.where(noninert, pblk, torch.full_like(pblk, -1)).reshape(g, w).amax(dim=1),
        max_xn=torch.sqrt(torch.max(xnmax_blk)),
    )


def blockwalk_stage1(
    queries: torch.Tensor, prep: BlockWalkPrep
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 bf16 over the whole slab with both pens, in one launch:
    ``(bm_all, bm_real)``, each ``[B, G]`` of ``min(pen - 2 dot_bf16)`` per
    block (the JAX package's two K1 streams, from one product)."""
    return kernels.dist_blockmin_pair(
        queries.contiguous(), prep.slab_bf, prep.pen_all, prep.pen_real, w=prep.w)


def blockwalk_descent(
    queries: torch.Tensor,
    bm_all: torch.Tensor,
    bm_real: torch.Tensor,
    prep: BlockWalkPrep,
    k: int,
    kprime: int,
    err_c: float = DEFAULT_ERR_C,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block descent over every depth: ``(cand [B, G], ndis [B])``,
    ``cand`` the alive real blocks' d2 upper bounds (+inf elsewhere)."""
    b = queries.shape[0]
    w = prep.w
    dev = bm_all.device
    kp = max(int(kprime), k)
    qn2 = torch.sum(queries * queries, dim=-1)
    qn = torch.sqrt(qn2)
    # |d2_bf - d2| <= 2*err_c*|q|*|x| <= this per-block bound
    band_blk = (2.0 * err_c) * qn[:, None] * torch.sqrt(prep.xnmax_blk)[None, :]

    best_f = torch.full((b, kp), _INF, dtype=torch.float32, device=dev)
    ndis = torch.zeros((b,), dtype=torch.int64, device=dev)
    alive_prev = None  # [B, G_prev] of the previous depth
    cand_parts = []
    g0 = 0
    for wd in prep.depth_sizes:
        g1 = g0 + wd // w
        has_node = prep.has_node_blk[g0:g1]
        if alive_prev is None:
            alive = has_node[None, :].expand(b, g1 - g0)
        else:
            # inclusive OR of alive_prev over [pblk_lo, pblk_hi]: two gathers
            # of an exclusive cumulative sum (columns shared across B)
            cs = F.pad(torch.cumsum(alive_prev.to(torch.int32), dim=1), (1, 0))
            gp = alive_prev.shape[1]
            lo = torch.clamp(prep.pblk_lo[g0:g1], 0, gp)
            hi = torch.clamp(prep.pblk_hi[g0:g1] + 1, 0, gp)
            alive = ((cs[:, hi] - cs[:, lo]) > 0) & has_node[None, :]
        ndis = ndis + torch.where(
            alive, prep.n_noninert_blk[g0:g1][None, :], 0).sum(dim=1)

        cand_hi = torch.where(
            alive & prep.has_real_blk[g0:g1][None, :],
            qn2[:, None] + bm_real[:, g0:g1] + band_blk[:, g0:g1],
            _INF,
        )
        cand_parts.append(cand_hi)
        best_f = _fold(best_f, cand_hi, kp)
        kth_ub = torch.sqrt(torch.clamp(top_k_smallest(best_f, k)[0][:, k - 1], min=0.0))

        d2_lo = torch.clamp(qn2[:, None] + bm_all[:, g0:g1] - band_blk[:, g0:g1], min=0.0)
        alive_prev = alive & (
            torch.sqrt(d2_lo) - prep.rmax_blk[g0:g1][None, :] <= kth_ub[:, None]
        )
        g0 = g1
    cand = cand_parts[0] if len(cand_parts) == 1 else torch.cat(cand_parts, 1)
    return cand, ndis


def blockwalk_select(cand: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-``(k+16)`` candidate blocks: ``(values, block ids)``."""
    return top_k_smallest(cand, min(k + _BLOCK_SLACK, cand.shape[1]))


def covertree_blockwalk_search(
    queries: torch.Tensor,  # [B, d] f32
    slab: torch.Tensor,  # [M, d] f32 node points, depth-major aligned order
    point_ids: torch.Tensor,  # [M] int32 node -> db row
    is_real: torch.Tensor,  # [M] bool
    radii: torch.Tensor,  # [M] f32 (<0 marks padding)
    parent_rel: torch.Tensor,  # [M] int32
    depth_sizes: Tuple[int, ...],
    k: int,
    kprime: int,
    err_c: float = DEFAULT_ERR_C,
    block_w: int = 0,
    prep: BlockWalkPrep = None,
) -> CoverTreeSearchResult:
    """Exact k-NN by the block-granular descent (module docstring); the
    same contract as :func:`covertree_stream_search`.

    Stages: :func:`blockwalk_stage1` (one K1 bf16 launch, two pens),
    :func:`blockwalk_descent`, :func:`blockwalk_select`,
    :func:`rescore_blocks` and :func:`certify`. ``prep`` is the artifact's
    :func:`blockwalk_prep`, derived here when not given.
    """
    if prep is None:
        prep = blockwalk_prep(slab, is_real, radii, parent_rel, depth_sizes, block_w)
    elif tuple(depth_sizes) != prep.depth_sizes or slab.shape[0] != prep.slab_bf.shape[0]:
        raise ValueError("prep was derived from another layout")
    bm_all, bm_real = blockwalk_stage1(queries, prep)
    cand, ndis = blockwalk_descent(queries, bm_all, bm_real, prep, k, kprime, err_c)
    bm_sel, blk_idx = blockwalk_select(cand, k)
    out_d, out_i = rescore_blocks(queries, slab, is_real, point_ids, blk_idx, prep.w, k)
    qn = torch.sqrt(torch.sum(queries * queries, dim=-1))
    overflow = certify(out_d, bm_sel[:, -1], qn, prep.max_xn, err_c, k)
    return CoverTreeSearchResult(out_d, out_i, ndis, overflow, len(depth_sizes))
