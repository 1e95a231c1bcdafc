"""IVF: coarse k-means partition, bucketed inverted lists, probed search.

Counterpart of ``vectordb_retrieval_tpu/ops/ivf.py`` for the Flat, SQ8
and PQ payloads. Lists are dense ``[n_buckets, L, ...]`` tensors with
``-1`` id padding (:func:`build_bucketed_lists`, host NumPy): long lists
split into several buckets of one length ``L`` that share their list's
centroid row. IVF-PQ decodes its lists to bf16 reconstructions
(:func:`decode_resident`) and searches them as bf16 IVF-Flat lists, or, for
indexes whose reconstruction would pass ``_IVFPQ_RESIDENT_BUDGET``, streams
decoded chunks (:func:`ivf_pq_search`).

Each search takes one of three regimes, chosen as the JAX package chooses:

* **probe scan** (``b * nprobe < n_buckets``): gather each query's probed
  buckets, ``G`` at a time (``_PROBE_GROUP_BYTES``), with a running top-k
  (:func:`_probe_scan`);
* **fused probed stream** (the bucketed layout: ``L`` divisible by
  ``w in {32, 16, 8}`` and ``n_buckets % 8 == 0``): ONE query-oblivious pass
  of the hand-written kernel
  :func:`~vectordb_retrieval_tpu_torch.ops.kernels.dist_blockmin` over the
  whole payload (bf16 lists, u8 SQ8 codes or f32 lists), then each query
  selects its top ``k + slack`` blocks among its probed buckets' block
  minima and rescores them exactly (:func:`_fused_stream`). The JAX
  package takes this regime only on a TPU; the port takes it on either
  device, and on the CPU the kernel's plain version runs;
* **masked stream** (other layouts, e.g. legacy artifacts): stream the
  payload chunk by chunk, mask unprobed buckets to +inf, keep per-8-slot
  block minima, then rescore the top blocks (:func:`_masked_stream`).

:func:`ivf_route` makes the choice, once per search. The three codings
differ only in what :class:`ListCoding` holds: the scored rows, the query
they are scored with and stage 3's decode; :func:`_search_lists` derives
every regime from it. Stage 3 over bf16 rows without a per-slot penalty
is one launch of ``kernels.ivf_block_rescore`` (:func:`_block_scorer`).

All three have the reference's "probe the nprobe nearest lists" semantics
when given ``bucket_lists``/``nlist``/``nprobe_lists``
(:func:`exact_probe_mask`). Metric: ``l2`` (norm expansion) or ``ip``
(negated dot; the build normalises for cosine). Candidate selection may run
on bf16 or u8 scores; the blocks it keeps are rescored in exact f32
elementwise arithmetic, never a product.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.ops import pq
from vectordb_retrieval_tpu_torch.utils.profiling import span

_INF = float("inf")


def build_padded_lists(
    assignments: np.ndarray, nlist: int, pad_multiple: int = 8
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Host-side list layout: ``(slot_ids [nlist, max_len], counts, pad_ratio)``.

    ``slot_ids[l, j]`` is the database row id of slot j of list l, or -1.
    """
    counts = np.bincount(assignments, minlength=nlist)
    max_len = int(counts.max()) if counts.size else 1
    max_len = max(pad_multiple, -(-max_len // pad_multiple) * pad_multiple)
    order = np.argsort(assignments, kind="stable")
    slot_ids = np.full((nlist, max_len), -1, dtype=np.int32)
    offset = 0
    for l in range(nlist):
        c = int(counts[l])
        slot_ids[l, :c] = order[offset : offset + c]
        offset += c
    n = max(int(assignments.shape[0]), 1)
    pad_ratio = float(nlist * max_len) / float(n)
    return slot_ids, counts.astype(np.int32), pad_ratio


def build_bucketed_lists(
    assignments: np.ndarray,
    nlist: int,
    pad_multiple: int = 32,
    target_len: int = 0,
    target_len_cap: int = 2048,
    bucket_multiple: int = 8,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Bucketed list layout: ``(slot_ids [n_buckets, L], bucket_lists, pad_ratio)``.

    Every list is split into buckets of one length ``L`` (default
    ``ceil(n / nlist)``, capped at ``target_len_cap``, rounded up to
    ``pad_multiple``); ``bucket_lists[b]`` is the list of bucket ``b``.
    Empty lists keep one all-``-1`` bucket. ``n_buckets`` is padded to a
    multiple of ``bucket_multiple`` with dead buckets (list ``-1``), so the
    flat slot count is a multiple of ``8 * w`` for every ``w`` in
    {8, 16, 32}: the fused stream's layout contract.
    """
    n = max(int(assignments.shape[0]), 1)
    counts = np.bincount(assignments, minlength=nlist)
    if not target_len:
        target_len = -(-n // max(nlist, 1))
        if target_len_cap:
            target_len = min(target_len, target_len_cap)
    target_len = max(
        pad_multiple, -(-target_len // pad_multiple) * pad_multiple
    )
    n_buckets_per = np.maximum(1, -(-counts // target_len))
    n_real = int(n_buckets_per.sum())
    n_buckets = -(-n_real // bucket_multiple) * bucket_multiple
    slot_ids = np.full((n_buckets, target_len), -1, dtype=np.int32)
    bucket_lists = np.full((n_buckets,), -1, dtype=np.int32)
    order = np.argsort(assignments, kind="stable")
    offset = 0
    b = 0
    for l in range(nlist):
        c = int(counts[l])
        members = order[offset : offset + c]
        offset += c
        for s in range(int(n_buckets_per[l])):
            part = members[s * target_len : (s + 1) * target_len]
            slot_ids[b, : part.size] = part
            bucket_lists[b] = l
            b += 1
    pad_ratio = float(n_buckets * target_len) / float(n)
    return slot_ids, bucket_lists, pad_ratio


# coarse-row fill for DEAD buckets (bucket_lists < 0): its squared distance
# to any query is ~d*1e18 — finite in f32, never inside a top-probe set
DEAD_COARSE_FILL = 1e9


def coarse_table(centroids: torch.Tensor, bucket_lists) -> torch.Tensor:
    """Duplicated per-bucket centroid table ``[n_buckets, d]``; dead
    buckets get ``DEAD_COARSE_FILL`` rows so no selector probes them."""
    bl = torch.as_tensor(np.asarray(bucket_lists), device=centroids.device).long()
    tab = centroids[bl.clamp(min=0)]
    return torch.where(
        (bl >= 0)[:, None], tab, torch.full_like(tab, DEAD_COARSE_FILL)
    )


def probe_budget_cum(bucket_lists: np.ndarray, nlist: int) -> np.ndarray:
    """Bucket-probe budget table: ``cum[r]`` buckets cover ``r+1`` lists.

    The sum of the ``r+1`` LARGEST per-list bucket counts, so probing the
    nearest ``cum[p-1]`` buckets covers every bucket of the ``p`` nearest
    lists for every query, whatever the skew.
    """
    counts = np.bincount(
        bucket_lists[bucket_lists >= 0], minlength=max(nlist, 1)
    )
    counts = np.maximum(counts, 1)  # empty lists keep one dead bucket
    return np.cumsum(np.sort(counts)[::-1])


# gather-transient byte budget for one grouped probe step ([B, G, L, d] at
# the payload dtype)
_PROBE_GROUP_BYTES = 384 * 1024 * 1024


def exact_probe_mask(
    queries: torch.Tensor,
    coarse: torch.Tensor,  # [n_bkt, d] DUPLICATED per-bucket centroid table
    bucket_lists: torch.Tensor,  # [n_bkt] bucket -> list map
    nlist: int,
    nprobe_lists: int,
    budget: int,
    list_centroids: Optional[torch.Tensor] = None,  # [nlist, d]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's "probe the nprobe nearest LISTS" on the bucketed
    layout: ``(probes [B, budget] int64, valid [B, budget] bool)``.

    Lists rank by centroid distance (from ``list_centroids``, or the
    segment-min over their buckets' coarse rows), the nearest
    ``nprobe_lists`` are kept with ties at the threshold broken by list id
    (lexicographic on (distance, list id)), and the nearest ``budget``
    buckets of those lists are returned; spare slots are marked invalid.
    """
    b = queries.shape[0]
    n_bkt = coarse.shape[0]
    bl = bucket_lists.long()
    seg = bl.clamp(0, nlist - 1)
    cd = dops.pairwise_distances(queries, coarse, "l2")  # [B, n_bkt]
    if list_centroids is not None:
        ld = dops.pairwise_distances(queries, list_centroids, "l2")
    else:
        # dead buckets clip to list 0: their 1e9 rows never win its min
        ld = torch.full(
            (b, nlist), _INF, dtype=cd.dtype, device=cd.device
        ).scatter_reduce(1, seg.expand(b, -1), cd, "amin", include_self=True)
    np_lists = min(nprobe_lists, nlist)
    lv, _ = dops.top_k_smallest(ld, np_lists)
    thresh = lv[:, -1:]
    below = ld < thresh  # [B, nlist]
    tied = ld == thresh
    remaining = np_lists - below.sum(dim=1, keepdim=True)
    tie_rank = torch.cumsum(tied.to(torch.int32), dim=1)
    allowed_list = below | (tied & (tie_rank <= remaining))
    allowed = allowed_list[:, seg] & (bl >= 0)[None, :]
    cdm = torch.where(allowed, cd, torch.full_like(cd, _INF))
    vals, probes = dops.top_k_smallest(cdm, min(budget, n_bkt))
    return probes, torch.isfinite(vals)


def _coarse_probes(queries, centroids, nprobe):
    """The ``nprobe`` nearest rows of the coarse table, equal distances in
    ascending row: the buckets of one list share its centroid row and tie
    exactly, and a top-k's own tie order differs between the card and the
    host, so a budget that cuts through a list could take other buckets on
    each."""
    cd = dops.pairwise_distances(queries, centroids, "l2")
    rows = torch.arange(centroids.shape[0], device=cd.device)[None, :]
    _, probes = dops.top_k_smallest_by_id(cd, rows, min(nprobe, centroids.shape[0]))
    return probes


def _probes(queries, centroids, nprobe, bucket_lists, nlist, nprobe_lists,
            list_centroids):
    """``(probes, valid or None)`` under the caller's probe semantics."""
    with span("vrt.probe"):
        if bucket_lists is not None and nprobe_lists and nlist:
            return exact_probe_mask(
                queries, centroids, bucket_lists, nlist, nprobe_lists, nprobe,
                list_centroids=list_centroids,
            )
        return _coarse_probes(queries, centroids, nprobe), None


# masked-stream regime: taken when the probe union of a batch is dense
# (b * nprobe >= n_buckets) and the layout does not qualify for the fused
# stream
_BLOCKMIN_W = 8
_BLOCKMIN_SLACK = 16
# payload bytes per streamed chunk (transient only)
_STREAM_CHUNK_BYTES = 64 * 1024 * 1024


def _use_stream(b: int, nprobe: int, n_buckets: int) -> bool:
    return b * nprobe >= n_buckets


def _fused_w(L: int) -> int:
    """Widest supported block width dividing the bucket length (0 = none)."""
    for w in (32, 16, 8):
        if L % w == 0:
            return w
    return 0


def _use_fused(n_bkt: int, L: int) -> int:
    """Fused-stream eligibility: the block width, or 0.

    Requires the bucketed layout (``n_buckets % 8 == 0`` and ``L`` divisible
    by a supported ``w``); layouts persisted by older builds take the
    masked stream.
    """
    w = _fused_w(L)
    if not w or n_bkt % 8:
        return 0
    return w


def ivf_route(b: int, nprobe: int, n_buckets: int, bucket_len: int) -> str:
    """The regime an IVF search of ``b`` queries, ``nprobe`` probes each,
    takes over ``n_buckets`` buckets of ``bucket_len`` slots:
    ``probe_scan``, ``fused_k1`` or ``masked_stream``."""
    if not _use_stream(b, min(nprobe, n_buckets), n_buckets):
        return "probe_scan"
    return "fused_k1" if _use_fused(n_buckets, bucket_len) else "masked_stream"


@dataclass(frozen=True)
class ListCoding:
    """What one search needs of a list coding, built per call.

    ``rows [n_bkt, L, d']`` are the scored rows (f32 or bf16 IVF-Flat
    lists, IVF-PQ's bf16 reconstructions, IVF-SQ8's u8 codes) and
    ``sqnorms [n_bkt, L]`` the f32 squared norms of the vectors they
    decode to; ``queries [B, d]`` are the f32 queries as searched. With
    IVF-SQ8's ``vmin`` and ``step`` a row decodes to ``vmin + code *
    step``; otherwise it is its own vector. ``slot_pen [n_bkt, L]`` is an
    additive per-slot penalty (0 = allowed, +inf = filtered).
    """

    rows: torch.Tensor
    sqnorms: torch.Tensor
    queries: torch.Tensor
    vmin: Optional[torch.Tensor] = None
    step: Optional[torch.Tensor] = None
    slot_pen: Optional[torch.Tensor] = None

    def index_queries(self) -> torch.Tensor:
        """The ``[B, d']`` queries the index scoring dots with the rows: f32
        against f32 rows, else rounded to bf16; IVF-SQ8 folds its decode
        into them as ``q * step`` (u8 codes are exact in any float type)."""
        q = self.queries if self.step is None else self.queries * self.step[None, :]
        return q if self.rows.dtype == torch.float32 else q.to(torch.bfloat16)

    def decode(self, rows: torch.Tensor) -> torch.Tensor:
        """Freshly gathered rows ``[..., d']`` as exact f32 vectors (the
        gathered copy itself where the rows are f32)."""
        v32 = rows.float()
        return v32 if self.step is None else v32.mul_(self.step).add_(self.vmin)


def _index_score(coding: ListCoding, metric: str):
    """The masked stream's and the probe scan's index scoring:
    ``(q, score)``, where ``q`` are the index queries as f32 and
    ``score(dots, pick)`` turns their products ``dots [B, ...]`` with some
    slots' rows into ``||q||^2 + ||x||^2 - 2 q.x`` (l2) or ``-q.x`` (ip),
    IVF-SQ8's per-query ``q . vmin`` added to the dot and ``slot_pen`` to
    the score; ``pick`` takes those slots' entries of an ``[n_bkt, L]``
    table."""
    q = coding.index_queries().float()
    offset = None if coding.vmin is None else coding.queries @ coding.vmin
    qn = torch.sum(coding.queries * coding.queries, dim=-1) if metric == "l2" else None

    def score(dots, pick):
        lead = (-1,) + (1,) * (dots.dim() - 1)
        if offset is not None:
            dots = dots + offset.reshape(lead)
        dist = -dots if qn is None else qn.reshape(lead) + pick(coding.sqnorms) - 2.0 * dots
        return dist if coding.slot_pen is None else dist + pick(coding.slot_pen)

    return q, score


def _smallest_blocks(vals: torch.Tensor, blk: torch.Tensor, nb: int):
    """The ``nb`` smallest block minima of each row of ``vals [B, M]``,
    equal minima taken in ascending global block id ``blk [B, M]``
    (distinct in a row, < 2^31): ``(values, positions)`` ``[B, nb]``.

    Equal minima are common where quantised rows repeat (PQ codes collapse
    a tight cluster to one reconstruction, every block holding a member
    gets the same minimum), and a top-k's own tie order differs between the
    card and the host: :func:`~vectordb_retrieval_tpu_torch.ops.distances.
    top_k_smallest_by_id` has no ties.
    """
    return dops.top_k_smallest_by_id(vals, blk, nb)


def _exact_scores(v32, queries, metric):
    """Exact scores of fresh ``[B, nb, w, d]`` f32 blocks (updated in
    place): squared L2 as a difference sum (l2) or the negated dot (ip),
    elementwise in f32, never a product."""
    if metric == "l2":
        v32.sub_(queries[:, None, None, :])
        return torch.sum(v32.mul_(v32), dim=-1)
    return -torch.sum(v32.mul_(queries[:, None, None, :]), dim=-1)


def _block_scorer(coding: ListCoding, slot_ids: torch.Tensor, w: int, metric: str):
    """Stage 3's scorer ``(blk [B, nb], blk_vals [B, nb]) -> (cd [B, nb w],
    cand [B, nb w])``: the exact scores and row ids of every slot of the
    selected ``w``-slot blocks, ``+inf`` on dead slots and on blocks with
    an infinite minimum (a query with fewer probed blocks than selected).

    Where the call sees bf16 rows, int32 slot ids and no ``slot_pen``, one
    launch of :func:`~vectordb_retrieval_tpu_torch.ops.kernels.
    ivf_block_rescore` reads the selected blocks straight from the lists;
    otherwise the blocks are gathered, decoded (:meth:`ListCoding.decode`)
    and rescored elementwise.
    """
    rows, queries, pen = coding.rows, coding.queries, coding.slot_pen
    d = rows.shape[-1]
    if rows.dtype == torch.bfloat16 and slot_ids.dtype == torch.int32 and pen is None:
        q = queries.float().contiguous()
        flat_rows, flat_ids = rows.reshape(-1, d), slot_ids.reshape(-1)
        kmetric = "l2" if metric == "l2" else "ip"

        def kernel(blk, blk_vals):
            return kernels.ivf_block_rescore(q, flat_rows, flat_ids, blk, blk_vals.contiguous(),
                                             w, kmetric)

        return kernel

    def gathered(blk, blk_vals):
        b, nb = blk.shape
        cand = slot_ids.reshape(-1, w)[blk]  # [B, nb, w]
        cd = _exact_scores(coding.decode(rows.reshape(-1, w, d)[blk]), queries, metric)
        if pen is not None:
            cd = cd + pen.reshape(-1, w)[blk]
        cd = torch.where(torch.isfinite(blk_vals)[:, :, None], cd, _INF)
        cd = torch.where(cand >= 0, cd, _INF).reshape(b, nb * w)
        return cd, cand.reshape(b, nb * w)

    return gathered


def _rescore_blocks(
    blk: torch.Tensor,  # [B, nb] selected global block ids
    blk_vals: torch.Tensor,  # [B, nb] their block minima (+inf = unprobed)
    scorer: Callable,  # a _block_scorer
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Last stage of both streams: score the selected blocks exactly
    (:func:`_block_scorer`), keep the top k."""
    with span("vrt.rescore"):
        cd, cand = scorer(blk, blk_vals)
        vals, sel = dops.top_k_smallest(cd, k)
        ids = torch.gather(cand, 1, sel).long()
        return vals, torch.where(torch.isfinite(vals), ids, -1)


def _masked_minima(probes, probe_valid, slot_ids, coding: ListCoding, metric: str,
                   w: int = _BLOCKMIN_W):
    """Stage 1 of the masked stream: the rows scored chunk by chunk against
    every query (an f32 product, :func:`_index_score`), unprobed buckets
    and dead slots masked to +inf, per-``w``-slot block minima ``[B, n_bkt
    * L / w]``. A chunk streams at most ``_STREAM_CHUNK_BYTES`` of rows,
    norms and penalties."""
    n_bkt, L = slot_ids.shape
    b = probes.shape[0]
    dev = slot_ids.device
    q, score = _index_score(coding, metric)
    tables = [t for t in (coding.rows, coding.sqnorms, coding.slot_pen) if t is not None]
    row_bytes = sum(int(np.prod(t.shape[2:])) * t.element_size() for t in tables)
    chunk = max(1, min(n_bkt, _STREAM_CHUNK_BYTES // max(L * row_bytes, 1)))
    pv = (
        torch.ones(probes.shape, dtype=torch.bool, device=dev)
        if probe_valid is None else probe_valid
    )
    bms = []
    for c0 in range(0, n_bkt, chunk):
        c = min(chunk, n_bkt - c0)
        rows = coding.rows[c0 : c0 + c].reshape(c * L, -1)
        dist = score(q @ rows.float().T, lambda t: t[c0 : c0 + c].reshape(1, -1))  # [B, c*L]
        local = probes - c0
        inside = (local >= 0) & (local < c) & pv
        # out-of-chunk and invalid probes land in a spare column: every
        # write is True, so repeated indices cannot race
        hit = torch.zeros((b, c + 1), dtype=torch.bool, device=dev)
        hit.scatter_(1, torch.where(inside, local, c), True)
        valid = (slot_ids[c0 : c0 + c].reshape(1, c * L) >= 0) & (
            hit[:, :c].repeat_interleave(L, dim=1)
        )
        dist = torch.where(valid, dist, _INF)
        bms.append(dist.reshape(b, c * L // w, w).amin(dim=-1))
    return torch.cat(bms, dim=1)


def _masked_stream(probes, probe_valid, slot_ids, coding: ListCoding, k: int, metric: str,
                   w: int = _BLOCKMIN_W, slack: int = _BLOCKMIN_SLACK):
    """IVF search as a masked payload stream + blockmin certificate.

    Stage 1 (:func:`_masked_minima`) keeps per-``w``-slot block minima of
    the probed slots' index scores. Stage 2 keeps the top ``k + slack``
    blocks, which provably hold the top-k probed slots under the index
    scoring, and stage 3 (:func:`_rescore_blocks`) rescores them exactly.
    ``L`` is a multiple of ``w``, so blocks never straddle buckets.
    """
    bmins = _masked_minima(probes, probe_valid, slot_ids, coding, metric, w)
    b = probes.shape[0]
    nb = min(k + slack, bmins.shape[1])
    blk_ids = torch.arange(bmins.shape[1], device=slot_ids.device).expand(b, -1)
    blk_vals, blk = _smallest_blocks(bmins, blk_ids, nb)
    return _rescore_blocks(blk, blk_vals, _block_scorer(coding, slot_ids, w, metric), k)


def _fused_pen(slot_ids, list_sqnorms, metric, slot_pen=None) -> torch.Tensor:
    """Per-slot constant of the fused stream ``[n_bkt*L]``: ``||x||^2`` for
    l2 (0 for ip), plus ``slot_pen``, and +inf for every dead slot."""
    n_bkt, L = slot_ids.shape
    if metric == "l2":
        pen = list_sqnorms.reshape(-1)
    else:
        pen = torch.zeros((n_bkt * L,), dtype=torch.float32, device=slot_ids.device)
    if slot_pen is not None:
        pen = pen + slot_pen.reshape(-1)
    return torch.where(slot_ids.reshape(-1) >= 0, pen, _INF)


def _probed_blocks(bm, probes, n_bkt, bpb, nb, probe_valid=None):
    """Stage 2 of the fused stream: each query's top ``nb`` blocks among
    its probed buckets' block minima, as ``(block minima, global block
    ids)`` ``[B, nb]``. Probed minima are gathered as whole bucket rows
    (``bpb`` blocks per bucket)."""
    b = probes.shape[0]
    pclip = probes.clamp(0, n_bkt - 1)
    mvals = torch.gather(
        bm.reshape(b, n_bkt, bpb), 1, pclip[:, :, None].expand(-1, -1, bpb)
    ).reshape(b, -1)  # [B, nprobe*bpb]
    mem = (
        pclip[:, :, None] * bpb + torch.arange(bpb, device=bm.device)
    ).reshape(b, -1)  # their global block ids
    if probe_valid is not None:
        mvals = torch.where(probe_valid.repeat_interleave(bpb, dim=1), mvals, _INF)
    sel_vals, msel = _smallest_blocks(mvals, mem, min(nb, mvals.shape[1]))
    return sel_vals, torch.gather(mem, 1, msel)


def _fused_stream(probes, probe_valid, slot_ids, coding: ListCoding, k: int, metric: str,
                  slack: int = _BLOCKMIN_SLACK):
    """IVF search as ONE fused payload stream + probed blockmin selection.

    Stage 1 is one launch of the hand-written kernel
    :func:`~vectordb_retrieval_tpu_torch.ops.kernels.dist_blockmin` over
    the whole payload: per-``w``-slot minima of the index scoring, the pen
    made from the norms and the metric (:func:`_fused_pen`), with no
    ``[B, S]`` matrix and no per-query masking; per-query constants (SQ8's
    ``q . vmin`` among them) are omitted, which is rank-safe. Stage 2
    (:func:`_probed_blocks`) narrows each query to its probed buckets'
    minima and keeps the top ``k + slack``; stage 3
    (:func:`_rescore_blocks`) rescores their rows exactly. Unprobed
    buckets are never candidates: the same recall semantics as
    :func:`_masked_stream`. Layout contract: ``L % w == 0``.
    """
    n_bkt, L = slot_ids.shape
    w = _fused_w(L)
    pen = _fused_pen(slot_ids, coding.sqnorms, metric, coding.slot_pen)
    bm = kernels.dist_blockmin(
        coding.index_queries(), coding.rows.reshape(n_bkt * L, -1), pen.reshape(-1, w), w=w
    )  # [B, S/w] shifted minima
    sel_vals, blk = _probed_blocks(bm, probes, n_bkt, L // w, k + slack, probe_valid)
    return _rescore_blocks(blk, sel_vals, _block_scorer(coding, slot_ids, w, metric), k)


def _probe_scan(probes, probe_valid, slot_ids, coding: ListCoding, k: int, metric: str):
    """IVF search as a loop over probe GROUPS: each query's probed buckets
    gathered ``G`` at a time and scored (:func:`_index_score`), merged
    into a running top-k. ``G`` keeps the ``[B, G, L, d']`` gather within
    ``_PROBE_GROUP_BYTES``."""
    b, nprobe = probes.shape
    L = slot_ids.shape[1]
    dev = probes.device
    rows = coding.rows
    q, score = _index_score(coding, metric)
    cap = _PROBE_GROUP_BYTES // max(b * L * rows.shape[-1] * rows.element_size(), 1)
    group = int(max(1, min(nprobe, cap)))
    steps = -(-nprobe // group)
    pad = steps * group - nprobe
    if probe_valid is None:
        probe_valid = torch.ones((b, nprobe), dtype=torch.bool, device=dev)
    probes_p = torch.cat(
        [probes, torch.zeros((b, pad), dtype=probes.dtype, device=dev)], dim=1
    ).reshape(b, steps, group)
    valid_p = torch.cat(
        [probe_valid, torch.zeros((b, pad), dtype=torch.bool, device=dev)], dim=1
    ).reshape(b, steps, group)
    best_d = torch.full((b, k), _INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for s in range(steps):
        lists = probes_p[:, s]  # [B, G]
        dots = torch.einsum("bgld,bd->bgl", rows[lists].float(), q)
        dist = score(dots, lambda t: t[lists]).reshape(b, -1)  # [B, G*L]
        ids = slot_ids[lists].reshape(b, -1).long()
        ids = torch.where(valid_p[:, s].repeat_interleave(L, dim=1), ids, -1)
        dist = torch.where(ids >= 0, dist, _INF)
        # +inf with a real id happens under slot_pen (a filtered slot):
        # drop the id too, so no later rescore revives the row
        ids = torch.where(torch.isfinite(dist), ids, -1)
        best_d, sel = dops.top_k_smallest(torch.cat([best_d, dist], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, ids], dim=1), 1, sel)
    return best_d, best_i


def _search_lists(probes, probe_valid, slot_ids, coding: ListCoding, k: int, metric: str):
    """IVF search of one list coding under the probes, ``(dists [B, k],
    ids [B, k] int64)``: the regime chosen once (:func:`ivf_route`) and
    every part of it derived from the coding."""
    n_bkt, L = slot_ids.shape
    route = ivf_route(probes.shape[0], probes.shape[1], n_bkt, L)
    if route == "fused_k1":
        return _fused_stream(probes, probe_valid, slot_ids, coding, k, metric)
    if route == "masked_stream":
        return _masked_stream(probes, probe_valid, slot_ids, coding, k, metric)
    return _probe_scan(probes, probe_valid, slot_ids, coding, k, metric)


def _final_rescore(queries, full_vectors, ids, k, metric):
    """Exact re-rank of compressed-list candidates against f32 rows."""
    with span("vrt.rescore"):
        cd = dops.rescore(queries, full_vectors, ids, metric)
        vals, sel = dops.top_k_smallest(cd, k)
        ids = torch.gather(ids, 1, sel)
        return vals, torch.where(torch.isfinite(vals), ids, -1)


def ivf_flat_search(
    queries: torch.Tensor,
    centroids: torch.Tensor,
    slot_ids: torch.Tensor,
    list_vecs: torch.Tensor,  # [n_bkt, L, d] f32 or bf16
    list_sqnorms: torch.Tensor,
    k: int,
    nprobe: int,
    metric: str = "l2",
    full_vectors: Optional[torch.Tensor] = None,  # f32 rows for the exact rescore
    bucket_lists: Optional[torch.Tensor] = None,  # with nlist/nprobe_lists:
    nlist: int = 0,                               # the reference's 'probe
    nprobe_lists: int = 0,                        # nprobe LISTS' semantics
    slot_pen: Optional[torch.Tensor] = None,  # [n_bkt, L] f32 additive penalty
    list_centroids: Optional[torch.Tensor] = None,  # [nlist, d] probe table
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-Flat search: ``(dists [B, k], ids [B, k] int64)``.

    bf16 lists score candidates on the compressed copies (queries rounded
    to bf16); with ``full_vectors`` the best ``k + 8`` are rescored exactly
    against the f32 rows. ``slot_pen`` is a per-slot additive penalty
    (0 = allowed, +inf = filtered) applied before any top-k.
    """
    probes, pvalid = _probes(
        queries, centroids, nprobe, bucket_lists, nlist, nprobe_lists,
        list_centroids,
    )
    compressed = list_vecs.dtype != torch.float32 and full_vectors is not None
    # the k+8 overfetch is the bf16-noise margin
    coding = ListCoding(list_vecs, list_sqnorms, queries, slot_pen=slot_pen)
    dists, ids = _search_lists(probes, pvalid, slot_ids, coding, k + 8 if compressed else k,
                               metric)
    if compressed:
        return _final_rescore(queries, full_vectors, ids, k, metric)
    return dists, ids


# the resident regime's bf16 reconstruction budget (bytes); above it the
# search streams decoded chunks instead
_IVFPQ_RESIDENT_BUDGET = 512 * 1024 * 1024
# the streaming regime's per-chunk decode budget (bf16 bytes)
_IVFPQ_CHUNK_BUDGET = 48 * 1024 * 1024
# reconstruction rows one resident decode step handles
_IVFPQ_DECODE_ROWS = 65_536


def _decode_lists(codes, cents, codebooks, rot=None):
    """Decode bucket codes ``[c, L, m]`` -> bf16 ``x_hat [c, L, d]`` and
    its f32 squared norms ``[c, L]``, taken BEFORE the bf16 cast.

    ``cents [c, d]`` is each bucket's coarse centroid; ``rot [c, nb, bs,
    bs]``, where given, each bucket's list rotation: the codes quantise
    ``R_l r``, so ``R_l^T`` is applied before the centroid is added. That
    product is summed in float64 and rounded once to f32, so the bf16 rows
    do not depend on a device's summation order: an f32 sum taken in
    another order would move a few values across a bf16 rounding edge, and
    with them whole rescored distances (by ~2^-8 of a coordinate).
    """
    c, L, m = codes.shape
    d = cents.shape[1]
    y_hat = pq.pq_reconstruct(codes.reshape(c * L, m), codebooks)
    if rot is not None:
        bs = rot.shape[-1]
        y_hat = torch.einsum(
            "clbe,cbef->clbf", y_hat.reshape(c, L, d // bs, bs).double(), rot.double()
        ).float()
    x_hat = y_hat.reshape(c, L, d) + cents[:, None, :]
    return x_hat.to(torch.bfloat16), torch.sum(x_hat * x_hat, dim=-1)


def _bucket_rotations(list_rotations, rot_bucket_lists, c0, c1):
    """Rotation blocks of buckets ``c0:c1`` (None without rotations)."""
    if list_rotations is None:
        return None
    return list_rotations[rot_bucket_lists[c0:c1].long().clamp(min=0)]


def decode_resident(
    list_codes: torch.Tensor,  # [n_bkt, L, m] uint8
    centroids: torch.Tensor,  # [n_bkt, d] per-bucket coarse table
    codebooks: torch.Tensor,
    list_rotations: Optional[torch.Tensor] = None,
    rot_bucket_lists: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The resident regime's reconstruction of every list, ``(recon [n_bkt,
    L, d] bf16, recon_sqn [n_bkt, L] f32)``, in steps of
    ``ceil(65,536 / L)`` buckets so the f32 transient stays bounded."""
    n_bkt, L, _ = list_codes.shape
    d = centroids.shape[1]
    chunk = max(1, min(n_bkt, -(-_IVFPQ_DECODE_ROWS // max(L, 1))))
    recon = torch.empty((n_bkt, L, d), dtype=torch.bfloat16, device=list_codes.device)
    recon_sqn = torch.empty((n_bkt, L), dtype=torch.float32, device=list_codes.device)
    for c0 in range(0, n_bkt, chunk):
        c1 = min(c0 + chunk, n_bkt)
        recon[c0:c1], recon_sqn[c0:c1] = _decode_lists(
            list_codes[c0:c1], centroids[c0:c1], codebooks,
            _bucket_rotations(list_rotations, rot_bucket_lists, c0, c1),
        )
    return recon, recon_sqn


def ivf_pq_search(
    queries: torch.Tensor,
    centroids: torch.Tensor,  # [n_bkt, d] coarse table, one row per BUCKET
    slot_ids: torch.Tensor,
    list_codes: torch.Tensor,  # [n_bkt, L, m] uint8 residual codes
    list_sqnorms: torch.Tensor,  # ||residual_hat||^2 per slot (kept for parity)
    codebooks: torch.Tensor,
    k: int,
    nprobe: int,
    metric: str = "l2",
    resident_budget: int = _IVFPQ_RESIDENT_BUDGET,
    chunk_budget: int = _IVFPQ_CHUNK_BUDGET,
    bucket_lists: Optional[torch.Tensor] = None,
    nlist: int = 0,
    nprobe_lists: int = 0,
    list_rotations: Optional[torch.Tensor] = None,  # [nlist, nb, bs, bs]
    rot_bucket_lists: Optional[torch.Tensor] = None,  # bucket -> list map
    list_centroids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ search by decode-on-read: ``(dists [B, k], ids [B, k] int64)``.

    Resident regime (the bf16 reconstruction within ``resident_budget``):
    every list is decoded once per call (:func:`decode_resident`, query-
    independent), then searched as bf16 IVF-Flat lists by
    :func:`_search_lists`: the fused stream (K1 bf16 over the
    reconstructions, ``pen = ||x_hat||^2`` for l2, 0 for ip, +inf on dead
    slots; selected blocks rescored exactly against the bf16 rows by
    ``kernels.ivf_block_rescore``), the masked stream, or the probe scan.
    Streaming regime: chunks of ``chunk_budget`` bytes are decoded, scored
    against every query with a bf16 product, masked to the probed buckets
    and merged into a running top-k (the one loop no other coding shares).
    """
    probes, pvalid = _probes(
        queries, centroids, nprobe, bucket_lists, nlist, nprobe_lists,
        list_centroids,
    )
    n_bkt, L, _ = list_codes.shape
    d = centroids.shape[1]
    if n_bkt * L * d * 2 <= resident_budget:
        recon, recon_sqn = decode_resident(
            list_codes, centroids, codebooks, list_rotations, rot_bucket_lists
        )
        return _search_lists(probes, pvalid, slot_ids, ListCoding(recon, recon_sqn, queries),
                             k, metric)

    # streaming regime: decoded chunks in a bounded transient
    b = queries.shape[0]
    dev = queries.device
    qn = torch.sum(queries * queries, dim=-1)
    q_bf = queries.to(torch.bfloat16)
    chunk = max(1, min(n_bkt, chunk_budget // max(L * d * 2, 1)))
    pv = torch.ones(probes.shape, dtype=torch.bool, device=dev) if pvalid is None else pvalid
    best_d = torch.full((b, k), _INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, n_bkt, chunk):
        c1 = min(c0 + chunk, n_bkt)
        c = c1 - c0
        x_hat, sqn = _decode_lists(
            list_codes[c0:c1], centroids[c0:c1], codebooks,
            _bucket_rotations(list_rotations, rot_bucket_lists, c0, c1),
        )
        local = probes - c0
        inside = (local >= 0) & (local < c) & pv
        # out-of-chunk and invalid probes land in a spare column
        hit = torch.zeros((b, c + 1), dtype=torch.bool, device=dev)
        hit.scatter_(1, torch.where(inside, local, c), True)
        dots = q_bf.float() @ x_hat.reshape(c * L, d).float().T  # [B, c*L]
        if metric == "l2":
            dist = qn[:, None] + sqn.reshape(1, c * L) - 2.0 * dots
        else:
            dist = -dots
        ids = slot_ids[c0:c1].reshape(1, c * L).long()
        valid = (ids >= 0) & hit[:, :c].repeat_interleave(L, dim=1)
        dist = torch.where(valid, dist, _INF)
        best_d, sel = dops.top_k_smallest(torch.cat([best_d, dist], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, ids.expand(b, -1)], dim=1), 1, sel)
    return best_d, torch.where(torch.isfinite(best_d), best_i, -1)


def ivf_sq_search(
    queries: torch.Tensor,
    centroids: torch.Tensor,
    slot_ids: torch.Tensor,
    list_codes: torch.Tensor,  # [n_bkt, L, d] uint8
    list_sqnorms: torch.Tensor,
    vmin: torch.Tensor,
    step: torch.Tensor,
    k: int,
    nprobe: int,
    metric: str = "l2",
    bucket_lists: Optional[torch.Tensor] = None,
    nlist: int = 0,
    nprobe_lists: int = 0,
    list_centroids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-SQ8 search: ``(dists [B, k], ids [B, k] int64)``.

    The affine decode is folded into the dot:
    ``q . x_hat = q . vmin + (q * step) . codes``, with ``q * step`` rounded
    to bf16 (u8 codes are exact in any float type), so candidates are
    scored without decoding the lists. The fused stream drops the
    per-query ``q . vmin``; selected blocks are decoded and rescored
    exactly.
    """
    probes, pvalid = _probes(
        queries, centroids, nprobe, bucket_lists, nlist, nprobe_lists,
        list_centroids,
    )
    coding = ListCoding(list_codes, list_sqnorms, queries, vmin=vmin, step=step)
    return _search_lists(probes, pvalid, slot_ids, coding, k, metric)
