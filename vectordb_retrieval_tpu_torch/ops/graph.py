"""Graph ANN: RNG-pruned kNN graphs and batched beam searches over them.

Counterpart of ``vectordb_retrieval_tpu/ops/graph.py``, with the same
functions, defaults and rules:

  * build: an exact (or, above ``_IVF_BUILD_THRESHOLD`` rows, IVF-probed)
    candidate kNN, RNG edge pruning (:func:`_diversify_batch`), reverse
    edges (:func:`add_reverse_edges`), neighbour-vector tables
    (:func:`build_neighbor_table`) and the memory-parity block layout
    (:func:`build_block_graph`: a cluster-sorted corpus chopped into
    fixed-size blocks, one router entry per (cluster, block) segment, an
    entry-level RNG graph);
  * search: the node beam (:func:`graph_search`) and the block beam
    (:func:`block_graph_search`), whose every wave scores the member slabs
    of the popped blocks with the hand-written kernel
    :func:`~vectordb_retrieval_tpu_torch.ops.kernels.slab_dots` (its plain
    version on CPU tensors), then merges them in one top-k.

Each beam is also a class cut into its stages (:class:`BlockBeam`,
:class:`NodeBeam`), so a caller can time or check one stage on the inputs
the search gives it. A wave runs no host synchronisation: the wave count is
a Python int, as it is static in the JAX package, and every selection is a
tensor operation. ``approx_max_k(..., recall_target=1.0)`` is an exact
top-k and becomes ``top_k_smallest``; where several candidates tie at +inf
the choice among them changes no result (their ids are -1, or their blocks
are visited or already in the frontier). So on a CUDA card the block beam
runs as CUDA graphs, captured once per batch shape and index and then
replayed (:func:`block_graph_search`).

Determinism: the block layout's router entries are segment means summed by
a one-hot batched product (no atomics), so two builds from the same inputs
give the same entries. :func:`build_block_graph_stream` builds the same
layout from an out-of-core corpus (``np.memmap``, ``BigStore``) in
sequential chunk passes.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device
from vectordb_retrieval_tpu_torch.utils.profiling import span

# 1024 keeps the kNN-graph build's per-batch candidate rescore within a
# sane transient footprint
_BUILD_BATCH = 1024
_IVF_BUILD_THRESHOLD = 300_000
_INF = float("inf")


def _tril(n: int, device: torch.device) -> torch.Tensor:
    """Strictly lower triangle ``[n, n]``: entry ``(i, j)`` is ``j < i``."""
    return torch.ones((n, n), dtype=torch.bool, device=device).tril(-1)


def _earlier_equal(v: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` bool: some earlier column of the row holds the same value."""
    eq = v[:, :, None] == v[:, None, :]
    return torch.any(eq & _tril(v.shape[1], v.device)[None], dim=2)


def _member(v: torch.Tensor, of: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` bool: ``v[b, c]`` occurs in ``of[b, :]``."""
    return torch.any(v[:, :, None] == of[:, None, :], dim=2)


# ---- build ---------------------------------------------------------------


def _diversify_batch(
    cand_ids: torch.Tensor,  # [B, C] nearest-first candidates (self excluded)
    cand_d2: torch.Tensor,  # [B, C] SQUARED distances node->candidate
    cand_vecs: torch.Tensor,  # [B, C, d]
    degree: int,
) -> torch.Tensor:
    """HNSW/RNG edge pruning, batched over nodes: ``[B, degree]`` ids.

    Candidate c_j (ranked by distance) is kept iff for every already-kept
    c_k: ``d(c_j, c_k) > d(node, c_j)``. Remaining slots are refilled with
    the closest pruned candidates, so the degree stays fixed.
    """
    b, c, _ = cand_vecs.shape
    dots = torch.bmm(cand_vecs, cand_vecs.transpose(1, 2))
    cn = torch.sum(cand_vecs * cand_vecs, dim=-1)
    pair = cn[:, :, None] + cn[:, None, :] - 2.0 * dots  # [B, C, C] squared
    keep = torch.zeros((b, c), dtype=torch.bool, device=cand_ids.device)
    for j in range(c):
        conflict = torch.any(keep & (pair[:, j, :] <= cand_d2[:, j, None]), dim=1)
        n_kept = torch.sum(keep, dim=1)
        keep[:, j] = (~conflict) & (n_kept < degree)
    # refill: kept first (stable by rank), then pruned by rank
    rank = torch.arange(c, device=cand_ids.device).expand(b, c)
    order = torch.argsort(torch.where(keep, rank, rank + c), dim=1)
    return torch.gather(cand_ids, 1, order)[:, :degree]


def _ivf_candidate_searcher(
    vectors: torch.Tensor, n_cand: int, nprobe: int, nlist: int, seed: int = 17
):
    """Corpus-vs-itself IVF searcher for large-N graph builds: each node's
    candidates come from probing its ``nprobe`` nearest lists (the serving
    structures of ``ops/ivf``) instead of an O(N^2 d) exact scan. Returns
    ``(search, bucket_len)``."""
    from vectordb_retrieval_tpu_torch.ops import ivf as ivfops
    from vectordb_retrieval_tpu_torch.ops.kmeans import (
        kmeans_assign,
        kmeans_fit,
        training_sample,
    )

    n = vectors.shape[0]
    dev = vectors.device
    nlist = min(nlist, n)
    sample = training_sample(n, nlist, seed)
    train = vectors if sample is None else vectors[sample.to(dev)]
    centroids, _ = kmeans_fit(train, nlist, seed=seed, iters=10)
    assign = kmeans_assign(vectors, centroids).cpu().numpy()
    slot_np, bucket_lists_np, _ = ivfops.build_bucketed_lists(
        assign, nlist, bucket_multiple=1
    )
    slots = torch.as_tensor(slot_np, device=dev)
    coarse = centroids[torch.as_tensor(bucket_lists_np, device=dev).long()]
    safe = torch.as_tensor(np.where(slot_np >= 0, slot_np, 0), device=dev).long()
    list_vecs = vectors[safe]
    list_sqn = torch.sum(list_vecs * list_vecs, dim=-1)
    # probing nprobe LISTS means probing all their buckets: the budget is
    # the sum of the nprobe largest lists' bucket counts
    n_buckets = slot_np.shape[0]
    cum = ivfops.probe_budget_cum(bucket_lists_np, nlist)
    eff_probe = int(min(cum[min(nprobe, len(cum)) - 1], n_buckets))

    def search(q):
        return ivfops.ivf_flat_search(
            q, coarse, slots, list_vecs, list_sqn, n_cand + 1, eff_probe,
            metric="l2",
        )

    return search, int(slot_np.shape[1])


def add_reverse_edges(
    adjacency: np.ndarray, vectors: torch.Tensor, rev: int
) -> np.ndarray:
    """Append the nearest ``rev`` INCOMING edges per node: ``[N, R+rev]``.

    For every edge i->j, j receives i ranked by edge distance, nearest
    ``rev`` kept (HNSW's bidirectional links: a row that makes nobody's
    pruned list is otherwise unreachable). Duplicates of forward edges stay
    (the beam dedups); pad slots are -1.
    """
    n, r = adjacency.shape
    src = np.repeat(np.arange(n, dtype=np.int64), r)
    dst = adjacency.reshape(-1).astype(np.int64)
    keep = dst >= 0
    src, dst = src[keep], dst[keep]
    # 256 MB chunks bound the two [edges, d] gathers at any scale
    d = np.empty(src.shape[0], np.float32)
    dev = vectors.device
    step = max(1, (256 << 20) // max(int(vectors.shape[1]) * 8, 1))
    for s in range(0, src.shape[0], step):
        e = min(s + step, src.shape[0])
        a = vectors[torch.as_tensor(src[s:e], device=dev)]
        b = vectors[torch.as_tensor(dst[s:e], device=dev)]
        d[s:e] = torch.sum((a - b) ** 2, dim=1).cpu().numpy()
    order = np.lexsort((d, dst))  # group by dst, nearest first
    dst_s, src_s = dst[order], src[order]
    first = np.searchsorted(dst_s, np.arange(n))
    pos = np.arange(dst_s.shape[0]) - first[dst_s]  # rank within group
    sel = pos < rev
    extra = np.full((n, rev), -1, np.int32)
    extra[dst_s[sel], pos[sel]] = src_s[sel]
    return np.concatenate([adjacency, extra], axis=1)


def build_knn_graph(
    vectors: torch.Tensor,
    degree: int,
    batch: int = _BUILD_BATCH,
    diversify: bool = True,
    candidate_factor: int = 3,
    method: str = "auto",  # auto | exact | ivf
    build_nprobe: int = 64,
    build_nlist: int = 0,
    reverse_edges: int = 0,  # extra slots for nearest INCOMING edges
) -> torch.Tensor:
    """Candidate kNN + RNG-pruned adjacency ``[N, R(+rev)]`` int32.

    Candidates come from the exact scan, or (``method='ivf'``, auto above
    ``_IVF_BUILD_THRESHOLD`` rows) from the IVF-probe scan;
    ``reverse_edges`` appends bidirectional links (:func:`add_reverse_edges`).
    """
    n = vectors.shape[0]
    dev = vectors.device
    degree = min(degree, n - 1)
    n_cand = min(max(degree, candidate_factor * degree), n - 1)
    use_ivf = method == "ivf" or (method == "auto" and n > _IVF_BUILD_THRESHOLD)
    ivf_search = None
    if use_ivf:
        nlist = build_nlist or max(64, int(np.sqrt(n)))
        ivf_search, bucket_len = _ivf_candidate_searcher(
            vectors, n_cand, build_nprobe, nlist
        )
        if batch == _BUILD_BATCH:
            # bigger node batches, bounded so the per-probe [batch, L, d]
            # gather transient stays ~1 GB
            budget = (1 << 30) // max(bucket_len * vectors.shape[1] * 4, 1)
            batch = int(min(4096, max(_BUILD_BATCH, budget)))
    sqn = dops.sq_norms(vectors)
    rows = []
    batch = min(batch, n)
    starts = list(range(0, n, batch))
    # every batch the same shape: shift the last ragged batch back and drop
    # the overlapping prefix after computing
    overlaps = [0] * len(starts)
    if starts and starts[-1] + batch > n:
        shifted = n - batch
        overlaps[-1] = starts[-1] - shifted
        starts[-1] = shifted
    for start, overlap in zip(starts, overlaps):
        end = start + batch
        q = vectors[start:end]
        # candidates need no exact rescore (they are pruned anyway)
        if ivf_search is not None:
            d, ids = ivf_search(q)
        elif n <= 262_144:
            d, ids = dops._exact_search_dense(q, vectors, sqn, n_cand + 1, "l2")
        else:
            d, ids = dops.exact_search(
                q, vectors, n_cand + 1, metric="l2", db_sqnorms=sqn, device=dev
            )
        ids = ids.cpu().numpy()
        d = d.cpu().numpy()
        # drop the self column (nearest hit; ties may hide it -> drop last)
        keep = ids != np.arange(start, end)[:, None]
        overflow = keep.sum(1) > n_cand
        if overflow.any():
            for r in np.where(overflow)[0]:
                extra = np.where(keep[r])[0]
                keep[r, extra[n_cand:]] = False
        order = np.argsort(~keep, axis=1, kind="stable")
        ids = np.take_along_axis(ids, order, axis=1)[:, :n_cand]
        d = np.take_along_axis(d, order, axis=1)[:, :n_cand]
        if diversify and n_cand > degree:
            cand_ids = torch.as_tensor(ids, device=dev)
            pruned = _diversify_batch(
                cand_ids,
                torch.clamp(torch.as_tensor(d, device=dev), min=0.0),
                vectors[cand_ids],
                degree,
            )
            rows.append(pruned.cpu().numpy()[overlap:].astype(np.int32))
        else:
            rows.append(ids[overlap:, :degree].astype(np.int32))
    adj_np = np.concatenate(rows, axis=0).astype(np.int32)
    if reverse_edges > 0:
        adj_np = add_reverse_edges(adj_np, vectors, reverse_edges)
    return torch.as_tensor(adj_np, device=dev)


def build_neighbor_table(
    vectors: torch.Tensor,
    adjacency: torch.Tensor,
    dtype="bf16",
):
    """Contiguous neighbour-vector table
    ``([N, R, d] bf16 | u8 codes, [N, R] f32 norms, vmin | None, step | None)``.

    Each node's neighbour vectors stored contiguously, so the node beam's
    per-iteration vector fetch gathers ``[B, W]`` table rows instead of
    ``B * W * R`` scattered corpus rows. ``dtype='int8'`` (or ``'sq8'``)
    stores SQ8 codes (``ops/sq`` ranges) with the norms of the decoded rows;
    the float table keeps f32 norms of the f32 rows.
    """
    from vectordb_retrieval_tpu_torch.ops import sq as sqops

    safe = adjacency.clamp(min=0).long()
    if dtype in ("int8", "sq8", torch.uint8, torch.int8):
        vmin, step = sqops.sq_train(vectors)
        codes = sqops.sq_encode(vectors, vmin, step)
        x_hat = sqops.sq_decode(codes, vmin, step)
        sqn = torch.sum(x_hat * x_hat, dim=-1)[safe]
        return codes[safe], sqn, vmin, step
    if dtype not in ("bf16", torch.bfloat16):
        raise ValueError(f"neighbour table dtype must be bf16 or int8, got {dtype!r}")
    table = vectors.to(torch.bfloat16)[safe]
    v32 = vectors.float()
    sqn = torch.sum(v32 * v32, dim=-1)[safe]
    return table, sqn, None, None


def _encode_slabs(list_vecs: torch.Tensor, mask: torch.Tensor, slab_dtype: str):
    """Slab storage: ``(stored, sqn [Nb, L], mu [Nb, d] | None)``.

    bf16 slabs store the per-block-mean residual: the f32 mean ``mu``
    carries the block's offset exactly (one ``[B, W]`` f32 term per wave)
    and bf16 rounding only touches the intra-block scatter. Norms are of the
    reconstructed values ``mu + bf16(x - mu)``, so the l2 expansion is exact
    with respect to what the wave scores.
    """
    if slab_dtype != "bf16":
        return list_vecs, torch.sum(list_vecs * list_vecs, dim=-1), None
    m = mask.to(torch.float32)
    cnt = torch.clamp(torch.sum(m, dim=1), min=1.0)
    mu = torch.sum(list_vecs, dim=1) / cnt  # [Nb, d] f32
    resid = (list_vecs - mu[:, None, :]) * m
    stored = resid.to(torch.bfloat16)
    xhat = (mu[:, None, :] + stored.float()) * m
    return stored, torch.sum(xhat * xhat, dim=-1), mu


def build_block_graph(
    vectors: torch.Tensor,
    n_blocks: int,
    degree: int,
    seed: int = 42,
    train_iters: int = 12,
    block_cap: int = 1024,
    spill: float = 0.0,
    slab_dtype: str = "f32",  # f32 | bf16 (bf16: half the wave bytes)
):
    """Memory-parity graph layout: cluster-sorted corpus + block-level graph.

    k-means over the corpus (``ops/kmeans``), then :func:`_block_layout`
    from the centroids. Returns the 7-tuple ``(entries [Ne, d], entry_block
    [Ne], slot_ids [Nb, L], list_vecs [Nb, L, d], list_sqn [Nb, L],
    entry_adj [Ne, R], list_mu [Nb, d] | None)``.
    """
    from vectordb_retrieval_tpu_torch.ops.kmeans import kmeans_fit, training_sample

    n = vectors.shape[0]
    n_blocks = max(1, min(n_blocks, n))
    sample = training_sample(n, n_blocks, seed)
    train = vectors if sample is None else vectors[sample.to(vectors.device)]
    centroids, _ = kmeans_fit(train, n_blocks, seed=seed, iters=train_iters)
    return _block_layout(vectors, centroids, degree, spill, slab_dtype)


def _spilled(a1: np.ndarray, a2: np.ndarray, margin: np.ndarray, spill: float):
    """SOAR-style spilled assignment: the ``spill * N`` rows of smallest
    runner-up margin are cloned into their runner-up cluster. Boundary
    rows are the ones whose true neighbours live across the partition
    cut. Returns ``(row_of [n_ext], assign_ext [n_ext], clones)``: the
    first N entries are the rows themselves, then the clones."""
    n = a1.shape[0]
    n_spill = int(spill * n)
    sel = np.argpartition(margin, max(n_spill - 1, 0))[:n_spill].astype(np.int64)
    row_of = np.concatenate([np.arange(n, dtype=np.int64), sel])
    return row_of, np.concatenate([a1, a2[sel]]), sel


def _chop(row_of: np.ndarray, assign_ext: np.ndarray, n: int, n_blocks: int):
    """The block layout of the (possibly spilled) assignment: entries
    stably sorted by cluster and chopped into exact blocks of
    ``ceil(N / n_blocks)`` rows (from the PRE-spill count, so the slab
    shape does not depend on the spill knob; only the last block carries
    pad slots, -1). Segments are the maximal runs of one cluster inside
    one block. Returns ``(order, slot_np [Nb, L], seg_ids [n_ext],
    entry_block [Ne])``."""
    n_ext = row_of.shape[0]
    block_len = max(1, -(-n // n_blocks))
    n_blocks = -(-n_ext // block_len)
    order = np.argsort(assign_ext, kind="stable").astype(np.int64)
    pad = n_blocks * block_len - n_ext
    slot_np = np.concatenate(
        [row_of[order].astype(np.int32), np.full(pad, -1, np.int32)]
    ).reshape(n_blocks, block_len)
    sorted_assign = assign_ext[order]
    block_of = np.arange(n_ext) // block_len
    boundary = np.ones(n_ext, dtype=bool)
    boundary[1:] = (sorted_assign[1:] != sorted_assign[:-1]) | (
        block_of[1:] != block_of[:-1]
    )
    return order, slot_np, np.cumsum(boundary) - 1, block_of[boundary]


def _finish_layout(list_vecs, slot_np, seg_ids, entry_block_np, degree, slab_dtype):
    """Router entries (segment means), their exact RNG graph and the slab
    encoding of the sorted corpus ``list_vecs [Nb, L, d]`` (pad rows 0):
    the 7-tuple of :func:`build_block_graph`."""
    dev = list_vecs.device
    n_entries = int(seg_ids[-1]) + 1 if seg_ids.shape[0] else 1
    entries = _segment_means(list_vecs, seg_ids, entry_block_np, n_entries)
    # entry-level RNG graph: an exact build at Ne ~ 1.5 N / L rows
    adj = build_knn_graph(entries, min(degree, entries.shape[0] - 1), method="exact")
    slot_ids = torch.as_tensor(slot_np, device=dev)
    list_vecs, list_sqn, list_mu = _encode_slabs(
        list_vecs, (slot_ids >= 0)[:, :, None], slab_dtype)
    return (
        entries,
        torch.as_tensor(entry_block_np.astype(np.int32), device=dev),
        slot_ids,
        list_vecs,
        list_sqn,
        adj,
        list_mu,
    )


def _block_layout(
    vectors: torch.Tensor,
    centroids: torch.Tensor,
    degree: int,
    spill: float = 0.0,
    slab_dtype: str = "f32",
):
    """The block layout of :func:`build_block_graph` from given centroids.

    Rows are assigned to their nearest centroid (with ``spill``, the
    ``spill * N`` rows of smallest runner-up margin are cloned into their
    runner-up cluster too), stably sorted by cluster and chopped into exact
    blocks of ``ceil(N / n_blocks)`` rows (only the last block carries pad
    slots, -1). One router entry per maximal run of one cluster inside one
    block, at the mean of that run, with an entry -> block map; the entries
    get an exact RNG graph of ``degree``.
    """
    from vectordb_retrieval_tpu_torch.ops.kmeans import kmeans_assign, kmeans_assign2

    n = vectors.shape[0]
    n_blocks = centroids.shape[0]
    # the chunk bounds the [chunk, n_blocks] distance transient at ~512 MB
    chunk = max(256, min(16_384, (512 << 20) // max(n_blocks * 4, 1)))
    if spill > 0.0 and n_blocks >= 2:
        a1, a2, margin = kmeans_assign2(vectors, centroids, chunk=chunk)
        row_of, assign, _ = _spilled(
            a1.cpu().numpy(), a2.cpu().numpy(), margin.cpu().numpy(), spill)
    else:
        assign = kmeans_assign(vectors, centroids, chunk=chunk).cpu().numpy()
        row_of = np.arange(n, dtype=np.int64)
    _, slot_np, seg_ids, entry_block_np = _chop(row_of, assign, n, n_blocks)
    slot_ids = torch.as_tensor(slot_np, device=vectors.device)
    list_vecs = vectors[slot_ids.clamp(min=0).long()] * (slot_ids >= 0)[:, :, None]
    return _finish_layout(list_vecs, slot_np, seg_ids, entry_block_np, degree, slab_dtype)


def _segment_means(
    list_vecs: torch.Tensor,  # [Nb, L, d], the sorted corpus (pad rows 0)
    seg_ids: np.ndarray,  # [n_ext] segment of each sorted row, nondecreasing
    seg_block: np.ndarray,  # [Ne] block of each segment
    n_entries: int,
) -> torch.Tensor:
    """Mean of each segment ``[Ne, d]``. A segment is a run of rows inside
    one block, so each block's segment sums are one product of a one-hot
    ``[m, L]`` matrix with the block's slab (``m`` = most segments in a
    block): batched, and free of atomics, so the sums are the same from
    run to run."""
    nb, length, d = list_vecs.shape
    dev = list_vecs.device
    n_ext = seg_ids.shape[0]
    if n_ext == 0:
        return torch.zeros((1, d), dtype=torch.float32, device=dev)
    first_seg = seg_ids[np.arange(0, n_ext, length)]  # first segment of each block
    local = np.full(nb * length, -1, np.int64)
    local[:n_ext] = seg_ids - first_seg[np.arange(n_ext) // length]
    m = int(local.max()) + 1
    # pad slots get class m, cut off after the one-hot
    cls = torch.as_tensor(np.where(local >= 0, local, m).reshape(nb, length), device=dev)
    onehot = F.one_hot(cls, m + 1)[:, :, :m].to(torch.float32)  # [Nb, L, m]
    sums = torch.bmm(onehot.transpose(1, 2), list_vecs).reshape(nb * m, d)
    where = torch.as_tensor(
        seg_block.astype(np.int64) * m + (np.arange(n_entries) - first_seg[seg_block]),
        device=dev,
    )
    counts = torch.as_tensor(
        np.bincount(seg_ids, minlength=n_entries).astype(np.float32), device=dev
    )
    return sums[where] / torch.clamp(counts, min=1.0)[:, None]


def build_block_graph_stream(
    store,
    n_blocks: int,
    degree: int,
    seed: int = 42,
    train_iters: int = 12,
    normalize: bool = False,
    chunk_rows: int = 262_144,
    spill: float = 0.0,
    slab_dtype: str = "f32",
    device: DeviceLike = None,
):
    """Out-of-core block-graph build: the layout of :func:`build_block_graph`
    assembled from a host source (``np.memmap`` / ``BigStore``) in
    sequential passes, with no random host reads:

      pass 0: an evenly spaced sample of 4,096-row blocks trains k-means;
      pass 1: each chunk is assigned (K3; top-2 when spilling);
      pass 2: each chunk's rows are copied to their home slot in ONE
        preallocated flat ``[Nb * L, d]`` buffer on ``device`` (the slot of
        a row is its rank in the cluster-sorted order, known on the host
        from the assignment; ``index_copy_`` over a permutation, so no two
        rows meet), spilled clones a second time to theirs.

    The router entries are then the segment means of the filled buffer,
    summed by the resident build's batched one-hot product, so they are
    free of atomics and the same from run to run. Host RSS stays O(chunk);
    device memory is the layout plus one chunk (the resident build's
    gather holds the corpus and the layout at once).
    """
    from vectordb_retrieval_tpu_torch.data.storage import _read_chunk, iter_device_chunks
    from vectordb_retrieval_tpu_torch.ops.kmeans import (
        kmeans_assign,
        kmeans_assign2,
        kmeans_fit,
    )

    dev = resolve_device(device)
    n, d = (int(s) for s in store.shape)
    n_blocks = max(1, min(n_blocks, n))

    def prep(rows: torch.Tensor) -> torch.Tensor:
        return dops.normalize(rows) if normalize else rows

    target = min(n, max(n_blocks * 32, 65_536))
    blk = 4096
    stride = max(1, n // max(1, -(-target // blk)))
    sample = np.concatenate(
        [_read_chunk(store, s, min(s + blk, n)) for s in range(0, n, stride)]
    )[:target]
    centroids, _ = kmeans_fit(prep(torch.as_tensor(sample, device=dev)), n_blocks, seed=seed,
                              iters=train_iters)
    del sample

    use_spill = spill > 0.0 and n_blocks >= 2
    a1 = np.empty(n, dtype=np.int64)
    a2 = np.empty(n, dtype=np.int64) if use_spill else None
    margin = np.empty(n, dtype=np.float32) if use_spill else None
    for start, rows in iter_device_chunks(store, chunk_rows, dev):
        stop = start + rows.shape[0]
        if use_spill:
            c1, c2, mg = kmeans_assign2(prep(rows), centroids)
            a1[start:stop], a2[start:stop] = c1.cpu().numpy(), c2.cpu().numpy()
            margin[start:stop] = mg.cpu().numpy()
        else:
            a1[start:stop] = kmeans_assign(prep(rows), centroids).cpu().numpy()
    if use_spill:
        row_of, assign_ext, clones = _spilled(a1, a2, margin, spill)
    else:
        row_of, assign_ext = np.arange(n, dtype=np.int64), a1
        clones = np.empty(0, dtype=np.int64)
    order, slot_np, seg_ids, entry_block_np = _chop(row_of, assign_ext, n, n_blocks)
    rank = np.empty(order.shape[0], dtype=np.int64)  # ext entry -> sorted slot
    rank[order] = np.arange(order.shape[0])
    clone_slot = np.full(n, -1, dtype=np.int64)  # row -> its clone's slot
    clone_slot[clones] = rank[n:]

    buf = torch.zeros((slot_np.size, d), dtype=torch.float32, device=dev)
    rank_dev = torch.as_tensor(rank[:n], device=dev)
    for start, rows in iter_device_chunks(store, chunk_rows, dev):
        stop = start + rows.shape[0]
        rows = prep(rows)
        buf.index_copy_(0, rank_dev[start:stop], rows)
        if clones.size:
            local = np.nonzero(clone_slot[start:stop] >= 0)[0]
            if local.size:
                buf.index_copy_(
                    0, torch.as_tensor(clone_slot[start:stop][local], device=dev),
                    rows[torch.as_tensor(local, device=dev)])
        del rows
    list_vecs = buf.reshape(slot_np.shape[0], slot_np.shape[1], d)  # pad rows 0
    return _finish_layout(list_vecs, slot_np, seg_ids, entry_block_np, degree, slab_dtype)


def pick_entry_points(vectors: torch.Tensor, n_entry: int, seed: int = 0) -> torch.Tensor:
    """Coarse-quantizer entry points ``[E]`` int32: k-means over the data
    and the nearest real row of each centroid, sorted and unique, padded
    with -1 (the JAX package's ``jnp.unique(size=, fill_value=-1)``). One
    ``[B, E]`` product per batch then replaces HNSW's hierarchy descent."""
    from vectordb_retrieval_tpu_torch.ops.kmeans import kmeans_fit, training_sample

    n = vectors.shape[0]
    dev = vectors.device
    n_entry = min(n_entry, n)
    if n_entry <= 1:
        mean = torch.mean(vectors, dim=0, keepdim=True)
        _, medoid = dops.exact_search(mean, vectors, 1, metric="l2", device=dev)
        return medoid[0].to(torch.int32)
    sample = training_sample(n, n_entry, seed)
    train = vectors if sample is None else vectors[sample.to(dev)]
    centers, _ = kmeans_fit(train, n_entry, seed=seed, iters=8)
    _, nearest = dops.exact_search(centers, vectors, 1, metric="l2", device=dev)
    uniq = torch.unique(nearest[:, 0].to(torch.int32), sorted=True)
    return F.pad(uniq, (0, n_entry - uniq.shape[0]), value=-1)


# ---- block beam ----------------------------------------------------------


class _BlockState(NamedTuple):
    qn: torch.Tensor  # [B] squared query norms
    cd: torch.Tensor  # [B, Ne] query -> entry distances
    beam_ids: torch.Tensor  # [B, efb] frontier entry ids
    beam_blk: torch.Tensor  # [B, efb] their blocks
    beam_d: torch.Tensor  # [B, efb] their distances (+inf once popped)
    rk_d: torch.Tensor  # [B, kk] running row top-k
    rk_i: torch.Tensor  # [B, kk]
    visited: torch.Tensor  # [B, expand * iters] probed blocks (-1 free)


class _Popped(NamedTuple):
    sel_blocks: torch.Tensor  # [B, W] block ids to probe, -1 = skip
    safe_blk: torch.Tensor  # [B, W] the same clamped to [0, Nb)
    sel_entries: torch.Tensor  # [B, W] popped entry ids
    sel_valid: torch.Tensor  # [B, W] popped a finite frontier entry


class BlockBeam:
    """The block beam of one query batch, cut into its stages.

    ``seed`` (the dense entry scan and the frontier), then per wave
    ``pop`` (the ``expand`` nearest unvisited entries, intra-wave and
    visited dedup), ``score`` (kernel K2 on the popped blocks' slabs),
    ``merge`` (the exact f32 row distances and one top-k merge) and, on
    every wave but the last, ``push`` (the popped entries' graph
    neighbours into the frontier, deduplicated by block); then ``result``.
    Every stage is a function of its inputs: calling one again gives the
    same output. Nothing is computed from the queries before ``seed``, so
    a CUDA graph of the stages (:func:`block_graph_search`) reads them
    from the one buffer it was captured with.
    """

    def __init__(
        self,
        queries: torch.Tensor,
        entries: torch.Tensor,  # [Ne, d] router entries (segment means)
        entry_block: torch.Tensor,  # [Ne] entry -> block map
        slot_ids: torch.Tensor,  # [Nb, L] member row ids (-1 pad)
        list_vecs: torch.Tensor,  # [Nb, L, d] f32 slabs | bf16 residual slabs
        list_sqn: torch.Tensor,  # [Nb, L]
        entry_adj: torch.Tensor,  # [Ne, R] entry graph
        list_mu: Optional[torch.Tensor] = None,  # [Nb, d] f32 block means
        k: int = 10,
        efb: int = 32,
        expand: int = 8,
        iters: int = 8,
        metric: str = "l2",
        dedup: bool = False,
    ):
        if list_mu is not None and list_mu.dim() != 2:
            raise TypeError("list_mu must be a [Nb, d] tensor or None")
        self.q = queries.contiguous()
        self.entries = entries
        self.entry_block = entry_block.long()
        self.slot_ids = slot_ids
        self.list_vecs = list_vecs
        self.list_sqn = list_sqn
        self.entry_adj = entry_adj.long()
        self.list_mu = list_mu
        self.metric = metric
        self.dedup = dedup
        self.k = k
        ne = entries.shape[0]
        self.efb = min(efb, ne)
        self.expand = min(expand, self.efb)
        self.iters = int(iters)
        # spilled layouts clone boundary rows into a second block: merging
        # at 2k and deduplicating at the end keeps k unique ids
        self.kk = min(2 * k if dedup else k, slot_ids.shape[0] * slot_ids.shape[1])

    def seed(self) -> _BlockState:
        b = self.q.shape[0]
        dev = self.q.device
        cd = dops.pairwise_distances(self.q, self.entries, self.metric)  # [B, Ne]
        seed_d, beam_ids = dops.top_k_smallest(cd, self.efb)
        beam_blk = self.entry_block[beam_ids]
        # seed block dedup: later seed entries of an already-seeded block
        # would re-probe it in a later wave
        beam_d = torch.where(_earlier_equal(beam_blk), _INF, seed_d)
        return _BlockState(
            torch.sum(self.q * self.q, dim=-1), cd, beam_ids, beam_blk, beam_d,
            torch.full((b, self.kk), _INF, dtype=torch.float32, device=dev),
            torch.full((b, self.kk), -1, dtype=torch.int64, device=dev),
            torch.full((b, self.expand * self.iters), -1, dtype=torch.int64, device=dev),
        )

    def pop(self, st: _BlockState, t: int) -> Tuple[_BlockState, _Popped]:
        w = self.expand
        _, sel = dops.top_k_smallest(st.beam_d, w)
        sel_blocks = torch.gather(st.beam_blk, 1, sel)
        sel_valid = torch.isfinite(torch.gather(st.beam_d, 1, sel))
        sel_entries = torch.gather(st.beam_ids, 1, sel)
        # intra-wave block dedup (two frontier entries can share a block)
        # and the visited check
        fresh = sel_valid & ~_earlier_equal(sel_blocks) & ~_member(sel_blocks, st.visited)
        sel_blocks = torch.where(fresh, sel_blocks, -1)
        beam_d = st.beam_d.scatter(1, sel, _INF)
        visited = st.visited.clone()
        visited[:, t * w : (t + 1) * w] = sel_blocks
        popped = _Popped(sel_blocks, sel_blocks.clamp(min=0), sel_entries, sel_valid)
        return st._replace(beam_d=beam_d, visited=visited), popped

    def score(self, p: _Popped) -> torch.Tensor:
        """Kernel K2: ``[B, W, L]`` dots of each query with its popped slabs."""
        return kernels.slab_dots(self.q, self.list_vecs, p.safe_blk)

    def merge(self, st: _BlockState, p: _Popped, dots: torch.Tensor) -> _BlockState:
        b, w = p.sel_blocks.shape
        length = self.slot_ids.shape[1]
        if self.list_mu is not None:
            # mean-centred slabs: the exact f32 block-mean term, one [B, W]
            # dot amortised over the whole L-row slab
            mu_dot = torch.bmm(self.list_mu[p.safe_blk], self.q[:, :, None])
            dots = dots + mu_dot
        ids = torch.where(
            (p.sel_blocks >= 0)[:, :, None], self.slot_ids[p.safe_blk].long(), -1
        ).reshape(b, w * length)
        if self.metric == "l2":
            dist = st.qn[:, None, None] + self.list_sqn[p.safe_blk] - 2.0 * dots
        else:
            dist = -dots
        dist = torch.where(ids >= 0, dist.reshape(b, w * length), _INF)
        cat_d = torch.cat([st.rk_d, dist], dim=1)
        cat_i = torch.cat([st.rk_i, ids], dim=1)
        rk_d, selr = dops.top_k_smallest(cat_d, self.kk)
        return st._replace(rk_d=rk_d, rk_i=torch.gather(cat_i, 1, selr))

    def push(self, st: _BlockState, p: _Popped) -> _BlockState:
        b = self.q.shape[0]
        nbr = torch.where(
            p.sel_valid[:, :, None], self.entry_adj[p.sel_entries.clamp(min=0)], -1
        ).reshape(b, -1)  # [B, W*R] entry ids
        c = nbr.shape[1]
        safe_nbr = nbr.clamp(min=0)
        nbr_blk = torch.where(nbr >= 0, self.entry_block[safe_nbr], -1)
        ncd = torch.gather(st.cd, 1, safe_nbr)
        fresh = (nbr >= 0) & ~_member(nbr_blk, st.beam_blk) & ~_member(nbr_blk, st.visited)
        ncd = torch.where(fresh, ncd, _INF)
        # only the best efb candidates can enter the efb-wide frontier: keep
        # efb + one wave of headroom for duplicate-block copies, then dedup
        # by block (the sorted order keeps the best copy)
        keep = min(self.efb + 96, c)
        kd, kpos = dops.top_k_smallest(ncd, keep)
        kids = torch.gather(nbr, 1, kpos)
        kblk = torch.gather(nbr_blk, 1, kpos)
        kd = torch.where(_earlier_equal(kblk), _INF, kd)
        cat_ids = torch.cat([st.beam_ids, kids], dim=1)
        cat_blk = torch.cat([st.beam_blk, kblk], dim=1)
        cat_d = torch.cat([st.beam_d, kd], dim=1)
        beam_d, pos = dops.top_k_smallest(cat_d, self.efb)
        return st._replace(
            beam_ids=torch.gather(cat_ids, 1, pos),
            beam_blk=torch.gather(cat_blk, 1, pos),
            beam_d=beam_d,
        )

    def result(self, st: _BlockState) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.dedup:
            return st.rk_d, st.rk_i
        # clone copies of a row: keep the first occurrence (distance order)
        # and re-select k
        is_dup = _earlier_equal(st.rk_i) & (st.rk_i >= 0)
        rk_d = torch.where(is_dup, _INF, st.rk_d)
        nd, sel = dops.top_k_smallest(rk_d, min(self.k, self.kk))
        return nd, torch.gather(st.rk_i, 1, sel)

    def wave(self, st: _BlockState, t: int) -> _BlockState:
        """Wave ``t``: ``pop``, ``score``, ``merge`` and, but on the last
        wave, ``push``."""
        st, p = self.pop(st, t)
        st = self.merge(st, p, self.score(p))
        if t < self.iters - 1:  # pushed neighbours of the last wave are never popped
            st = self.push(st, p)
        return st

    def run(self) -> Tuple[torch.Tensor, torch.Tensor]:
        with span("vrt.seed"):
            st = self.seed()
        for t in range(self.iters):
            with span("vrt.wave"):
                st = self.wave(st, t)
        return self.result(st)


# ---- the block beam as CUDA graphs ---------------------------------------

# the most capture keys kept at once (seen once, or captured); the oldest
# is dropped first
_GRAPH_KEYS = 8
# capture key -> (the finalizer that drops it with its index's list_vecs,
# None while the key has run once eagerly | its graphs)
_GRAPHS: "OrderedDict[tuple, Tuple[weakref.finalize, Optional[_BeamGraphs]]]" = OrderedDict()
# device -> the side stream every capture on it runs on
_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _identity(t: Optional[torch.Tensor]) -> Optional[tuple]:
    if t is None:
        return None
    return t.data_ptr(), tuple(t.shape), t.stride(), t.dtype


def graph_key(queries: torch.Tensor, index: Sequence[Optional[torch.Tensor]], k: int,
              efb: int, expand: int, iters: int, metric: str, dedup: bool) -> tuple:
    """Everything a capture of the block beam reads: the device, the query
    batch's shape and dtype, the geometry, and each index tensor's address,
    shape, strides and dtype (``index``: the arguments of
    :func:`block_graph_search` from ``entries`` to ``list_mu``). A new
    query batch of the same shape over the same index has the same key."""
    return (queries.device, tuple(queries.shape), queries.dtype, k, efb, expand, int(iters),
            metric, bool(dedup), tuple(_identity(t) for t in index))


def graphs_allowed(device: torch.device) -> bool:
    """Whether a call on ``device`` may capture or replay: on a CUDA card,
    outside a work count (its slab count reads the card, a
    synchronisation a capture cannot hold) and outside another capture."""
    return (device.type == "cuda" and not kernels.counting_work()
            and not torch.cuda.is_current_stream_capturing())


class _BeamGraphs:
    """The block beam of one key as CUDA graphs: ``seed``, then one graph a
    wave (the last with ``result``), captured in order into one private
    memory pool and replayed in that order on the current stream. Holds
    every tensor the graphs read or write, but the index's ``list_vecs``,
    whose end drops the key (:func:`block_graph_search`): the query
    buffer, each stage's state, the outputs, the other index tensors and
    the beam's int64 copies of ``entry_block`` and ``entry_adj``."""

    def __init__(self, queries: torch.Tensor, index: Sequence[Optional[torch.Tensor]],
                 geometry: Dict[str, object]):
        dev = queries.device
        self.q = torch.empty(queries.shape, dtype=queries.dtype, device=dev)
        self.q.copy_(queries)
        beam = BlockBeam(self.q, *index, **geometry)
        stream = _CAPTURE_STREAMS.get(dev)
        if stream is None:
            stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        # one eager run on the capture stream first: the libraries' per-stream
        # workspaces are made outside the graphs' pool
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            beam.run()
        torch.cuda.current_stream(dev).wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.states: List[_BlockState] = []
        for t in range(-1, beam.iters):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                st = beam.seed() if t < 0 else beam.wave(self.states[-1], t)
                if t == beam.iters - 1:
                    self.out = beam.result(st)
            self.graphs.append(graph)
            self.states.append(st)
        self.index = (beam.entries, beam.entry_block, beam.slot_ids, beam.list_sqn,
                      beam.entry_adj, beam.list_mu)

    def __call__(self, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        self.q.copy_(queries)
        with span("vrt.seed"):
            self.graphs[0].replay()
        for graph in self.graphs[1:]:
            with span("vrt.wave"):
                graph.replay()
        # copies: the next replay overwrites the outputs
        return self.out[0].clone(), self.out[1].clone()


def _cached_graphs(queries: torch.Tensor, index: Sequence[Optional[torch.Tensor]],
                   geometry: Dict[str, object]) -> Optional[_BeamGraphs]:
    """The graphs of this call's key: None on the key's first call (it runs
    eagerly), captured on its second, replayed after."""
    key = graph_key(queries, index, **geometry)
    if key not in _GRAPHS:
        _seen(key, index[3])  # list_vecs
        return None
    _GRAPHS.move_to_end(key)
    fin, graphs = _GRAPHS[key]
    if graphs is None:
        graphs = _BeamGraphs(queries, index, geometry)
        _GRAPHS[key] = (fin, graphs)
        kernels.BEAM_CALLS["captured"] += 1
    else:
        kernels.BEAM_CALLS["replayed"] += 1
    return graphs


def _seen(key: tuple, list_vecs: torch.Tensor) -> None:
    """Record that ``key`` ran once; the record ends with ``list_vecs``."""
    fin = weakref.finalize(list_vecs, _GRAPHS.pop, key, None)
    fin.atexit = False
    _GRAPHS[key] = (fin, None)
    while len(_GRAPHS) > _GRAPH_KEYS:
        _, (old, _) = _GRAPHS.popitem(last=False)
        old.detach()


def block_graph_search(
    queries: torch.Tensor,
    entries: torch.Tensor,
    entry_block: torch.Tensor,
    slot_ids: torch.Tensor,
    list_vecs: torch.Tensor,
    list_sqn: torch.Tensor,
    entry_adj: torch.Tensor,
    list_mu: Optional[torch.Tensor] = None,
    k: int = 10,
    efb: int = 32,  # frontier width
    expand: int = 8,  # blocks probed per wave
    iters: int = 8,  # waves; probe budget = expand * iters
    metric: str = "l2",
    dedup: bool = False,  # spilled layouts: id-level dedup of the top-k
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam over router entries; returns exact f32 ``(dists, ids) [B, k]``.

    The dense entry scan seeds a frontier of ``efb`` entries; each wave pops
    the ``expand`` nearest unvisited entries, scores ALL member rows of their
    blocks (kernel K2, one top-k merge per wave) and pushes the popped
    entries' graph neighbours (deduplicated by block against the visited
    blocks and the frontier), ranked by their entry distance. See
    :class:`BlockBeam` for the stages.

    On a CUDA card the stages run as CUDA graphs: the first call of a key
    (:func:`graph_key`) runs eagerly, the second captures the seed and each
    wave (:class:`_BeamGraphs`), every later one copies its queries into
    the captured buffer and replays them, each graph in its ``vrt.seed`` or
    ``vrt.wave`` span. The same kernels run on the same inputs, so the
    answers are the eager ones bit for bit. Keys are kept until their
    ``list_vecs`` is freed, at most ``_GRAPH_KEYS`` of them. CPU tensors,
    and calls where :func:`graphs_allowed` is false, run eagerly.
    ``kernels.BEAM_CALLS`` counts the calls by how they ran.
    """
    index = (entries, entry_block, slot_ids, list_vecs, list_sqn, entry_adj, list_mu)
    geometry = dict(k=k, efb=efb, expand=expand, iters=iters, metric=metric, dedup=dedup)
    if graphs_allowed(queries.device):
        with torch.cuda.device(queries.device):
            graphs = _cached_graphs(queries, index, geometry)
            if graphs is not None:
                return graphs(queries)
    kernels.BEAM_CALLS["eager"] += 1
    return BlockBeam(queries, *index, **geometry).run()


# ---- node beam -----------------------------------------------------------


def _batch_dists(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    sqnorms: torch.Tensor,
    ids: torch.Tensor,
    metric: str,
) -> torch.Tensor:
    """Distances from each query to its own id list ``[B, C]`` (+inf for
    negative ids); the queries are cast to the corpus dtype and the
    products summed in f32."""
    safe = ids.clamp(min=0)
    vecs = vectors[safe].float()  # [B, C, d]
    q_cast = queries.to(vectors.dtype).float()
    dots = torch.bmm(vecs, q_cast[:, :, None])[:, :, 0]
    if metric == "l2":
        qn = torch.sum(queries * queries, dim=-1)
        d = qn[:, None] + sqnorms[safe] - 2.0 * dots
    else:
        d = -dots
    return torch.where(ids >= 0, d, _INF)


class _NodeState(NamedTuple):
    beam_ids: torch.Tensor  # [B, ef] node ids (-1 free)
    beam_d: torch.Tensor  # [B, ef]
    beam_exp: torch.Tensor  # [B, ef] expanded flags


class NodeBeam:
    """The node beam of one query batch, cut into its stages: ``seed``
    (the entry points scored with one ``[B, E]`` product), ``iters`` calls
    of ``step`` (expand the ``expand`` best unexpanded entries, score their
    neighbours, merge the best ``cand_keep`` new ones) and ``result`` (the
    exact f32 rescore when asked). Every stage is a function of its
    inputs."""

    def __init__(
        self,
        queries: torch.Tensor,
        vectors: torch.Tensor,  # f32 corpus (seed gather + final rescore)
        adjacency: torch.Tensor,  # [N, R]
        entry_ids: torch.Tensor,  # [E]
        k: int,
        ef: int = 64,
        expand: int = 4,
        iters: int = 12,
        metric: str = "l2",
        sqnorms: Optional[torch.Tensor] = None,  # f32 row norms (l2)
        cand_keep: int = 0,  # per-iteration insert cap (0 = ef)
        nbr_vecs: Optional[torch.Tensor] = None,  # [N, R, d] table (bf16 | u8)
        nbr_sqn: Optional[torch.Tensor] = None,  # [N, R] f32 norms of table rows
        rescore: bool = False,  # exact f32 rescore of the final candidates
        nbr_vmin: Optional[torch.Tensor] = None,  # [d] SQ range (u8 tables)
        nbr_step: Optional[torch.Tensor] = None,  # [d] SQ step (u8 tables)
    ):
        self.q = queries
        self.vectors = vectors
        self.adjacency = adjacency.long()
        self.entry_ids = entry_ids.long()
        self.k, self.ef, self.expand, self.iters = k, ef, expand, int(iters)
        self.metric = metric
        if sqnorms is None:
            v32 = vectors.float()
            sqnorms = torch.sum(v32 * v32, dim=-1)
        self.sqnorms = sqnorms
        r = adjacency.shape[1]
        self.keep = min(cand_keep or ef, expand * r)
        self.nbr_vecs, self.nbr_sqn = nbr_vecs, nbr_sqn
        self.nbr_vmin, self.nbr_step = nbr_vmin, nbr_step
        self.rescore = rescore
        self.qn = torch.sum(queries * queries, dim=-1)

    def seed(self) -> _NodeState:
        b = self.q.shape[0]
        e = self.entry_ids.shape[0]
        ef = self.ef
        # entry rows are shared by every query: one [B, E] product
        seed_ids = self.entry_ids[None, :].expand(b, e)
        safe_entry = self.entry_ids.clamp(min=0)
        entry_vecs = self.vectors[safe_entry]  # [E, d]
        seed_dots = self.q.to(entry_vecs.dtype).float() @ entry_vecs.float().T
        if self.metric == "l2":
            seed_d = self.qn[:, None] + self.sqnorms[safe_entry][None, :] - 2.0 * seed_dots
        else:
            seed_d = -seed_dots
        seed_d = torch.where(self.entry_ids[None, :] >= 0, seed_d, _INF)
        if e > ef:
            seed_d, sel = dops.top_k_smallest(seed_d, ef)
            seed_ids = torch.gather(seed_ids, 1, sel)
            e = ef
        pad = max(ef - e, 0)
        beam_ids = F.pad(seed_ids, (0, pad), value=-1)[:, :ef]
        beam_d = F.pad(seed_d, (0, pad), value=_INF)[:, :ef]
        beam_exp = torch.zeros((b, ef), dtype=torch.bool, device=self.q.device)
        return _NodeState(beam_ids, beam_d, beam_exp)

    def _neighbours(self, sel_ids: torch.Tensor, sel_valid: torch.Tensor):
        """(neighbour ids [B, W*R], their distances [B, W*R])."""
        b, w = sel_ids.shape
        r = self.adjacency.shape[1]
        safe_sel = sel_ids.clamp(min=0)
        neigh3 = self.adjacency[safe_sel]  # [B, W, R]
        if self.nbr_vecs is None:
            neigh = torch.where(sel_valid[:, :, None] & (neigh3 >= 0), neigh3, -1)
            neigh = neigh.reshape(b, w * r)
            return neigh, _batch_dists(self.q, self.vectors, self.sqnorms, neigh, self.metric)
        nvec = self.nbr_vecs[safe_sel].float()  # [B, W, R, d] one block gather
        nsqn = self.nbr_sqn[safe_sel]  # [B, W, R]
        if self.nbr_vecs.dtype == torch.uint8:
            # SQ8 table: the affine decode folded into the contraction,
            # q.x_hat = q.vmin + bf16(q * step).codes
            q_scaled = (self.q * self.nbr_step[None, :]).to(torch.bfloat16).float()
            dots = torch.einsum("bwrd,bd->bwr", nvec, q_scaled)
            dots = dots + (self.q @ self.nbr_vmin)[:, None, None]
        else:
            q_cast = self.q.to(self.nbr_vecs.dtype).float()
            dots = torch.einsum("bwrd,bd->bwr", nvec, q_cast)
        if self.metric == "l2":
            nd3 = self.qn[:, None, None] + nsqn - 2.0 * dots
        else:
            nd3 = -dots
        neigh = torch.where(sel_valid[:, :, None] & (neigh3 >= 0), neigh3, -1)
        neigh = neigh.reshape(b, w * r)
        return neigh, torch.where(neigh >= 0, nd3.reshape(b, w * r), _INF)

    def step(self, st: _NodeState) -> _NodeState:
        # 1. the W best unexpanded entries
        sel_d = torch.where(st.beam_exp | (st.beam_ids < 0), _INF, st.beam_d)
        _, sel = dops.top_k_smallest(sel_d, self.expand)
        sel_ids = torch.gather(st.beam_ids, 1, sel)
        sel_valid = torch.isfinite(torch.gather(sel_d, 1, sel))
        beam_exp = st.beam_exp.scatter(1, sel, True)
        # 2. gather + score their neighbours
        neigh, nd = self._neighbours(sel_ids, sel_valid)
        # 3. drop candidates already in the beam
        nd = torch.where(_member(neigh, st.beam_ids) | (neigh < 0), _INF, nd)
        # 4. the best `keep` new candidates
        cand_d, cpos = dops.top_k_smallest(nd, self.keep)
        cand_ids = torch.gather(neigh, 1, cpos)
        # 5. intra-set dedup: keep the first (best-ranked) copy
        cand_d = torch.where(_earlier_equal(cand_ids) | (cand_ids < 0), _INF, cand_d)
        # 6. merge
        cat_ids = torch.cat([st.beam_ids, cand_ids], dim=1)
        cat_d = torch.cat([st.beam_d, cand_d], dim=1)
        cat_exp = torch.cat([beam_exp, torch.zeros_like(cand_ids, dtype=torch.bool)], dim=1)
        new_d, pos = dops.top_k_smallest(cat_d, self.ef)
        new_ids = torch.gather(cat_ids, 1, pos)
        new_exp = torch.gather(cat_exp, 1, pos)
        new_ids = torch.where(torch.isfinite(new_d), new_ids, -1)
        return _NodeState(new_ids, new_d, new_exp)

    def result(self, st: _NodeState) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.rescore:
            # exact f32 re-rank of the survivors (routing ran on table values)
            kk = min(self.k + 8, self.ef)
            _, pos = dops.top_k_smallest(st.beam_d, kk)
            fids = torch.gather(st.beam_ids, 1, pos)
            fvec = self.vectors[fids.clamp(min=0)].float()  # [B, kk, d]
            if self.metric == "l2":
                diff = fvec - self.q[:, None, :]
                fd = torch.sum(diff * diff, dim=-1)
            else:  # elementwise, not a product: an exact re-rank
                fd = -torch.sum(fvec * self.q[:, None, :], dim=-1)
            fd = torch.where(fids >= 0, fd, _INF)
            out_d, opos = dops.top_k_smallest(fd, min(self.k, kk))
            out_ids = torch.gather(fids, 1, opos)
            return out_d, torch.where(torch.isfinite(out_d), out_ids, -1)
        out_d, pos = dops.top_k_smallest(st.beam_d, min(self.k, self.ef))
        return out_d, torch.gather(st.beam_ids, 1, pos)

    def run(self) -> Tuple[torch.Tensor, torch.Tensor]:
        st = self.seed()
        for _ in range(self.iters):
            st = self.step(st)
        return self.result(st)


def graph_search(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    adjacency: torch.Tensor,
    entry_ids: torch.Tensor,
    k: int,
    ef: int = 64,
    expand: int = 4,
    iters: int = 12,
    metric: str = "l2",
    sqnorms: Optional[torch.Tensor] = None,
    cand_keep: int = 0,
    nbr_vecs: Optional[torch.Tensor] = None,
    nbr_sqn: Optional[torch.Tensor] = None,
    rescore: bool = False,
    nbr_vmin: Optional[torch.Tensor] = None,
    nbr_step: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched node beam search; returns ``(dists [B, k], ids [B, k])``.

    Each iteration expands the ``expand`` best unexpanded beam entries,
    scores their neighbours (from the corpus, or from the contiguous
    neighbour table, bf16 or SQ8 codes), masks candidates already in the
    beam, keeps the best ``cand_keep``, dedups them and merges. With a
    table, ``rescore=True`` re-ranks the final ``k + 8`` candidates against
    the f32 corpus. See :class:`NodeBeam` for the stages.
    """
    return NodeBeam(
        queries, vectors, adjacency, entry_ids, k, ef=ef, expand=expand,
        iters=iters, metric=metric, sqnorms=sqnorms, cand_keep=cand_keep,
        nbr_vecs=nbr_vecs, nbr_sqn=nbr_sqn, rescore=rescore,
        nbr_vmin=nbr_vmin, nbr_step=nbr_step,
    ).run()
