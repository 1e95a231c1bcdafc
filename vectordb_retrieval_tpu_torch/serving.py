"""Serving layer: mutable indexes with incremental add / delete and
query-time filtering.

Counterpart of ``vectordb_retrieval_tpu/serving.py``, with the same classes,
defaults, id contract and on-disk kinds (``mutable_flat``, ``mutable_ivf``),
so either package loads the other's saved indexes:

  * :class:`MutableFlatIndex` keeps the corpus in a capacity-doubling
    ``[C, d]`` device buffer written in place; deletions are tombstones, a
    penalty ``pen [C]`` of ``+inf`` on dead and unfilled slots added to the
    distance row (l2, ip and cosine alike); ``filter_ids`` folds into the
    same penalty for one call; :meth:`~MutableFlatIndex.compact` drops the
    tombstones (automatically once they exceed ``compact_frac`` of the
    live rows);
  * :class:`MutableIVFIndex` freezes its coarse quantizer (k-means on the
    initial corpus; every ``add`` assigns with the hand-written kernel K3,
    ``ops/kernels.assign``) and mutates bucketed inverted lists in place:
    deleted slots go to per-list free stacks, full lists claim fresh
    buckets (the buffers double), and searches run ``ops/ivf.
    ivf_flat_search`` with a filter pushed into the scan as a per-slot
    penalty;
  * ``to_artifact`` hands an immutable snapshot (``flat`` with ``row_ids``,
    or ``ivf_flat``) to ``models/factory.ANNSearcher``.

Ids are stable handles (int64 on the host, handed out in order and never
reused); the IVF index keeps them as int32 on the device and raises
``OverflowError`` at 2^31. The JAX package updates its arrays functionally
and pads query batches to powers of two to bound recompiles; here buffers
are preallocated and written in place, and batches go as they come. Every
top-k cut of the flat scan takes equal distances in ascending slot, so the
card and the host keep the same entries.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.models.base import IndexArtifact
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import ivf as ivfops
from vectordb_retrieval_tpu_torch.ops.kmeans import kmeans_assign, kmeans_fit
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device

_BIG = float("inf")
# rows per step of the flat scan: a larger index streams chunk by chunk
# with a running top-k (a [B, C] penalty needs the dense branch)
FLAT_CHUNK_ROWS = 131_072
_ALLOW_SENTINEL = np.iinfo(np.int32).max
_ID_LIMIT = 2**31 - 1
# key of an empty running-top-k entry: after every slot id
_NO_SLOT = (1 << 32) - 1


def _merge_cut(vals: torch.Tensor, slots: torch.Tensor, k: int):
    """The ``k`` smallest of ``vals [B, M]``, equal values in ascending
    slot (``slots`` int64, ``-1`` for empty entries, which sort last):
    ``(values, slots)``."""
    key = torch.where(slots >= 0, slots, _NO_SLOT)
    out, pos = dops.top_k_smallest_by_id(vals, key, k)
    return out, torch.gather(slots.expand_as(vals), 1, pos)


def _masked_search(
    queries: torch.Tensor,  # [B, d] f32
    vectors: torch.Tensor,  # [C, d] f32 (dead/unfilled rows zeroed)
    sqnorms: torch.Tensor,  # [C] f32
    pen: torch.Tensor,  # [C] or [B, C]: 0 = live, +inf = masked
    k: int,
    metric: str,
    chunk_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Penalty-masked exact scan with a running top-k (streamed above
    ``chunk_rows``, default ``FLAT_CHUNK_ROWS``): ``(dists [B, k'], slots
    [B, k'] int64)``, ``k' = min(k, C)``, slot ``-1`` where the distance
    is infinite."""
    chunk_rows = chunk_rows or FLAT_CHUNK_ROWS
    c = vectors.shape[0]
    b = queries.shape[0]
    kk = min(k, c)
    dev = vectors.device
    sq = sqnorms if metric == "l2" else None
    if c <= chunk_rows:
        dist = dops.pairwise_distances(queries, vectors, metric, sq)
        dist = dist + (pen if pen.dim() == 2 else pen[None, :])
        vals, slots = _merge_cut(dist, torch.arange(c, device=dev)[None, :], kk)
        return vals, torch.where(torch.isfinite(vals), slots, -1)
    if pen.dim() == 2:
        # per-query penalties are [B, C] by definition: only the dense
        # branch takes them (filter_ids folds into the 1-D penalty)
        raise ValueError(
            "per-query [B, C] penalties need the dense path "
            f"(C={c} > chunk_rows={chunk_rows})"
        )
    best_d = torch.full((b, kk), _BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((b, kk), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, c, chunk_rows):
        c1 = min(c0 + chunk_rows, c)
        dist = dops.pairwise_distances(
            queries, vectors[c0:c1], metric, None if sq is None else sq[c0:c1]
        ) + pen[None, c0:c1]
        ids = torch.arange(c0, c1, device=dev).expand(b, -1)
        best_d, best_i = _merge_cut(
            torch.cat([best_d, dist], dim=1), torch.cat([best_i, ids], dim=1), kk
        )
    return best_d, torch.where(torch.isfinite(best_d), best_i, -1)


def _allow_penalty(slot_ids: torch.Tensor, allow_sorted: torch.Tensor) -> torch.Tensor:
    """Per-slot filter penalty: 0 where the slot's stable id is in the
    sorted allow-list, +inf elsewhere (dead slots, id -1, always +inf).
    Membership is a device-side ``searchsorted`` (O(S log F))."""
    sid = slot_ids.long()
    allow = allow_sorted.long()
    pos = torch.searchsorted(allow, sid).clamp(0, allow.shape[0] - 1)
    hit = (allow[pos] == sid) & (sid >= 0)
    return torch.where(hit, 0.0, _BIG).to(torch.float32)


def _pad_allow_list(filter_ids) -> np.ndarray:
    """Sorted int32 allow-list padded to the next power of two with an
    unmatchable sentinel (stable ids are int32 by the serving contract)."""
    f = np.unique(np.asarray(filter_ids, dtype=np.int64).reshape(-1))
    if f.size and (f[-1] >= _ALLOW_SENTINEL or f[0] < -1):
        raise ValueError("filter ids must fit int32 (serving id contract)")
    n = max(1, int(f.size))
    p2 = 1
    while p2 < n:
        p2 *= 2
    out = np.full((p2,), _ALLOW_SENTINEL, dtype=np.int32)
    out[: f.size] = f.astype(np.int32)
    return out


def _pad_k(dists: np.ndarray, ids: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    if dists.shape[1] < k:
        w = k - dists.shape[1]
        dists = np.pad(dists, ((0, 0), (0, w)), constant_values=np.inf)
        ids = np.pad(ids, ((0, 0), (0, w)), constant_values=-1)
    return dists, ids


def _empty_result(b: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    return np.full((b, k), np.inf, np.float32), np.full((b, k), -1, np.int64)


def _expanded(buf: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``buf`` copied into the head of a new ``[rows, ...]`` buffer filled
    with ``fill``; the caller drops ``buf``, which frees it."""
    out = torch.full((rows,) + tuple(buf.shape[1:]), fill, dtype=buf.dtype, device=buf.device)
    out[: buf.shape[0]] = buf
    return out


class MutableFlatIndex:
    """Incrementally updatable exact index (add / delete / filter / search).

    The vectors live on ``device`` (``None``: the CUDA card, raising when
    there is none); ``add`` and ``delete`` are O(batch) in-place writes.
    Ids are stable across compaction.
    """

    def __init__(
        self,
        dimension: int,
        metric: str = "l2",
        capacity: int = 1024,
        compact_frac: float = 0.25,
        device: DeviceLike = None,
    ):
        if metric not in ("l2", "ip", "cosine"):
            raise ValueError(f"unsupported metric {metric!r}")
        self.device = resolve_device(device)
        self.dimension = int(dimension)
        self.metric = metric
        self.compact_frac = float(compact_frac)
        self._capacity = max(int(capacity), 8)
        self._vectors = torch.zeros((self._capacity, self.dimension), dtype=torch.float32,
                                    device=self.device)
        self._sqnorms = torch.zeros((self._capacity,), dtype=torch.float32, device=self.device)
        self._pen = torch.full((self._capacity,), _BIG, dtype=torch.float32, device=self.device)
        # slot -> stable id; -1 = never used or deleted
        self._slot_ids = np.full((self._capacity,), -1, dtype=np.int64)
        self._slot_ids_dev: Optional[torch.Tensor] = None  # filter mirror, made on demand
        self._id_to_slot: Dict[int, int] = {}
        self._next_id = 0
        self._n_slots = 0  # filled prefix length
        self._n_dead = 0

    # -- properties -----------------------------------------------------
    @property
    def n_active(self) -> int:
        return self._n_slots - self._n_dead

    @property
    def capacity(self) -> int:
        return self._capacity

    # -- mutation -------------------------------------------------------
    def _grow(self, need: int) -> None:
        new_cap = self._capacity
        while new_cap < need:
            new_cap *= 2
        self._vectors = _expanded(self._vectors, new_cap, 0.0)
        self._sqnorms = _expanded(self._sqnorms, new_cap, 0.0)
        self._pen = _expanded(self._pen, new_cap, _BIG)
        slot_ids = np.full((new_cap,), -1, dtype=np.int64)
        slot_ids[: self._capacity] = self._slot_ids
        self._slot_ids = slot_ids
        self._slot_ids_dev = None
        self._capacity = new_cap

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Append rows; returns their stable ids ``[m] int64``."""
        x = np.ascontiguousarray(vectors, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.dimension:
            raise ValueError(f"add expects [*, {self.dimension}], got {x.shape}")
        m = x.shape[0]
        if m == 0:
            return np.empty((0,), np.int64)
        if self._n_slots + m > self._capacity:
            self._grow(self._n_slots + m)
        xd = torch.as_tensor(x, device=self.device)
        if self.metric == "cosine":
            xd = dops.normalize(xd)
        start = self._n_slots
        self._vectors[start : start + m] = xd
        self._sqnorms[start : start + m] = torch.sum(xd * xd, dim=-1)
        self._pen[start : start + m] = 0.0
        ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
        self._slot_ids[start : start + m] = ids
        self._slot_ids_dev = None
        self._id_to_slot.update(zip(ids.tolist(), range(start, start + m)))
        self._next_id += m
        self._n_slots += m
        return ids

    def delete(self, ids) -> int:
        """Tombstone the given stable ids; returns how many were live."""
        table = self._id_to_slot
        slots = [table.pop(i) for i in np.atleast_1d(np.asarray(ids, dtype=np.int64)).tolist()
                 if i in table]
        if not slots:
            return 0
        slot_arr = np.asarray(slots, dtype=np.int64)
        st = torch.as_tensor(slot_arr, device=self.device)
        self._pen[st] = _BIG
        # zero dead rows so ip dots cannot resurface them via ties
        self._vectors[st] = 0.0
        self._sqnorms[st] = 0.0
        self._slot_ids[slot_arr] = -1
        self._slot_ids_dev = None
        self._n_dead += len(slots)
        if self._n_dead > max(64, self.compact_frac * max(self.n_active, 1)):
            self.compact()
        return len(slots)

    def compact(self) -> None:
        """Drop tombstones; shrink capacity to the live set (ids stable)."""
        live = np.nonzero(self._slot_ids[: self._n_slots] >= 0)[0]
        n = live.shape[0]
        new_cap = 8
        while new_cap < max(n, 1) * 2:
            new_cap *= 2
        g = torch.as_tensor(live, device=self.device)
        vecs, sqn = self._vectors[g], self._sqnorms[g]
        self._vectors = self._sqnorms = None  # free the old buffers first
        self._vectors = torch.zeros((new_cap, self.dimension), dtype=torch.float32,
                                    device=self.device)
        self._vectors[:n] = vecs
        self._sqnorms = torch.zeros((new_cap,), dtype=torch.float32, device=self.device)
        self._sqnorms[:n] = sqn
        self._pen = torch.full((new_cap,), _BIG, dtype=torch.float32, device=self.device)
        self._pen[:n] = 0.0
        slot_ids = np.full((new_cap,), -1, dtype=np.int64)
        slot_ids[:n] = self._slot_ids[live]
        self._slot_ids = slot_ids
        self._slot_ids_dev = None
        self._id_to_slot = dict(zip(slot_ids[:n].tolist(), range(n)))
        self._capacity = new_cap
        self._n_slots = n
        self._n_dead = 0

    def to_artifact(self) -> IndexArtifact:
        """Immutable ``flat`` snapshot servable by ``ANNSearcher``.

        Compacts first; the artifact carries ``row_ids`` so searches
        return the STABLE ids ``add`` handed out, not row positions. Its
        tensors are copies: later mutations do not reach it."""
        self.compact()
        n = self._n_slots
        if self._next_id > _ID_LIMIT:
            raise OverflowError("stable ids exceed int32 device range")
        data = {
            "vectors": self._vectors[:n].clone(),
            "sqnorms": self._sqnorms[:n].clone(),
            "row_ids": torch.as_tensor(self._slot_ids[:n].astype(np.int32), device=self.device),
        }
        meta = {
            "metric": self.metric,
            "dimension": self.dimension,
            "n_vectors": int(n),
            "normalize_queries": self.metric == "cosine",
            "mutable_snapshot": True,
        }
        return IndexArtifact("flat", data, meta)

    def save(self, path: str, context: Optional[dict] = None) -> None:
        """Persist mutable state (``models/persist``: atomic + manifest)."""
        from vectordb_retrieval_tpu_torch.models import persist

        n = self._n_slots
        art = IndexArtifact(
            "mutable_flat",
            {
                "vectors": self._vectors[:n],
                "sqnorms": self._sqnorms[:n],
                "pen": self._pen[:n],
                # a host int64 leaf: stable ids persist as int64
                "slot_ids": self._slot_ids[:n].copy(),
            },
            {
                "metric": self.metric,
                "dimension": self.dimension,
                "next_id": int(self._next_id),
                "compact_frac": self.compact_frac,
            },
        )
        persist.save_artifact(art, path, context or {})

    @classmethod
    def load(cls, path: str, context: Optional[dict] = None,
             device: DeviceLike = None) -> "MutableFlatIndex":
        """Restore a :meth:`save` snapshot onto ``device`` (host
        bookkeeping rebuilt)."""
        from vectordb_retrieval_tpu_torch.models import persist

        art = persist.load_artifact(path, context or {}, device="cpu")
        if art.kind != "mutable_flat":
            raise ValueError(f"expected mutable_flat artifact, got {art.kind!r}")
        meta = art.metadata
        slot_ids = art.data["slot_ids"].numpy().astype(np.int64)
        n = slot_ids.shape[0]
        self = cls(
            int(meta["dimension"]), metric=meta["metric"], capacity=max(n, 8),
            compact_frac=float(meta.get("compact_frac", 0.25)), device=device,
        )
        if n:
            self._vectors[:n] = art.data["vectors"].to(self.device)
            self._sqnorms[:n] = art.data["sqnorms"].to(self.device)
            self._pen[:n] = art.data["pen"].to(self.device)
        self._slot_ids[:n] = slot_ids
        live = np.nonzero(slot_ids >= 0)[0]
        self._id_to_slot = dict(zip(slot_ids[live].tolist(), live.tolist()))
        self._next_id = int(meta["next_id"])
        self._n_slots = n
        self._n_dead = int(n - live.shape[0])
        return self

    # -- search ---------------------------------------------------------
    def _slot_ids_device(self) -> torch.Tensor:
        """The slot -> stable id table on the device (uploaded once after
        each mutation, for filtered searches)."""
        if self._slot_ids_dev is None:
            self._slot_ids_dev = torch.as_tensor(self._slot_ids, device=self.device)
        return self._slot_ids_dev

    def device_search(self, qd: torch.Tensor, k: int, filter_ids=None):
        """Device queries in, device ``(dists, slots)`` out (no host copy);
        slots are buffer positions, ``-1`` where nothing was found."""
        metric = self.metric
        if metric == "cosine":
            qd = dops.normalize(qd)
            metric = "ip"
        pen = self._pen
        if filter_ids is not None:
            allow = torch.as_tensor(
                np.asarray(filter_ids, dtype=np.int64).reshape(-1), device=self.device)
            pen = pen + torch.where(torch.isin(self._slot_ids_device(), allow), 0.0, _BIG)
        return _masked_search(
            qd, self._vectors, self._sqnorms, pen, min(k, self._capacity), metric
        )

    def search(
        self, queries: np.ndarray, k: int, filter_ids: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k over the live set; returns ``(dists, stable_ids)``.

        ``filter_ids``: optional allow-list of stable ids; rows outside it
        are masked for this call only (query-time filtering).
        """
        q = np.ascontiguousarray(np.atleast_2d(queries), dtype=np.float32)
        if self.n_active == 0:
            return _empty_result(q.shape[0], k)
        dists, slots = self.device_search(torch.as_tensor(q, device=self.device), k, filter_ids)
        dists = dists.cpu().numpy()
        slots = slots.cpu().numpy()
        ids = np.where(slots >= 0, self._slot_ids[np.abs(slots)], -1)
        ids = np.where(np.isfinite(dists), ids, -1)
        dists = np.where(ids >= 0, dists, np.inf)
        return _pad_k(dists, ids, k)


def _groups(keys: np.ndarray):
    """``(key, positions)`` for each distinct key of ``keys``, positions in
    their original order."""
    order = np.argsort(keys, kind="stable")
    uniq, starts = np.unique(keys[order], return_index=True)
    bounds = np.append(starts, keys.shape[0])
    return [(int(u), order[bounds[i] : bounds[i + 1]]) for i, u in enumerate(uniq)]


class MutableIVFIndex:
    """Incrementally updatable IVF-Flat index (add / delete / search).

    The coarse quantizer is trained once on the initial corpus and frozen
    (centroid drift is a rebuild's job), while the bucketed inverted lists
    mutate in place:

      * every list owns >= 1 bucket row of length ``L`` in the padded
        device tensors; ``add`` assigns rows to their nearest centroid (K3)
        and places them in the list's free slots first, then its tail
        bucket, then fresh buckets (the buffers double when full);
      * ``delete`` tombstones slots (slot id -> -1, which the scan masks)
        and pushes them on their list's free stack.

    Searches call ``ops/ivf.ivf_flat_search`` as the immutable family does;
    ``nprobe`` may change per call.
    """

    def __init__(
        self,
        vectors: np.ndarray,
        nlist: int = 64,
        metric: str = "l2",
        nprobe: int = 8,
        bucket_len: int = 0,
        seed: int = 123,
        train_iters: int = 20,
        device: DeviceLike = None,
    ):
        if metric not in ("l2", "ip", "cosine"):
            raise ValueError(f"unsupported metric {metric!r}")
        self.device = resolve_device(device)
        x = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = x.shape
        self.dimension = d
        self.metric = metric
        self.nprobe = int(nprobe)
        xd = torch.as_tensor(x, device=self.device)
        if metric == "cosine":
            xd = dops.normalize(xd)
        self.nlist = min(int(nlist), max(n, 1))
        self.centroids, _ = kmeans_fit(xd, self.nlist, seed=seed, iters=train_iters)
        assign = kmeans_assign(xd, self.centroids).cpu().numpy()
        if not bucket_len:
            bucket_len = max(8, min(-(-n // self.nlist) * 2, 2048))
        # pad_multiple=8 (not the fused stream's 32) and bucket_multiple=1:
        # a small bucket_len would otherwise round up to 32, 4x the padded
        # slots
        slot_np, bucket_lists_np, _ = ivfops.build_bucketed_lists(
            assign, self.nlist, target_len=int(bucket_len), target_len_cap=0,
            bucket_multiple=1, pad_multiple=8,
        )
        # the PHYSICAL bucket width: growth rows must match it exactly
        self._L = int(slot_np.shape[1])
        self._nb = int(slot_np.shape[0])  # logical buckets (<= physical rows)
        self._slot_ids = torch.as_tensor(slot_np, device=self.device)  # int32
        live = (self._slot_ids >= 0)[:, :, None]
        self._list_vecs = xd[self._slot_ids.clamp(min=0).long()] * live
        self._list_sqn = torch.sum(self._list_vecs * self._list_vecs, dim=-1)
        del xd, live
        self._bucket_lists = np.asarray(bucket_lists_np, dtype=np.int32)
        self._coarse_dirty = False
        self._refresh_coarse()
        # host bookkeeping
        self._fill = (slot_np >= 0).sum(axis=1).astype(np.int64)  # per bucket
        self._list_buckets = self._bucket_map()
        self._id_loc = self._locations(slot_np, slot_np >= 0)  # stable id -> (bucket, slot)
        self._next_id = n
        # per-list free-slot stacks: deleted slots are reused by the next
        # add() to the same list before any bucket append
        self._list_free: Dict[int, List[Tuple[int, int]]] = {l: [] for l in range(self.nlist)}
        self._n_dead = 0
        self.compact_frac = 0.25

    # -- internals ------------------------------------------------------
    @property
    def n_active(self) -> int:
        return len(self._id_loc)

    def _bucket_map(self) -> Dict[int, list]:
        """list -> its buckets in ascending order (logical buckets only)."""
        out = {l: [] for l in range(self.nlist)}
        bl = self._bucket_lists[: self._nb]
        assigned = np.nonzero(bl >= 0)[0]
        for l, pos in _groups(bl[assigned]):
            out[l] = assigned[pos].tolist()
        return out

    @staticmethod
    def _locations(slot_np: np.ndarray, mask: np.ndarray) -> Dict[int, Tuple[int, int]]:
        """stable id -> (bucket, slot) of the slots in ``mask``."""
        b, s = np.nonzero(mask)
        return dict(zip(slot_np[b, s].tolist(), zip(b.tolist(), s.tolist())))

    def _refresh_coarse(self) -> None:
        """Coarse probe table over the PHYSICAL bucket rows: unused
        (pre-allocated) buckets get a far-away sentinel centroid so the
        coarse top-k never probes them."""
        self._coarse = ivfops.coarse_table(self.centroids, self._bucket_lists)

    def _new_bucket(self, list_id: int) -> int:
        """Claim a bucket row for ``list_id``; the physical buffers grow by
        DOUBLING (one copy per doubling, amortised O(1))."""
        physical = int(self._slot_ids.shape[0])
        if self._nb == physical:
            rows = 2 * physical
            self._slot_ids = _expanded(self._slot_ids, rows, -1)
            self._list_vecs = _expanded(self._list_vecs, rows, 0.0)
            self._list_sqn = _expanded(self._list_sqn, rows, 0.0)
            self._bucket_lists = np.concatenate(
                [self._bucket_lists, np.full(physical, -1, np.int32)])
            self._fill = np.concatenate([self._fill, np.zeros(physical, np.int64)])
        nb = self._nb
        self._bucket_lists[nb] = np.int32(list_id)
        self._coarse_dirty = True  # refreshed once per add() batch
        self._list_buckets[list_id].append(nb)
        self._nb += 1
        return nb

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Insert rows (assigned to their frozen nearest centroid);
        returns stable ids."""
        x = np.ascontiguousarray(vectors, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.dimension:
            raise ValueError(f"add expects [*, {self.dimension}], got {x.shape}")
        m = x.shape[0]
        if m == 0:
            return np.empty((0,), np.int64)
        xd = torch.as_tensor(x, device=self.device)
        if self.metric == "cosine":
            xd = dops.normalize(xd)
        assign = kmeans_assign(xd, self.centroids).cpu().numpy()
        if self._next_id + m > _ID_LIMIT:
            # slot ids live in the int32 device tensor; wrapping would
            # return ids that no longer match add()'s handles
            raise OverflowError(
                "MutableIVFIndex lifetime id space exhausted (2^31); "
                "rebuild/compact the index to reset ids"
            )
        ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
        self._next_id += m
        # placement by list: free slots (deleted-slot reuse, last freed
        # first) first, then the tail bucket's remaining slots, then fresh
        # buckets; O(distinct lists) Python
        rows_b, rows_s = np.empty(m, np.int64), np.empty(m, np.int64)
        for lst, idxs in _groups(assign):
            r = idxs.size
            free = self._list_free[lst]
            take = min(len(free), r)
            if take:
                reused = np.asarray(free[len(free) - take:][::-1], dtype=np.int64)
                del free[len(free) - take:]
                rows_b[idxs[:take]], rows_s[idxs[:take]] = reused[:, 0], reused[:, 1]
            # reused slots are live again: the dead count must drop, or
            # churn triggers spurious compactions
            self._n_dead = max(0, self._n_dead - take)
            pos = take
            while pos < r:
                bucket = self._list_buckets[lst][-1]
                if self._fill[bucket] >= self._L:
                    bucket = self._new_bucket(lst)
                nfill = min(int(self._L - self._fill[bucket]), r - pos)
                sel = idxs[pos : pos + nfill]
                rows_b[sel] = bucket
                rows_s[sel] = self._fill[bucket] + np.arange(nfill)
                self._fill[bucket] += nfill
                pos += nfill
        self._id_loc.update(zip(ids.tolist(), zip(rows_b.tolist(), rows_s.tolist())))
        if self._coarse_dirty:
            self._refresh_coarse()
            self._coarse_dirty = False
        bb = torch.as_tensor(rows_b, device=self.device)
        ss = torch.as_tensor(rows_s, device=self.device)
        self._slot_ids[bb, ss] = torch.as_tensor(ids.astype(np.int32), device=self.device)
        self._list_vecs[bb, ss] = xd
        self._list_sqn[bb, ss] = torch.sum(xd * xd, dim=-1)
        return ids

    def delete(self, ids) -> int:
        """Tombstone rows; slots go to their list's free stack for reuse."""
        table = self._id_loc
        locs = [table.pop(i) for i in np.atleast_1d(np.asarray(ids, dtype=np.int64)).tolist()
                if i in table]
        if not locs:
            return 0
        arr = np.asarray(locs, dtype=np.int64)
        bb = torch.as_tensor(arr[:, 0], device=self.device)
        ss = torch.as_tensor(arr[:, 1], device=self.device)
        self._slot_ids[bb, ss] = -1
        self._list_vecs[bb, ss] = 0.0
        self._list_sqn[bb, ss] = 0.0
        for lst, pos in _groups(self._bucket_lists[arr[:, 0]]):
            self._list_free[lst].extend(locs[i] for i in pos.tolist())
        self._n_dead += len(locs)
        # probe work scales with the bucket count, and churn strands
        # buckets that free-slot reuse alone cannot reclaim
        if self._n_dead > max(64, self.compact_frac * max(self.n_active, 1)):
            self.compact()
        return len(locs)

    def compact(self) -> None:
        """Rebuild the bucket layout tightly over the live rows.

        Rows keep their frozen list and their stable ids; each list's live
        rows, in bucket then slot order, are repacked densely into
        ``max(1, ceil(rows / L))`` buckets, lists in ascending order, and
        the physical buffers shrink to the logical bucket count. The rows
        move by one device gather and scatter; the layout is the JAX
        package's.
        """
        L = self._L
        seq = np.asarray(
            [b for l in range(self.nlist) for b in self._list_buckets[l]], dtype=np.int64)
        seq_list = self._bucket_lists[seq].astype(np.int64)
        live = (self._slot_ids[torch.as_tensor(seq, device=self.device)] >= 0).cpu().numpy()
        r, s = np.nonzero(live)  # live rows in list, bucket, slot order
        counts = np.bincount(seq_list[r], minlength=self.nlist)
        n_b = np.maximum(1, -(-counts // L))
        first_bucket = np.concatenate([[0], np.cumsum(n_b)[:-1]])
        first_row = np.concatenate([[0], np.cumsum(counts)[:-1]])
        lst = seq_list[r]
        rank = np.arange(r.shape[0]) - first_row[lst]
        nb = int(n_b.sum())
        to = torch.as_tensor(np.stack([first_bucket[lst] + rank // L, rank % L]),
                             device=self.device)
        frm = torch.as_tensor(np.stack([seq[r], s]), device=self.device)
        slot_ids = torch.full((nb, L), -1, dtype=torch.int32, device=self.device)
        list_vecs = torch.zeros((nb, L, self.dimension), dtype=torch.float32, device=self.device)
        list_sqn = torch.zeros((nb, L), dtype=torch.float32, device=self.device)
        slot_ids[to[0], to[1]] = self._slot_ids[frm[0], frm[1]]
        list_vecs[to[0], to[1]] = self._list_vecs[frm[0], frm[1]]
        list_sqn[to[0], to[1]] = self._list_sqn[frm[0], frm[1]]
        self._slot_ids, self._list_vecs, self._list_sqn = slot_ids, list_vecs, list_sqn
        self._nb = nb
        self._bucket_lists = np.repeat(np.arange(self.nlist, dtype=np.int32), n_b)
        self._refresh_coarse()
        self._fill = np.bincount(first_bucket[lst] + rank // L, minlength=nb).astype(np.int64)
        self._list_buckets = self._bucket_map()
        slot_np = slot_ids.cpu().numpy()
        self._id_loc = self._locations(slot_np, slot_np >= 0)
        self._list_free = {l: [] for l in range(self.nlist)}
        self._n_dead = 0

    def to_artifact(self) -> IndexArtifact:
        """Immutable ``ivf_flat`` snapshot servable by ``ANNSearcher``.

        Compacts first, so the artifact carries no tombstones; its slot ids
        are the STABLE ids, and its tensors are copies that later
        mutations do not reach.
        """
        self.compact()
        meta = {
            "metric": self.metric,
            "dimension": self.dimension,
            "n_vectors": int(self.n_active),
            "normalize_queries": self.metric == "cosine",
            "index_key": f"IVF{self.nlist},Flat",
            "nprobe": self.nprobe,
            "nlist": int(self.nlist),
            "n_buckets": int(self._nb),
            "max_list_len": int(self._L),
            "probe_cum": [int(v) for v in ivfops.probe_budget_cum(self._bucket_lists, self.nlist)],
            "mutable_snapshot": True,
        }
        data = {
            # dead (unassigned) buckets get sentinel rows, not centroids[-1]
            "centroids": ivfops.coarse_table(self.centroids, self._bucket_lists),
            "bucket_lists": torch.as_tensor(self._bucket_lists, device=self.device),
            "slot_ids": self._slot_ids.clone(),
            "list_vecs": self._list_vecs.clone(),
            "list_sqnorms": self._list_sqn.clone(),
        }
        return IndexArtifact("ivf_flat", data, meta)

    def save(self, path: str, context: Optional[dict] = None) -> None:
        """Persist mutable state (``models/persist``: atomic + manifest)."""
        from vectordb_retrieval_tpu_torch.models import persist

        nb = self._nb
        art = IndexArtifact(
            "mutable_ivf",
            {
                "centroids": self.centroids,
                "slot_ids": self._slot_ids[:nb],
                "list_vecs": self._list_vecs[:nb],
                "list_sqnorms": self._list_sqn[:nb],
                "bucket_lists": torch.as_tensor(self._bucket_lists[:nb]),
            },
            {
                "metric": self.metric,
                "dimension": self.dimension,
                "nlist": int(self.nlist),
                "nprobe": int(self.nprobe),
                "bucket_len": int(self._L),
                "next_id": int(self._next_id),
            },
        )
        persist.save_artifact(art, path, context or {})

    @classmethod
    def load(cls, path: str, context: Optional[dict] = None,
             device: DeviceLike = None) -> "MutableIVFIndex":
        """Restore a :meth:`save` snapshot onto ``device`` (host
        bookkeeping rebuilt)."""
        from vectordb_retrieval_tpu_torch.models import persist

        art = persist.load_artifact(path, context or {}, device=device)
        if art.kind != "mutable_ivf":
            raise ValueError(f"expected mutable_ivf artifact, got {art.kind!r}")
        meta = art.metadata
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.dimension = int(meta["dimension"])
        self.metric = meta["metric"]
        self.nprobe = int(meta["nprobe"])
        self.nlist = int(meta["nlist"])
        self._L = int(meta["bucket_len"])
        self.centroids = art.data["centroids"].float()
        self._slot_ids = art.data["slot_ids"].to(torch.int32)
        self._list_vecs = art.data["list_vecs"].float()
        self._list_sqn = art.data["list_sqnorms"].float()
        slot_np = self._slot_ids.cpu().numpy()
        self._nb = slot_np.shape[0]
        self._bucket_lists = art.data["bucket_lists"].cpu().numpy().astype(np.int32)
        self._coarse_dirty = False
        self._refresh_coarse()
        # fill = the append WATERMARK (max occupied slot + 1), not the live
        # count: a snapshot can hold interior tombstones, and a live-count
        # fill would point the next add() at an occupied top slot,
        # overwriting a live row. Interior tombstones go to the free lists,
        # so reuse and the compaction trigger see them.
        occ = slot_np >= 0
        has = occ.any(axis=1)
        last = np.where(has, self._L - 1 - np.argmax(occ[:, ::-1], axis=1), -1)
        self._fill = (last + 1).astype(np.int64)
        self._list_buckets = self._bucket_map()
        below = np.arange(self._L)[None, :] < self._fill[:, None]
        self._id_loc = self._locations(slot_np, occ & below)
        self._list_free = {l: [] for l in range(self.nlist)}
        db, ds = np.nonzero(below & ~occ)
        for lst, pos in _groups(self._bucket_lists[db]):
            self._list_free[lst].extend(zip(db[pos].tolist(), ds[pos].tolist()))
        self._n_dead = int(db.shape[0])
        self._next_id = int(meta["next_id"])
        self.compact_frac = 0.25
        return self

    # -- search ---------------------------------------------------------
    def probe_budget(self, nprobe: Optional[int] = None) -> int:
        """Buckets probed per query: the sum of the ``nprobe`` LARGEST
        lists' bucket counts (every bucket of the nearest lists is covered
        under any skew; slack probes spill to the next-nearest lists, a
        recall superset of "exactly nprobe lists"), quantised UP to a power
        of two and capped by the physical bucket rows, as in the JAX
        package (where the quantisation bounds recompiles)."""
        npb = nprobe if nprobe is not None else self.nprobe
        physical = int(self._slot_ids.shape[0])
        lens = sorted((len(b) for b in self._list_buckets.values()), reverse=True)
        eff = min(max(1, sum(lens[:npb])), physical)
        q2 = 1
        while q2 < eff:
            q2 *= 2
        return min(q2, physical)

    def route(self, n_queries: int, nprobe: Optional[int] = None) -> str:
        """The regime ``ops/ivf.ivf_flat_search`` takes for a batch:
        ``fused`` (one K1 f32 launch over the whole payload), ``masked``
        (the masked stream, ``torch.matmul``) or ``probe_scan``."""
        physical, L = self._slot_ids.shape
        if not ivfops._use_stream(n_queries, self.probe_budget(nprobe), int(physical)):
            return "probe_scan"
        return "fused" if ivfops._use_fused(int(physical), int(L)) else "masked"

    def device_search(self, qd: torch.Tensor, k: int, nprobe: Optional[int] = None,
                      filter_ids=None):
        """Device queries in, device ``(dists, stable ids)`` out (no host
        copy)."""
        metric = self.metric
        if metric == "cosine":
            qd = dops.normalize(qd)
            metric = "ip"
        slot_pen = None
        if filter_ids is not None:
            slot_pen = _allow_penalty(
                self._slot_ids,
                torch.as_tensor(_pad_allow_list(filter_ids), device=self.device),
            )
        return ivfops.ivf_flat_search(
            qd, self._coarse, self._slot_ids, self._list_vecs, self._list_sqn,
            min(k, int(self._slot_ids.shape[0]) * self._L), self.probe_budget(nprobe),
            metric=metric, slot_pen=slot_pen,
        )

    def search(
        self,
        queries: np.ndarray,
        k: int,
        nprobe: Optional[int] = None,
        filter_ids: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Probe-scan search; ``filter_ids`` (allow-list of stable ids)
        pushes the predicate INTO the scan as a per-slot +inf penalty
        (``ivf_flat_search``'s ``slot_pen``), so filtered rows never take
        candidate slots: full recall over the allowed set."""
        q = np.ascontiguousarray(np.atleast_2d(queries), dtype=np.float32)
        if self.n_active == 0:
            return _empty_result(q.shape[0], k)
        dists, ids = self.device_search(
            torch.as_tensor(q, device=self.device), k, nprobe, filter_ids)
        dists = dists.cpu().numpy()
        ids = ids.cpu().numpy().astype(np.int64)
        ids = np.where(np.isfinite(dists), ids, -1)
        return _pad_k(dists, ids, k)
