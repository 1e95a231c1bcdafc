"""Replication-aware sharded mutable serving.

Counterpart of ``vectordb_retrieval_tpu/parallel/serving.py``: the
serving layer's mutable exact and IVF indexes (``serving.py``) with their
corpus ROW-SHARDED over the mesh's ``db`` axis and, on a 2-D ``(replica,
db)`` mesh, replicated over ``replica``:

  * state lives in ``parallel/mesh.ShardedTensor`` buffers (one segment of
    rows or buckets per shard); every write of ``add`` / ``delete`` /
    ``compact`` reaches each distinct copy of its shard, and replicas that
    share a device share one tensor;
  * searches run per shard with the serving layer's tombstone / filter
    penalty folded into the local scan and merge by
    ``parallel/sharded_ivf.gather_merge``; ``q_axis="replica"`` splits the
    query batch over the replica rings;
  * growth doubles every shard's segment in place (the old buffer is
    freed), compaction repacks each shard locally: rows never cross shards
    and stable ids never change.

The host bookkeeping is the JAX package's, step for step (placement plan,
per-shard fill, bucket claims, free-slot stacks, compaction), so the same
mutations leave the same layouts in either package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.models.base import IndexArtifact
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import ivf as ivfops
from vectordb_retrieval_tpu_torch.ops.kmeans import kmeans_assign, kmeans_fit
from vectordb_retrieval_tpu_torch.parallel.mesh import Mesh, ShardedTensor
from vectordb_retrieval_tpu_torch.parallel.sharded_ivf import fan_out
from vectordb_retrieval_tpu_torch.serving import (
    _ID_LIMIT,
    _allow_penalty,
    _empty_result,
    _expanded,
    _masked_search,
    _pad_allow_list,
    _pad_k,
)

_BIG = float("inf")


def _write(st: ShardedTensor, seg: int, rows: np.ndarray, values, cols: Optional[np.ndarray] = None):
    """Write ``values`` (a scalar or a tensor with one entry per row) at the
    global ``rows`` (and ``cols``) of a row-sharded buffer whose shards are
    segments of ``seg`` rows, in every copy of each shard."""
    shard = rows // seg
    for s in np.unique(shard).tolist():
        sel = np.nonzero(shard == s)[0]
        local = rows[sel] - s * seg
        for t in st.copies(s):
            idx = (torch.as_tensor(local, device=t.device),)
            if cols is not None:
                idx += (torch.as_tensor(cols[sel], device=t.device),)
            if isinstance(values, torch.Tensor):
                t[idx] = values[torch.as_tensor(sel, device=values.device)].to(t.device)
            else:
                t[idx] = values


def _on_devices(t: Optional[torch.Tensor], mesh: Mesh) -> Dict[torch.device, torch.Tensor]:
    """``t`` copied once to each distinct device of ``mesh`` (before a
    search's per-shard loop, which must not wait on a host copy)."""
    if t is None:
        return {}
    return {dev: t.to(dev) for dev in set(mesh.devices.reshape(-1).tolist())}


def _live_locations(slot_host: np.ndarray) -> Dict[int, Tuple[int, int]]:
    """stable id -> (bucket, slot) of every live slot."""
    g, s = np.nonzero(slot_host >= 0)
    return dict(zip(slot_host[g, s].tolist(), zip(g.tolist(), s.tolist())))


class ShardedMutableFlat:
    """Mutable exact serving index sharded over ``db`` (replicated over any
    other mesh axis); the ``serving.MutableFlatIndex`` contract: stable
    int64 ids, tombstone deletes, query-time ``filter_ids``, compaction,
    an immutable snapshot."""

    def __init__(
        self,
        dimension: int,
        mesh: Mesh,
        metric: str = "l2",
        capacity_per_shard: int = 1024,
        db_axis: str = "db",
        q_axis: Optional[str] = None,
        compact_frac: float = 0.25,
    ):
        if metric not in ("l2", "ip", "cosine"):
            raise ValueError(f"unsupported metric {metric!r}")
        self.dimension = int(dimension)
        self.metric = metric
        self.mesh = mesh
        self.device = mesh.first_device
        self.db_axis = db_axis
        self.q_axis = q_axis
        self.compact_frac = float(compact_frac)
        self.n_shards = int(mesh.shape[db_axis])
        self._cap_local = max(int(capacity_per_shard), 8)
        c = self._cap_local * self.n_shards

        def rows(shape, fill):
            return ShardedTensor.place(torch.full(shape, fill, dtype=torch.float32), mesh,
                                       db_axis, stacked=False)

        self._vectors = rows((c, self.dimension), 0.0)
        self._sqnorms = rows((c,), 0.0)
        self._pen = rows((c,), _BIG)
        self._slot_ids = np.full((c,), -1, dtype=np.int64)
        self._slot_dev: Optional[ShardedTensor] = None  # filter mirror, made on demand
        self._id_to_slot: Dict[int, int] = {}
        self._next_id = 0
        self._fill = np.zeros((self.n_shards,), np.int64)  # per-shard prefix
        self._dead = 0

    # -- properties -----------------------------------------------------
    @property
    def n_active(self) -> int:
        return int(self._fill.sum()) - self._dead

    @property
    def capacity(self) -> int:
        return self._cap_local * self.n_shards

    def shard_fill(self) -> np.ndarray:
        """Filled prefix per shard (tombstones included)."""
        return self._fill.copy()

    # -- mutation -------------------------------------------------------
    def _grow(self, need_local: int) -> None:
        new_local = self._cap_local
        while new_local < need_local:
            new_local *= 2
        self._vectors = self._vectors.apply(lambda s, t: _expanded(t, new_local, 0.0))
        self._sqnorms = self._sqnorms.apply(lambda s, t: _expanded(t, new_local, 0.0))
        self._pen = self._pen.apply(lambda s, t: _expanded(t, new_local, _BIG))
        old_local, d0 = self._cap_local, self.n_shards
        slot_ids = np.full((new_local * d0,), -1, dtype=np.int64)
        for s in range(d0):
            slot_ids[s * new_local : s * new_local + old_local] = (
                self._slot_ids[s * old_local : (s + 1) * old_local])
        self._slot_ids = slot_ids
        self._slot_dev = None
        # global slot numbering moved: rebuild the id map
        live = np.nonzero(slot_ids >= 0)[0]
        self._id_to_slot = dict(zip(slot_ids[live].tolist(), live.tolist()))
        self._cap_local = new_local

    def _place_plan(self, m: int) -> np.ndarray:
        """Shard of each of ``m`` new rows: emptiest shards first
        (deterministic water-filling on the filled-prefix counts)."""
        fill = self._fill.copy()
        out = np.empty((m,), np.int64)
        i = 0
        while i < m:
            order = np.argsort(fill, kind="stable")
            s = order[0]
            level = fill[order[1]] if self.n_shards > 1 else fill[s] + (m - i)
            take = int(min(m - i, max(level - fill[s], 1)))
            out[i : i + take] = s
            fill[s] += take
            i += take
        return out

    def add(self, vectors: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(vectors, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.dimension:
            raise ValueError(f"add expects [*, {self.dimension}], got {x.shape}")
        m = x.shape[0]
        if m == 0:
            return np.empty((0,), np.int64)
        if self._next_id + m > _ID_LIMIT:
            raise OverflowError("stable ids exceed int32 device range")
        plan = self._place_plan(m)
        counts = np.bincount(plan, minlength=self.n_shards)
        if (self._fill + counts).max() > self._cap_local:
            self._grow(int((self._fill + counts).max()))
        slots = np.empty((m,), np.int64)  # per-shard contiguous runs
        for s in range(self.n_shards):
            rows = np.nonzero(plan == s)[0]
            slots[rows] = s * self._cap_local + self._fill[s] + np.arange(rows.size)
            self._fill[s] += rows.size
        xd = torch.as_tensor(x, device=self.device)
        if self.metric == "cosine":
            xd = dops.normalize(xd)
        _write(self._vectors, self._cap_local, slots, xd)
        _write(self._sqnorms, self._cap_local, slots, torch.sum(xd * xd, dim=-1))
        _write(self._pen, self._cap_local, slots, 0.0)
        ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
        self._slot_ids[slots] = ids
        self._slot_dev = None
        self._id_to_slot.update(zip(ids.tolist(), slots.tolist()))
        self._next_id += m
        return ids

    def delete(self, ids) -> int:
        table = self._id_to_slot
        slots = [table.pop(i) for i in np.atleast_1d(np.asarray(ids, dtype=np.int64)).tolist()
                 if i in table]
        if not slots:
            return 0
        arr = np.asarray(slots, dtype=np.int64)
        _write(self._pen, self._cap_local, arr, _BIG)
        _write(self._vectors, self._cap_local, arr, 0.0)
        _write(self._sqnorms, self._cap_local, arr, 0.0)
        self._slot_ids[arr] = -1
        self._slot_dev = None
        self._dead += len(slots)
        if self._dead > max(64, self.compact_frac * max(self.n_active, 1)):
            self.compact()
        return len(slots)

    def compact(self) -> None:
        """Per-shard local repack: live rows to each segment's head, ids
        stable, rows never cross shards; capacity is kept."""
        cap, d0 = self._cap_local, self.n_shards
        gather = np.zeros((d0 * cap,), np.int64)  # LOCAL gather indices
        new_slot_ids = np.full((d0 * cap,), -1, dtype=np.int64)
        pen = np.full((d0 * cap,), np.inf, np.float32)
        for s in range(d0):
            seg = self._slot_ids[s * cap : s * cap + self._fill[s]]
            live = np.nonzero(seg >= 0)[0]
            gather[s * cap : s * cap + live.size] = live
            new_slot_ids[s * cap : s * cap + live.size] = seg[live]
            pen[s * cap : s * cap + live.size] = 0.0
            self._fill[s] = live.size

        def repack(s, t):
            return t[torch.as_tensor(gather[s * cap : (s + 1) * cap], device=t.device)]

        self._vectors = self._vectors.apply(repack)
        self._sqnorms = self._sqnorms.apply(repack)
        self._pen = self._pen.apply(
            lambda s, t: torch.as_tensor(pen[s * cap : (s + 1) * cap], device=t.device))
        self._slot_ids = new_slot_ids
        self._slot_dev = None
        live = np.nonzero(new_slot_ids >= 0)[0]
        self._id_to_slot = dict(zip(new_slot_ids[live].tolist(), live.tolist()))
        self._dead = 0

    # -- search ---------------------------------------------------------
    def device_search(self, qd: torch.Tensor, k: int, filter_ids=None):
        """Device queries in, device ``(dists, global slots)`` out (no host
        copy); slot ``-1`` where nothing was found."""
        metric = self.metric
        if metric == "cosine":
            qd = dops.normalize(qd)
            metric = "ip"
        allow = None
        if filter_ids is not None:
            if self._slot_dev is None:
                self._slot_dev = ShardedTensor.place(
                    torch.as_tensor(self._slot_ids), self.mesh, self.db_axis, stacked=False)
            allow = torch.as_tensor(np.asarray(filter_ids, dtype=np.int64).reshape(-1))
        allow_on = _on_devices(allow, self.mesh)
        cap = self._cap_local
        kk = min(k, cap)

        def local(q, c):
            pen = self._pen.shard(c)
            if allow is not None:
                hit = torch.isin(self._slot_dev.shard(c), allow_on[pen.device])
                pen = pen + torch.where(hit, 0.0, _BIG)
            d, slots = _masked_search(q, self._vectors.shard(c), self._sqnorms.shard(c), pen, kk,
                                      metric)
            base = self.mesh.shard_index(c, self.db_axis) * cap
            return d, torch.where(slots >= 0, slots + base, -1)

        d, slots = fan_out(qd, self.mesh, self.db_axis, self.q_axis, local,
                           min(k, self.n_shards * kk))
        return d, torch.where(torch.isfinite(d), slots, -1)

    def search(
        self, queries: np.ndarray, k: int, filter_ids: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k over the live set: ``(dists, stable_ids)``."""
        q = np.ascontiguousarray(np.atleast_2d(queries), dtype=np.float32)
        if self.n_active == 0:
            return _empty_result(q.shape[0], k)
        dists, slots = self.device_search(torch.as_tensor(q, device=self.device), k, filter_ids)
        dists, slots = dists.cpu().numpy(), slots.cpu().numpy()
        ids = np.where(slots >= 0, self._slot_ids[np.abs(slots)], -1)
        ids = np.where(np.isfinite(dists), ids, -1)
        dists = np.where(ids >= 0, dists, np.inf)
        return _pad_k(dists, ids, k)

    # -- snapshot -------------------------------------------------------
    def to_artifact(self) -> IndexArtifact:
        """Immutable ``flat`` snapshot (host-gathered) servable by
        ``ANNSearcher``, with ``row_ids`` mapping rows to stable ids."""
        self.compact()
        live = np.nonzero(self._slot_ids >= 0)[0]
        vecs = np.asarray(self._vectors)[live]
        dev = self.device
        return IndexArtifact(
            "flat",
            {
                "vectors": torch.as_tensor(vecs, device=dev),
                "sqnorms": torch.as_tensor((vecs * vecs).sum(-1), device=dev),
                "row_ids": torch.as_tensor(self._slot_ids[live].astype(np.int32), device=dev),
            },
            {
                "metric": self.metric,
                "dimension": self.dimension,
                "n_vectors": int(live.size),
                "normalize_queries": self.metric == "cosine",
                "mutable_snapshot": True,
                "source": "ShardedMutableFlat",
            },
        )


class ShardedMutableIVF:
    """Mutable IVF-Flat serving index sharded over ``db`` (replicated over
    any other mesh axis): the ``serving.MutableIVFIndex`` contract scaled
    out.

      * ONE coarse quantizer, trained on the initial corpus and frozen, on
        the mesh's first device: ``add`` routing is the same for every shard;
      * BUCKETS are the sharding unit: each shard owns an equal segment of
        fixed-length bucket rows, and a list's buckets may live on several
        shards, so hot lists spread;
      * ``add`` fills a list's free slots first, then claims a bucket on
        the least-loaded shard; when every segment is full, each doubles;
      * ``delete`` tombstones the slot (stable id -> -1);
      * ``search`` runs ``ops/ivf.ivf_flat_search`` per shard (its
        ``nprobe`` nearest LOCAL buckets) and merges; slot tables hold
        stable ids, so merged ids need no translation.
    """

    def __init__(
        self,
        vectors: np.ndarray,
        mesh: Mesh,
        nlist: int = 64,
        metric: str = "l2",
        nprobe: int = 8,
        bucket_len: int = 0,
        seed: int = 123,
        train_iters: int = 20,
        db_axis: str = "db",
        q_axis: Optional[str] = None,
        compact_frac: float = 0.25,
    ):
        if metric not in ("l2", "ip", "cosine"):
            raise ValueError(f"unsupported metric {metric!r}")
        x = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = x.shape
        self.dimension = d
        self.metric = metric
        self.nprobe = int(nprobe)
        self.mesh = mesh
        self.device = mesh.first_device
        self.db_axis = db_axis
        self.q_axis = q_axis
        self.compact_frac = float(compact_frac)
        self.n_shards = int(mesh.shape[db_axis])
        xd = torch.as_tensor(x, device=self.device)
        if metric == "cosine":
            xd = dops.normalize(xd)
        self.nlist = min(int(nlist), max(n, 1))
        self.centroids, _ = kmeans_fit(xd, self.nlist, seed=seed, iters=train_iters)
        self._cent_np = self.centroids.cpu().numpy()
        assign = kmeans_assign(xd, self.centroids).cpu().numpy()
        if not bucket_len:
            bucket_len = max(8, min(-(-n // self.nlist) * 2, 2048))
        # pad_multiple=8, bucket_multiple=1: the JAX package's mutable layout
        slot_np, bucket_lists_np, _ = ivfops.build_bucketed_lists(
            assign, self.nlist, target_len=int(bucket_len), target_len_cap=0,
            bucket_multiple=1, pad_multiple=8,
        )
        self._L = int(slot_np.shape[1])
        nb_used = slot_np.shape[0]
        # uniform per-shard segments: round the physical bucket count up
        self._capB_local = max(-(-nb_used // self.n_shards), 1)
        nb_phys = self._capB_local * self.n_shards
        # round-robin the built buckets over the shard segments
        j = np.arange(nb_used)
        g = (j % self.n_shards) * self._capB_local + j // self.n_shards
        bl = np.full((nb_phys,), -1, np.int32)
        sl = np.full((nb_phys, self._L), -1, np.int64)
        bl[g] = bucket_lists_np
        sl[g] = slot_np
        live = sl >= 0
        slots_t = torch.as_tensor(sl, device=self.device)
        vec = torch.where((slots_t >= 0)[:, :, None], xd[slots_t.clamp(min=0)], 0.0)
        del xd
        self._bucket_lists = bl
        self._slot_host = sl  # stable ids mirror (host)
        place = lambda a: ShardedTensor.place(a, mesh, db_axis, stacked=False)  # noqa: E731
        self._slot_ids = place(slots_t.to(torch.int32))
        self._list_vecs = place(vec)
        self._list_sqn = place(torch.sum(vec * vec, dim=-1))
        del vec, slots_t
        self._refresh_coarse()
        self._fill = live.sum(axis=1).astype(np.int64)  # per bucket
        self._list_buckets = {l: [int(b) for b in np.nonzero(bl == l)[0]] for l in range(self.nlist)}
        self._id_loc = _live_locations(sl)
        self._next_id = n
        self._list_free: Dict[int, List[Tuple[int, int]]] = {l: [] for l in range(self.nlist)}
        self._n_dead = 0

    # -- internals ------------------------------------------------------
    @property
    def n_active(self) -> int:
        return len(self._id_loc)

    @property
    def n_buckets(self) -> int:
        return int(self._capB_local * self.n_shards)

    def _refresh_coarse(self) -> None:
        safe = np.where(self._bucket_lists >= 0, self._bucket_lists, 0)
        coarse = self._cent_np[safe]
        coarse[self._bucket_lists < 0] = 1e9
        self._coarse = ShardedTensor.place(coarse, self.mesh, self.db_axis, stacked=False)

    def _shard_free_buckets(self) -> np.ndarray:
        used = (self._bucket_lists >= 0).reshape(self.n_shards, self._capB_local)
        return self._capB_local - used.sum(axis=1)

    def _grow(self) -> None:
        """Double every shard's bucket segment in place."""
        old, d0 = self._capB_local, self.n_shards
        new = old * 2
        self._list_vecs = self._list_vecs.apply(lambda s, t: _expanded(t, new, 0.0))
        self._list_sqn = self._list_sqn.apply(lambda s, t: _expanded(t, new, 0.0))
        self._slot_ids = self._slot_ids.apply(lambda s, t: _expanded(t, new, -1))

        def expand(a, fill, shape):
            out = np.full(shape, fill, a.dtype)
            for s in range(d0):
                out[s * new : s * new + old] = a[s * old : (s + 1) * old]
            return out

        self._bucket_lists = expand(self._bucket_lists, -1, (new * d0,))
        self._slot_host = expand(self._slot_host, -1, (new * d0, self._L))
        self._fill = expand(self._fill, 0, (new * d0,))

        # global bucket numbering moved (g = s*old + r -> s*new + r): remap
        # the free-slot stacks and rebuild the host maps
        def remap(g: int) -> int:
            s, r = divmod(g, old)
            return s * new + r

        self._list_free = {l: [(remap(g), s_idx) for g, s_idx in stack]
                           for l, stack in self._list_free.items()}
        self._list_buckets = {l: [int(g) for g in np.nonzero(self._bucket_lists == l)[0]]
                              for l in range(self.nlist)}
        self._id_loc = _live_locations(self._slot_host)
        self._capB_local = new
        self._refresh_coarse()

    def _claim_bucket(self, list_id: int) -> int:
        free = self._shard_free_buckets()
        if free.max() == 0:
            self._grow()
            free = self._shard_free_buckets()
        s = int(np.argmax(free))
        seg = self._bucket_lists[s * self._capB_local : (s + 1) * self._capB_local]
        g = s * self._capB_local + int(np.nonzero(seg < 0)[0][0])
        self._bucket_lists[g] = np.int32(list_id)
        self._list_buckets[list_id].append(g)
        return g

    def _take_slot(self, list_id: int) -> Tuple[int, int]:
        if self._list_free[list_id]:
            return self._list_free[list_id].pop()
        for g in self._list_buckets[list_id]:
            if self._fill[g] < self._L:
                s_idx = int(self._fill[g])
                self._fill[g] += 1
                return (g, s_idx)
        g = self._claim_bucket(list_id)
        self._fill[g] = 1
        return (g, 0)

    # -- mutation -------------------------------------------------------
    def add(self, vectors: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(vectors, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.dimension:
            raise ValueError(f"add expects [*, {self.dimension}], got {x.shape}")
        m = x.shape[0]
        if m == 0:
            return np.empty((0,), np.int64)
        if self._next_id + m > _ID_LIMIT:
            raise OverflowError("stable ids exceed int32 device range")
        xd = torch.as_tensor(x, device=self.device)
        if self.metric == "cosine":
            xd = dops.normalize(xd)
        assign = kmeans_assign(xd, self.centroids).cpu().numpy()
        # size capacity BEFORE taking any slot: a _grow inside the loop
        # would renumber the global buckets of slots already taken
        counts = np.bincount(assign, minlength=self.nlist)
        need = 0
        for l in np.nonzero(counts)[0].tolist():
            avail = len(self._list_free[l]) + sum(
                self._L - int(self._fill[g]) for g in self._list_buckets[l])
            deficit = int(counts[l]) - avail
            if deficit > 0:
                need += -(-deficit // self._L)
        while need > int(self._shard_free_buckets().sum()):
            self._grow()
        locs = np.asarray([self._take_slot(int(l)) for l in assign.tolist()], np.int64)
        g_idx, s_idx = locs[:, 0], locs[:, 1]
        ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
        cap = self._capB_local
        _write(self._slot_ids, cap, g_idx,
               torch.as_tensor(ids.astype(np.int32), device=self.device), s_idx)
        _write(self._list_vecs, cap, g_idx, xd, s_idx)
        _write(self._list_sqn, cap, g_idx, torch.sum(xd * xd, dim=-1), s_idx)
        self._slot_host[g_idx, s_idx] = ids
        self._id_loc.update(zip(ids.tolist(), zip(g_idx.tolist(), s_idx.tolist())))
        self._next_id += m
        self._refresh_coarse()  # newly claimed buckets need live centroids
        return ids

    def delete(self, ids) -> int:
        table = self._id_loc
        locs = [table.pop(i) for i in np.atleast_1d(np.asarray(ids, dtype=np.int64)).tolist()
                if i in table]
        if not locs:
            return 0
        arr = np.asarray(locs, dtype=np.int64)
        g_idx, s_idx = arr[:, 0], arr[:, 1]
        cap = self._capB_local
        _write(self._slot_ids, cap, g_idx, -1, s_idx)
        _write(self._list_vecs, cap, g_idx, 0.0, s_idx)
        _write(self._list_sqn, cap, g_idx, 0.0, s_idx)
        self._slot_host[g_idx, s_idx] = -1
        for g, s in locs:
            self._list_free[int(self._bucket_lists[g])].append((int(g), int(s)))
        self._n_dead += len(locs)
        if self._n_dead > max(64, self.compact_frac * max(self.n_active, 1)):
            self.compact()
        return len(locs)

    def compact(self) -> None:
        """Repack every bucket's live slots to its head (a per-bucket
        permutation: rows never cross buckets or shards) and release
        all-dead buckets of lists that keep another."""
        nb, L = self._slot_host.shape
        live = self._slot_host >= 0
        # live slots first, then the dead, each in slot order
        perm = np.argsort(~live, axis=1, kind="stable")
        self._slot_host = np.take_along_axis(self._slot_host, perm, axis=1)
        self._fill = live.sum(axis=1).astype(np.int64)
        for g in np.nonzero(self._fill == 0)[0].tolist():
            lid = int(self._bucket_lists[g])
            if lid >= 0 and len(self._list_buckets[lid]) > 1:
                self._list_buckets[lid].remove(g)
                self._bucket_lists[g] = -1
        cap = self._capB_local

        def repack(s, t):
            p = torch.as_tensor(perm[s * cap : (s + 1) * cap], device=t.device)
            return torch.take_along_dim(t, p if t.dim() == 2 else p[:, :, None], dim=1)

        self._slot_ids = self._slot_ids.apply(repack)
        self._list_sqn = self._list_sqn.apply(repack)
        self._list_vecs = self._list_vecs.apply(repack)
        self._id_loc = _live_locations(self._slot_host)
        self._list_free = {l: [] for l in range(self.nlist)}
        self._n_dead = 0
        self._refresh_coarse()

    # -- search ---------------------------------------------------------
    def route(self, n_queries: int, nprobe: int = 0) -> str:
        """The regime each shard's ``ivf_flat_search`` takes for a batch."""
        return ivfops.ivf_route(n_queries, int(nprobe or self.nprobe), self._capB_local, self._L)

    def device_search(self, qd: torch.Tensor, k: int, nprobe: int = 0, filter_ids=None):
        """Device queries in, device ``(dists, stable ids)`` out."""
        metric = self.metric
        if metric == "cosine":
            qd = dops.normalize(qd)
            metric = "ip"
        allow = None
        if filter_ids is not None:
            allow = torch.as_tensor(_pad_allow_list(filter_ids))
        allow_on = _on_devices(allow, self.mesh)
        nb_local = self._capB_local
        kk = min(k, nb_local * self._L)
        npb = min(int(nprobe or self.nprobe), nb_local)

        def local(q, c):
            slots = self._slot_ids.shard(c)
            pen = None if allow is None else _allow_penalty(slots, allow_on[slots.device])
            return ivfops.ivf_flat_search(
                q, self._coarse.shard(c), slots, self._list_vecs.shard(c),
                self._list_sqn.shard(c), kk, npb, metric, slot_pen=pen,
            )

        return fan_out(qd, self.mesh, self.db_axis, self.q_axis, local,
                       min(k, self.n_shards * kk))

    def search(
        self,
        queries: np.ndarray,
        k: int,
        nprobe: int = 0,
        filter_ids: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Probe-scan top-k over the live set: ``(dists, stable_ids)``.
        ``nprobe`` counts BUCKETS probed per shard."""
        q = np.ascontiguousarray(np.atleast_2d(queries), dtype=np.float32)
        if self.n_active == 0:
            return _empty_result(q.shape[0], k)
        dists, ids = self.device_search(torch.as_tensor(q, device=self.device), k, nprobe,
                                        filter_ids)
        dists = dists.cpu().numpy()
        ids = ids.cpu().numpy().astype(np.int64)
        ids = np.where(np.isfinite(dists), ids, -1)
        dists = np.where(ids >= 0, dists, np.inf)
        return _pad_k(dists, ids, k)

    # -- snapshot -------------------------------------------------------
    def to_artifact(self) -> IndexArtifact:
        """Immutable ``flat`` snapshot of the live rows (host-gathered)."""
        live = np.nonzero(self._slot_host.reshape(-1) >= 0)[0]
        vecs = np.asarray(self._list_vecs).reshape(-1, self.dimension)[live]
        dev = self.device
        return IndexArtifact(
            "flat",
            {
                "vectors": torch.as_tensor(vecs, device=dev),
                "sqnorms": torch.as_tensor((vecs * vecs).sum(-1), device=dev),
                "row_ids": torch.as_tensor(
                    self._slot_host.reshape(-1)[live].astype(np.int32), device=dev),
            },
            {
                "metric": self.metric,
                "dimension": self.dimension,
                "n_vectors": int(live.size),
                "normalize_queries": self.metric == "cosine",
                "mutable_snapshot": True,
                "source": "ShardedMutableIVF",
            },
        )
