"""Sharded IVF: one IVF partition per shard + the cross-shard top-k merge.

Counterpart of ``vectordb_retrieval_tpu/parallel/sharded_ivf.py``. Each
shard of the mesh's ``db`` axis holds its own ``[n_buckets, L]`` bucketed
lists over its contiguous row range, with slot ids stored as GLOBAL row
ids; a search runs the single-device ``ops/ivf`` search on every shard of
a ring (no host sync between one shard's launches and the next, so shards
on different cards run at once) and :func:`gather_merge` cuts the ``k x P``
candidates to the global top-k.

Shard stacks are padded to the cross-shard maximum (``n_buckets``, ``L``)
with the JAX package's sentinels: 1e9 coarse rows, ``-1`` slots, list 0 for
dead buckets. Empty trailing shards get one dead bucket. The persisted form
is the stacked ``[P, ...]`` array of each key, as the JAX package writes.

nprobe semantics: each shard probes its own ``nprobe`` nearest LISTS
(``ops/ivf.exact_probe_mask``) with the bucket budget sized by the
cross-shard worst case (``probe_cum``); ``nprobe_lists=0`` keeps the
generous bucket budget. Each shard trains with ``seed + s``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import ivf as ivfops
from vectordb_retrieval_tpu_torch.ops import pq as pqops
from vectordb_retrieval_tpu_torch.ops import sq as sqops
from vectordb_retrieval_tpu_torch.ops.kmeans import kmeans_assign, kmeans_fit
from vectordb_retrieval_tpu_torch.parallel.mesh import (
    Axis,
    Coord,
    Laps,
    Mesh,
    ShardedTensor,
    place_stacks,
)

# cut key of an empty candidate (id -1): after every real id
_NO_ID = (1 << 32) - 1

Local = Callable[[torch.Tensor, Coord], Tuple[torch.Tensor, torch.Tensor]]


def _cut(d: torch.Tensor, i: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest distances of each row, equal ones in ascending
    global id (``-1`` last): one tie-free top-k, the same on card and host.
    ``i`` is ``[B, M]`` or ``[1, M]``."""
    key = torch.where(i >= 0, i, _NO_ID)
    vals, pos = dops.top_k_smallest_by_id(d, key, k)
    return vals, torch.gather(i.expand(d.shape[0], -1), 1, pos)


def gather_merge(parts: List[Tuple[torch.Tensor, torch.Tensor]], k: int, group=None):
    """Merge per-shard ``(dists [B, kk], global ids [B, kk])`` lists, given
    in shard order: each copied to the first shard's device, concatenated,
    and cut to ``min(k, total)`` (distance, then global id). With ``group``
    (a process axis), every process's merged list, padded to ``k`` with
    +inf / -1, is gathered by ``all_gather`` and cut again."""
    dev = parts[0][0].device
    d = torch.cat([pd.to(dev, non_blocking=True) for pd, _ in parts], dim=1)
    i = torch.cat([pi.to(dev, non_blocking=True).long() for _, pi in parts], dim=1)
    d, i = _cut(d, i, min(k, d.shape[1]))
    if group is None:
        return d, i
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    world = dist.get_world_size(group)
    b, w = d.shape
    if w < k:
        d = torch.cat([d, torch.full((b, k - w), float("inf"), device=dev)], dim=1)
        i = torch.cat([i, torch.full((b, k - w), -1, dtype=torch.int64, device=dev)], dim=1)
    all_d = torch.empty((world * b, k), dtype=d.dtype, device=dev)
    all_i = torch.empty((world * b, k), dtype=torch.int64, device=dev)
    gather(all_d, d.contiguous(), group=group)
    gather(all_i, i.contiguous(), group=group)
    cat_d = all_d.reshape(world, b, k).permute(1, 0, 2).reshape(b, world * k)
    cat_i = all_i.reshape(world, b, k).permute(1, 0, 2).reshape(b, world * k)
    return _cut(cat_d, cat_i, k)


def fan_out(
    queries: torch.Tensor,
    mesh: Mesh,
    axis: Axis,
    q_axis: Optional[str],
    local: Local,
    out_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every shard of a ring searches the queries (``local(queries on the
    shard's device, coordinate)`` -> global ids) and the ring merges them.
    With ``q_axis`` the batch splits into contiguous blocks, one per ring
    of that axis. Results land on the queries' device."""
    rings = mesh.rings(axis, q_axis)
    blocks = torch.tensor_split(queries, len(rings)) if q_axis is not None else (queries,)
    group = mesh.group if mesh.spans_processes(axis) else None
    outs = []
    for qb, ring in zip(blocks, rings):
        parts = [local(qb.to(mesh.devices[c], non_blocking=True), c) for c in ring]
        d, i = gather_merge(parts, out_k, group)
        outs.append((d.to(queries.device, non_blocking=True), i.to(queries.device, non_blocking=True)))
    if len(outs) == 1:
        return outs[0]
    return torch.cat([d for d, _ in outs]), torch.cat([i for _, i in outs])


def shard_devices(mesh: Mesh, axis: Axis) -> Dict[int, torch.device]:
    """The device of the first local coordinate holding each shard; shards
    of other processes are built on the mesh's first device."""
    out: Dict[int, torch.device] = {}
    for c in mesh.coords():
        out.setdefault(mesh.shard_index(c, axis), mesh.devices[c])
    return {s: out.get(s, mesh.first_device) for s in range(mesh.size(axis))}


def _np_coarse(centroids, bucket_lists) -> np.ndarray:
    """Host ``ops/ivf.coarse_table``: dead buckets (list -1) get 1e9 rows."""
    c = np.asarray(centroids)
    bl = np.asarray(bucket_lists)
    tab = c[np.maximum(bl, 0)]
    return np.where((bl >= 0)[:, None], tab, np.float32(1e9))


def _shard_bucketed_layouts(x: np.ndarray, devices: Dict[int, torch.device], nlist: int,
                            seed: int, train_iters: int):
    """Per-shard coarse training (``seed + s``) and bucketed layout with
    global ids: ``(layouts, max_buckets, max_len)``, each layout
    ``(centroids, global slot ids [nb, L], bucket_lists [nb], assign)``."""
    n, d = x.shape
    n_shards = len(devices)
    per = -(-n // n_shards)
    layouts = []
    max_buckets = max_len = 1
    for s in range(n_shards):
        lo, hi = s * per, min((s + 1) * per, n)
        if hi <= lo:
            # empty trailing shard: one dead bucket whose sentinel centroid
            # is never probed
            layouts.append((np.full((1, d), 1e9, np.float32), np.full((1, 8), -1, np.int32),
                            np.zeros(1, np.int32), np.zeros(0, np.int32)))
            max_len = max(max_len, 8)
            continue
        xs = torch.as_tensor(x[lo:hi], device=devices[s])
        local_nlist = min(nlist, hi - lo)
        centroids, _ = kmeans_fit(xs, local_nlist, seed=seed + s, iters=train_iters)
        assign = kmeans_assign(xs, centroids).cpu().numpy()
        slot_ids, bucket_lists, _ = ivfops.build_bucketed_lists(assign, local_nlist)
        slot_g = np.where(slot_ids >= 0, slot_ids + lo, -1).astype(np.int32)
        layouts.append((centroids.cpu().numpy(), slot_g, bucket_lists, assign))
        max_buckets = max(max_buckets, slot_ids.shape[0])
        max_len = max(max_len, slot_ids.shape[1])
    return layouts, max_buckets, max_len


def _sharded_probe_cum(layouts, nlist: int) -> list:
    """Cross-shard probe budget: ``cum[r]`` covers the ``r+1`` nearest lists
    on EVERY shard (elementwise max of each shard's sorted bucket counts)."""
    worst = np.zeros(max(nlist, 1), np.int64)
    for _c, _s, bucket_lists, _a in layouts:
        counts = np.bincount(bucket_lists[bucket_lists >= 0], minlength=max(nlist, 1))[:nlist]
        srt = np.sort(counts)[::-1]
        worst[: srt.size] = np.maximum(worst[: srt.size], srt)
    return [int(v) for v in np.cumsum(np.maximum(worst, 1))]


def build_sharded_ivf_flat(
    x: np.ndarray,
    mesh: Mesh,
    nlist: int,
    seed: int = 123,
    train_iters: int = 20,
    axis: Axis = "db",
):
    """Per-shard IVF-Flat build: ``(data of ShardedTensor stacks, metadata)``.

    Rows split contiguously over ``axis``; each shard trains its own
    ``nlist`` centroids over its rows and lays out f32 lists whose slot ids
    are global row indices.
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    lap = Laps(mesh)
    devices = shard_devices(mesh, axis)
    n_shards = len(devices)
    layouts, max_buckets, max_len = _shard_bucketed_layouts(x, devices, nlist, seed, train_iters)
    lap("coarse_kmeans_layout")
    d = x.shape[1]
    cent_stack = np.full((n_shards, max_buckets, d), 1e9, dtype=np.float32)
    slot_stack = np.full((n_shards, max_buckets, max_len), -1, dtype=np.int32)
    vec_stack = np.zeros((n_shards, max_buckets, max_len, d), dtype=np.float32)
    # dead and padding buckets map to list 0: their 1e9 centroids never win
    # a segment-min or a probe slot, and their slots are -1
    bl_stack = np.zeros((n_shards, max_buckets), dtype=np.int32)
    for s, (centroids, slot_g, bucket_lists, _assign) in enumerate(layouts):
        nb, ml = slot_g.shape
        cent_stack[s, :nb] = _np_coarse(centroids, bucket_lists)
        slot_stack[s, :nb, :ml] = slot_g
        bl_stack[s, :nb] = np.maximum(bucket_lists, 0)
        live = slot_stack[s] >= 0
        vec_stack[s][live] = x[slot_stack[s][live]]
    sqn_stack = np.sum(vec_stack * vec_stack, axis=-1)
    data = place_stacks({
        "centroids": cent_stack, "slot_ids": slot_stack, "list_vecs": vec_stack,
        "list_sqnorms": sqn_stack, "bucket_lists": bl_stack,
    }, mesh, axis)
    lap("stack_place")
    return data, {
        "nlist": nlist,
        "n_buckets": max_buckets,
        "max_list_len": max_len,
        "n_shards": n_shards,
        "probe_cum": _sharded_probe_cum(layouts, nlist),
        "build_seconds": lap.seconds,
    }


def _exact_kw(data, c: Coord, nlist: int, nprobe_lists: int) -> dict:
    if not (nprobe_lists and nlist and "bucket_lists" in data):
        return {}
    return {"bucket_lists": data["bucket_lists"].shard(c), "nlist": nlist,
            "nprobe_lists": nprobe_lists}


def sharded_ivf_flat_search(
    queries: torch.Tensor,
    data: dict,
    k: int,
    nprobe: int,
    mesh: Mesh,
    metric: str = "l2",
    axis: Axis = "db",
    q_axis: Optional[str] = None,
    nlist: int = 0,
    nprobe_lists: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe scan per shard + merge. ``nlist``/``nprobe_lists`` (with
    ``bucket_lists`` in ``data``) give each shard the reference's "probe
    nprobe lists" semantics; 0 keeps the generous bucket budget."""

    def local(q, c):
        return ivfops.ivf_flat_search(
            q, data["centroids"].shard(c), data["slot_ids"].shard(c),
            data["list_vecs"].shard(c), data["list_sqnorms"].shard(c), k, nprobe,
            metric=metric, **_exact_kw(data, c, nlist, nprobe_lists),
        )

    return fan_out(queries, mesh, axis, q_axis, local, k)


def build_sharded_ivf_coded(
    x: np.ndarray,
    mesh: Mesh,
    nlist: int,
    coding: str = "sq8",
    m: int = 8,
    seed: int = 123,
    train_iters: int = 20,
    axis: Axis = "db",
    pq_rotations: int = 0,
):
    """Per-shard IVF with PQ-residual or SQ8 list codes.

    The layout of :func:`build_sharded_ivf_flat`, but each shard trains its
    OWN quantizer (PQ codebooks over its residuals, with per-list
    rotations when ``pq_rotations`` is a block size, or SQ ranges): no
    cross-shard codebook sync. The PQ codebook size is uniform across
    shards (the stacked tensor is rectangular), so it is bounded by the
    smallest non-empty shard.
    """
    if coding not in ("pq", "sq8"):
        raise ValueError(f"coding must be 'pq' or 'sq8', got {coding!r}")
    x = np.ascontiguousarray(x, dtype=np.float32)
    lap = Laps(mesh)
    devices = shard_devices(mesh, axis)
    n_shards = len(devices)
    n, d = x.shape
    per = -(-n // n_shards)
    layouts, max_buckets, max_len = _shard_bucketed_layouts(x, devices, nlist, seed, train_iters)
    lap("coarse_kmeans_layout")
    code_w = m if coding == "pq" else d
    ksub = min([256] + [a.shape[0] for (_, _, _, a) in layouts if a.shape[0] > 0])
    shards = []
    for s, (centroids, slot_g, bucket_lists, assign) in enumerate(layouts):
        lo, hi = s * per, min((s + 1) * per, n)
        if hi <= lo:  # empty shard: zero codes under the dead bucket
            nbs, mls = slot_g.shape
            if coding == "pq":
                extras = {"codebooks": np.zeros((m, ksub, d // m), np.float32)}
                if pq_rotations:
                    bs = pq_rotations
                    extras["list_rotations"] = np.broadcast_to(
                        np.eye(bs, dtype=np.float32), (nlist, d // bs, bs, bs)).copy()
            else:
                extras = {"vmin": np.zeros(d, np.float32), "step": np.full(d, 1e-12, np.float32)}
            shards.append((centroids, slot_g, bucket_lists, np.zeros((nbs, mls, code_w), np.uint8),
                           np.zeros((nbs, mls), np.float32), extras))
            continue
        dev = devices[s]
        xs = torch.as_tensor(x[lo:hi], device=dev)
        cents = torch.as_tensor(centroids, device=dev)
        assign_t = torch.as_tensor(assign, device=dev).long()
        if coding == "pq":
            residuals = xs - cents[assign_t]
            if pq_rotations:
                rots, codebooks = pqops.train_per_list_rotations(
                    residuals, assign_t, nlist, m, pq_rotations, ksub=ksub, seed=seed + s,
                    iters=train_iters)
                codes = pqops.pq_encode_rotated(residuals, assign_t, rots, codebooks)
                extras = {"codebooks": codebooks.cpu().numpy(), "list_rotations": rots.cpu().numpy()}
            else:
                codebooks = pqops.pq_train(residuals, m, ksub=ksub, seed=seed + s, iters=train_iters)
                codes = pqops.pq_encode(residuals, codebooks)
                extras = {"codebooks": codebooks.cpu().numpy()}
            sqn = pqops.pq_code_sqnorms(codes, codebooks)
        else:
            vmin, step = sqops.sq_train(xs)
            codes = sqops.sq_encode(xs, vmin, step)
            sqn = dops.sq_norms(sqops.sq_decode(codes, vmin, step))
            extras = {"vmin": vmin.cpu().numpy(), "step": step.cpu().numpy()}
        codes, sqn = codes.cpu().numpy(), sqn.cpu().numpy()
        local = np.where(slot_g >= 0, slot_g - lo, 0)
        shards.append((centroids, slot_g, bucket_lists, codes[local], sqn[local], extras))
    lap("quantizer_train_encode")

    cent_stack = np.full((n_shards, max_buckets, d), 1e9, dtype=np.float32)
    slot_stack = np.full((n_shards, max_buckets, max_len), -1, dtype=np.int32)
    code_stack = np.zeros((n_shards, max_buckets, max_len, code_w), dtype=np.uint8)
    sqn_stack = np.zeros((n_shards, max_buckets, max_len), dtype=np.float32)
    bl_stack = np.zeros((n_shards, max_buckets), dtype=np.int32)
    extra_stacks: Dict[str, list] = {}
    for s, (cents, slot_g, bucket_lists, codes_l, sqn_l, extras) in enumerate(shards):
        nb, ml = slot_g.shape
        cent_stack[s, :nb] = _np_coarse(cents, bucket_lists)
        slot_stack[s, :nb, :ml] = slot_g
        code_stack[s, :nb, :ml] = codes_l
        sqn_stack[s, :nb, :ml] = sqn_l
        bl_stack[s, :nb] = np.maximum(bucket_lists, 0)
        for key, val in extras.items():
            extra_stacks.setdefault(key, []).append(val)
    stacks = {"centroids": cent_stack, "slot_ids": slot_stack, "list_codes": code_stack,
              "list_sqnorms": sqn_stack, "bucket_lists": bl_stack}
    stacks.update({key: np.stack(vals) for key, vals in extra_stacks.items()})
    data = place_stacks(stacks, mesh, axis)
    lap("stack_place")
    return data, {
        "nlist": nlist,
        "n_buckets": max_buckets,
        "max_list_len": max_len,
        "n_shards": n_shards,
        "coding": coding,
        "probe_cum": _sharded_probe_cum([(c, s, bl, None) for c, s, bl, *_ in shards], nlist),
        "build_seconds": lap.seconds,
    }


def sharded_ivf_coded_search(
    queries: torch.Tensor,
    data: dict,
    k: int,
    nprobe: int,
    mesh: Mesh,
    coding: str = "sq8",
    metric: str = "l2",
    axis: Axis = "db",
    q_axis: Optional[str] = None,
    nlist: int = 0,
    nprobe_lists: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized probe scan per shard + merge (nprobe semantics as
    :func:`sharded_ivf_flat_search`)."""

    def local(q, c):
        kw = _exact_kw(data, c, nlist, nprobe_lists)
        base = (q, data["centroids"].shard(c), data["slot_ids"].shard(c),
                data["list_codes"].shard(c), data["list_sqnorms"].shard(c))
        if coding == "pq":
            if "list_rotations" in data:
                kw.update(list_rotations=data["list_rotations"].shard(c),
                          rot_bucket_lists=data["bucket_lists"].shard(c))
            return ivfops.ivf_pq_search(*base, data["codebooks"].shard(c), k, nprobe,
                                        metric=metric, **kw)
        return ivfops.ivf_sq_search(*base, data["vmin"].shard(c), data["step"].shard(c), k,
                                    nprobe, metric=metric, **kw)

    return fan_out(queries, mesh, axis, q_axis, local, k)
