"""Sharded graph (HNSW-class) search: one beam-search graph per shard.

Counterpart of ``vectordb_retrieval_tpu/parallel/sharded_graph.py``. Rows
split contiguously over the mesh's ``db`` axis; each shard builds its own
graph and entry points over its rows (``ops/graph``, the single-device
builds, seeded ``seed + s``), queries fan out to every shard, each runs the
single-device beam (the block beam on kernel K2, or the node beam), local
ids become global and ``parallel/sharded_ivf.gather_merge`` cuts the
candidates. Per-shard graphs need no cross-device edges: the merge costs
one k-wide gather per query batch.

Shards are padded to equal row counts: node mode with +inf-norm sentinel
rows whose adjacency is self-loops (entries exclude them; the merge masks
ids >= ``n_total``), block mode with 1e9 sentinel entries, ``-1`` slots and
``-1`` adjacency; an empty shard's entry list is all ``-1`` (node) or one
sentinel entry (block).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import graph as gops
from vectordb_retrieval_tpu_torch.parallel.mesh import Axis, Laps, Mesh, place_stacks
from vectordb_retrieval_tpu_torch.parallel.sharded_ivf import fan_out, shard_devices


def build_sharded_graph(x: np.ndarray, mesh: Mesh, M: int = 16, seed: int = 42, axis: Axis = "db"):
    """Per-shard kNN-graph build: ``(data of ShardedTensor stacks, metadata)``."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    lap = Laps(mesh)
    devices = shard_devices(mesh, axis)
    n_shards = len(devices)
    n, d = x.shape
    per = -(-n // n_shards)
    degree = min(2 * M, max(per - 1, 1))
    n_entry = min(2048, max(16, per // 10))

    vec_stack = np.zeros((n_shards, per, d), dtype=np.float32)
    sqn_stack = np.full((n_shards, per), np.inf, dtype=np.float32)
    adj_stack = np.zeros((n_shards, per, degree), dtype=np.int32)
    ent_stack = np.full((n_shards, n_entry), -1, dtype=np.int32)
    for s in range(n_shards):
        lo, hi = s * per, min((s + 1) * per, n)
        rows = hi - lo
        if rows <= 0:
            # empty trailing shard: sentinel rows + self-loop adjacency;
            # entries stay -1 so the beam never starts
            adj_stack[s] = np.arange(per)[:, None]
            continue
        xs = torch.as_tensor(x[lo:hi], device=devices[s])
        a = gops.build_knn_graph(xs, min(degree, max(rows - 1, 1))).cpu().numpy()
        e = gops.pick_entry_points(xs, min(n_entry, rows), seed=seed + s).cpu().numpy()
        vec_stack[s, :rows] = x[lo:hi]
        sqn_stack[s, :rows] = (x[lo:hi] ** 2).sum(axis=1)
        adj_stack[s, :rows, : a.shape[1]] = a
        if a.shape[1] < degree:  # degree-clamped tiny shard: self-loops pad
            adj_stack[s, :rows, a.shape[1]:] = np.arange(rows)[:, None]
        if rows < per:  # sentinel rows point at themselves
            adj_stack[s, rows:] = np.arange(rows, per)[:, None]
        ent_stack[s, : e.shape[0]] = e
    lap("graphs")
    data = place_stacks({"vectors": vec_stack, "sqnorms": sqn_stack, "adjacency": adj_stack,
                         "entry_ids": ent_stack}, mesh, axis)
    lap("stack_place")
    return data, {"n_shards": n_shards, "rows_per_shard": per, "degree": degree,
                  "n_entry": n_entry, "build_seconds": lap.seconds}


def _stack_padded(parts, fill) -> np.ndarray:
    """Each shard's array padded to the elementwise max shape, stacked."""
    tgt = np.stack([np.asarray(p.shape) for p in parts]).max(axis=0)
    out = np.full((len(parts), *tgt), fill, dtype=parts[0].dtype)
    for s, p in enumerate(parts):
        out[(s,) + tuple(slice(0, e) for e in p.shape)] = p
    return out


def build_sharded_block_graph(
    x: np.ndarray,
    mesh: Mesh,
    M: int = 16,
    block_size: int = 128,
    seed: int = 42,
    axis: Axis = "db",
):
    """Per-shard BLOCK-graph build (``ops/graph.build_block_graph``, f32
    slabs): one block graph per row shard, global slot ids."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    lap = Laps(mesh)
    devices = shard_devices(mesh, axis)
    n_shards = len(devices)
    n, d = x.shape
    per = -(-n // n_shards)
    stacks = [[] for _ in range(6)]
    for s in range(n_shards):
        lo, hi = s * per, min((s + 1) * per, n)
        rows = max(hi - lo, 0)
        if rows == 0:
            parts = (np.full((1, d), 1e9, np.float32), np.zeros(1, np.int32),
                     np.full((1, block_size), -1, np.int32),
                     np.zeros((1, block_size, d), np.float32),
                     np.zeros((1, block_size), np.float32), np.zeros((1, 1), np.int32))
        else:
            xs = torch.as_tensor(x[lo:hi], device=devices[s])
            n_blocks = max(1, -(-rows // block_size))
            degree = max(4, min(2 * M, n_blocks - 1)) if n_blocks > 1 else 1
            entries, entry_block, slot_ids, list_vecs, list_sqn, adj, _ = gops.build_block_graph(
                xs, n_blocks, degree, seed=seed + s)
            slot_g = slot_ids.cpu().numpy()
            slot_g = np.where(slot_g >= 0, slot_g + lo, -1).astype(np.int32)
            parts = (entries.cpu().numpy(), entry_block.cpu().numpy(), slot_g,
                     list_vecs.cpu().numpy(), list_sqn.cpu().numpy(), adj.cpu().numpy())
        for j, p in enumerate(parts):
            stacks[j].append(p)
    lap("block_graphs")
    # padded entries carry 1e9 sentinels (never seeded), padded adjacency
    # -1 (masked); padded entry_block 0 is never reached
    ent, eblk, slots, vecs, sqn, adj = (
        _stack_padded(ps, f) for ps, f in zip(stacks, (1e9, 0, -1, 0.0, 0.0, -1)))
    data = place_stacks({"entries": ent, "entry_block": eblk, "slot_ids": slots,
                         "list_vecs": vecs, "list_sqnorms": sqn, "entry_adj": adj}, mesh, axis)
    lap("stack_place")
    return data, {"n_shards": n_shards, "rows_per_shard": per, "mode": "block",
                  "n_blocks": int(slots.shape[1]), "block_len": int(slots.shape[2]),
                  "degree": int(adj.shape[2]), "build_seconds": lap.seconds}


def sharded_block_graph_search(
    queries: torch.Tensor,
    data: dict,
    k: int,
    mesh: Mesh,
    efb: int = 32,
    expand: int = 8,
    iters: int = 8,
    metric: str = "l2",
    axis: Axis = "db",
    q_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block beam per shard (kernel K2 each wave) + merge; slot ids are
    global already."""
    nb, length = data["slot_ids"].shard_shape
    eff_k = min(k, nb * length)
    out_k = min(k, mesh.size(axis) * eff_k)

    def local(q, c):
        d, i = gops.block_graph_search(
            q, data["entries"].shard(c), data["entry_block"].shard(c),
            data["slot_ids"].shard(c), data["list_vecs"].shard(c),
            data["list_sqnorms"].shard(c), data["entry_adj"].shard(c), None,
            k=eff_k, efb=efb, expand=expand, iters=iters, metric=metric,
        )
        return torch.where(i >= 0, d, float("inf")), i

    return fan_out(queries, mesh, axis, q_axis, local, out_k)


def sharded_graph_search(
    queries: torch.Tensor,
    data: dict,
    n_total: int,
    k: int,
    mesh: Mesh,
    ef: int = 64,
    metric: str = "l2",
    axis: Axis = "db",
    q_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Node beam per shard (exact f32 rescore of its survivors) + merge."""
    per = data["vectors"].shard_shape[0]
    degree = data["adjacency"].shard_shape[1]
    # the single-device serving geometry, sized by the SHARD row count
    eff_k = min(k, per)
    ef_l = min(max(ef, eff_k + 8, 16), per)
    # the 8-wide floor must not exceed the beam itself on tiny shards
    expand = min(max(8, min(ef_l, 1536 // max(degree, 1))), ef_l)
    keep = max(eff_k, (3 * ef_l) // 4)
    iters = 3 + (per > 50_000) + (per > 500_000)
    iters = max(iters, -(-ef_l // keep) + 1)
    # the merge keeps up to a full k even when k > rows per shard
    out_k = min(k, mesh.size(axis) * eff_k)

    def local(q, c):
        d, i = gops.graph_search(
            q, data["vectors"].shard(c), data["adjacency"].shard(c),
            data["entry_ids"].shard(c), eff_k, ef=ef_l, expand=expand, iters=iters,
            metric=metric, sqnorms=data["sqnorms"].shard(c), cand_keep=keep, rescore=True,
        )
        gid = torch.where(i >= 0, i + mesh.shard_index(c, axis) * per, -1)
        valid = (gid >= 0) & (gid < n_total)
        return torch.where(valid, d, float("inf")), torch.where(valid, gid, -1)

    return fan_out(queries, mesh, axis, q_axis, local, out_k)
