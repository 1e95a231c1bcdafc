"""Sharded exact search: per-shard top-k + cross-shard merge.

Counterpart of ``vectordb_retrieval_tpu/parallel/sharded.py``. The database
``[N, d]`` is sharded row-wise over the mesh's ``db`` axis (or over
``("dcn", "db")``, across processes); each shard scores its rows with
``ops/distances.pairwise_distances`` (f32, TF32 off), masks the global
padding rows to +inf, keeps a local top-k over global ids and
``parallel/sharded_ivf.gather_merge`` cuts the ``k x P`` candidates: k
candidates per query cross devices, never the distance matrix. With a
``q`` axis each contiguous block of queries merges inside its own ring.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.parallel.mesh import Axis, Mesh, ShardedTensor
from vectordb_retrieval_tpu_torch.parallel.sharded_ivf import _cut, fan_out


def shard_database(x, mesh: Mesh, axis: Axis = "db") -> Tuple[ShardedTensor, int]:
    """Pad rows to a multiple of the axis size with zeros and place them
    over ``mesh``: ``(sharded rows, original row count)``; padding rows are
    masked at search time by the row count."""
    n_shards = mesh.size(axis)
    x = np.ascontiguousarray(x, dtype=np.float32)
    n = x.shape[0]
    padded_n = -(-n // n_shards) * n_shards
    if padded_n != n:
        x = np.concatenate([x, np.zeros((padded_n - n, x.shape[1]), dtype=x.dtype)], axis=0)
    return ShardedTensor.place(x, mesh, axis, stacked=False), n


def sharded_exact_search(
    queries: torch.Tensor,
    db_sharded: ShardedTensor,
    n_total: int,
    k: int,
    mesh: Mesh,
    metric: str = "l2",
    db_axis: Axis = "db",
    q_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a row-sharded database: ``(dists, ids)`` on the
    queries' device, ids global rows, equal distances in ascending id."""
    shard_rows = db_sharded.shard_shape[0]
    kk = min(k, shard_rows)
    out_k = min(k, mesh.size(db_axis) * kk)

    def local(q, c):
        xs = db_sharded.shard(c)
        gids = mesh.shard_index(c, db_axis) * shard_rows + torch.arange(
            shard_rows, device=xs.device)
        d = dops.pairwise_distances(q, xs, metric)
        d = torch.where(gids[None, :] < n_total, d, float("inf"))
        return _cut(d, gids[None, :], kk)

    return fan_out(queries, mesh, db_axis, q_axis, local, out_k)
