"""Sharded index family: row-sharded IVF (Flat/PQ/SQ8) and graph indexers.

Counterpart of ``vectordb_retrieval_tpu/models/sharded.py``: model-layer
wrappers over ``parallel/``. Each indexer builds a mesh over its
``devices`` (a list of devices, which may repeat one; ``None``: every
visible card once each), ``n_devices`` of them (0 = all). Artifacts carry a
runtime-only ``mesh`` attribute; an artifact loaded from disk holds the
stacked ``[n_shards, ...]`` arrays and is placed over the searcher's
devices on attach (:func:`reshard_artifact`).

Kinds ``ivf_flat_sharded`` / ``ivf_pq_sharded`` / ``ivf_sq8_sharded`` /
``graph_sharded``, served by ``ANNSearcher`` with runtime ``nprobe`` /
``efSearch`` like their single-device counterparts.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from vectordb_retrieval_tpu_torch.models.base import BaseIndexer, IndexArtifact, register_indexer
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike


def reshard_artifact(artifact: IndexArtifact, devices: DeviceLike = None) -> None:
    """Give a loaded ``*_sharded`` artifact a mesh of ``n_shards`` of
    ``devices`` and place its stacked arrays along ``db``."""
    from vectordb_retrieval_tpu_torch.parallel.mesh import ShardedTensor, make_mesh

    n_shards = int(artifact.metadata.get("n_shards", 0)) or None
    mesh = make_mesh(n_shards, devices=devices)
    for key, val in artifact.data.items():
        artifact.data[key] = ShardedTensor.place(val, mesh, "db")
    artifact.mesh = mesh


def _normalized(vectors: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(vectors, dtype=np.float32)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


def host_rows(vectors: np.ndarray, metric: str) -> np.ndarray:
    """The corpus as f32 host rows, unit rows for cosine (the JAX
    package's sharded builds normalise on the host)."""
    return _normalized(vectors) if metric == "cosine" else np.ascontiguousarray(
        vectors, dtype=np.float32)


@register_indexer("ShardedIVFIndexer")
class ShardedIVFIndexer(BaseIndexer):
    """One independent IVF partition per shard (Flat/PQ/SQ8 payload).

    ``index_key`` is ``IVF{n},Flat|PQ{m}|SQ8``; ``nlist`` is PER SHARD
    (each shard trains its own coarse quantizer and, for coded payloads,
    its own PQ codebooks or SQ ranges).
    """

    def __init__(
        self,
        metric: str = "l2",
        index_key: str = "IVF64,Flat",
        nprobe: int = 8,
        n_devices: int = 0,
        seed: int = 123,
        train_iters: int = 20,
        pq_rotations: int = 0,
        **params: Any,
    ):
        super().__init__(metric=metric, **params)
        self.index_key = index_key
        self.nprobe = int(nprobe)
        self.n_devices = int(n_devices)  # 0 = all
        self.seed = int(seed)
        self.train_iters = int(train_iters)
        self.pq_rotations = int(pq_rotations)
        self.build_seconds: dict = {}

    def build(self, vectors: np.ndarray, dimension: int) -> IndexArtifact:
        from vectordb_retrieval_tpu_torch.models.factory import parse_index_key
        from vectordb_retrieval_tpu_torch.parallel import (
            build_sharded_ivf_coded,
            build_sharded_ivf_flat,
            make_mesh,
        )

        spec = parse_index_key(self.index_key)
        if spec["nlist"] is None or spec["opq"]:
            raise ValueError(f"ShardedIVFIndexer needs IVF{{n}},Flat|PQ{{m}}|SQ8 (got {self.index_key!r})")
        t0 = time.perf_counter()
        x = host_rows(vectors, self.metric)
        mesh = make_mesh(self.n_devices or None, devices=self.devices)
        if spec["coding"] == "flat":
            data, build_meta = build_sharded_ivf_flat(
                x, mesh, spec["nlist"], seed=self.seed, train_iters=self.train_iters)
        else:
            data, build_meta = build_sharded_ivf_coded(
                x, mesh, spec["nlist"], coding=spec["coding"], m=spec["m"] or 8,
                seed=self.seed, train_iters=self.train_iters, pq_rotations=self.pq_rotations)
        self.build_seconds = dict(build_meta.pop("build_seconds"), total=time.perf_counter() - t0)
        art = IndexArtifact(
            kind=f"ivf_{spec['coding']}_sharded",
            data=data,
            metadata={
                "metric": self.metric,
                "dimension": int(dimension),
                "n_vectors": int(x.shape[0]),
                "normalize_queries": self.metric == "cosine",
                "index_key": self.index_key,
                "nprobe": self.nprobe,
                **build_meta,
            },
        )
        art.mesh = mesh  # runtime-only; reshard_artifact restores it on load
        return art


@register_indexer("ShardedGraphIndexer")
class ShardedGraphIndexer(BaseIndexer):
    """One beam-search graph per shard + the cross-shard merge; ``auto``
    takes block mode above ``models/graph._BLOCK_AUTO_THRESHOLD`` rows a
    shard."""

    def __init__(
        self,
        metric: str = "l2",
        M: int = 16,
        efConstruction: int = 200,
        efSearch: int = 100,
        n_devices: int = 0,
        seed: int = 42,
        mode: str = "auto",  # auto | node | block (models/graph semantics)
        block_size: int = 128,
        **params: Any,
    ):
        super().__init__(metric=metric, **params)
        self.M = int(M)
        self.efConstruction = int(efConstruction)
        self.efSearch = int(efSearch)
        self.n_devices = int(n_devices)
        self.seed = int(seed)
        if mode not in ("auto", "node", "block"):
            raise ValueError("mode must be 'auto', 'node' or 'block'")
        self.mode = mode
        self.block_size = int(block_size)
        self.build_seconds: dict = {}

    def build(self, vectors: np.ndarray, dimension: int) -> IndexArtifact:
        from vectordb_retrieval_tpu_torch.models.graph import _BLOCK_AUTO_THRESHOLD
        from vectordb_retrieval_tpu_torch.parallel import (
            build_sharded_block_graph,
            build_sharded_graph,
            make_mesh,
        )

        t0 = time.perf_counter()
        x = host_rows(vectors, self.metric)
        mesh = make_mesh(self.n_devices or None, devices=self.devices)
        per = -(-x.shape[0] // mesh.shape["db"])
        if self.mode == "block" or (self.mode == "auto" and per > _BLOCK_AUTO_THRESHOLD):
            data, build_meta = build_sharded_block_graph(
                x, mesh, M=self.M, block_size=self.block_size, seed=self.seed)
        else:
            data, build_meta = build_sharded_graph(x, mesh, M=self.M, seed=self.seed)
        self.build_seconds = dict(build_meta.pop("build_seconds"), total=time.perf_counter() - t0)
        art = IndexArtifact(
            kind="graph_sharded",
            data=data,
            metadata={
                "metric": self.metric,
                "dimension": int(dimension),
                "n_vectors": int(x.shape[0]),
                "normalize_queries": self.metric == "cosine",
                "M": self.M,
                "efConstruction": self.efConstruction,
                "efSearch": self.efSearch,
                **build_meta,
            },
        )
        art.mesh = mesh
        return art
