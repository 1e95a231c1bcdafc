"""Flat (exact) index: raw vectors on the device + exact search.

Counterpart of ``vectordb_retrieval_tpu/models/flat.py``: the unsharded
``flat`` artifact, and the row-sharded ``flat_sharded`` one
(``ShardedFlatIndexer``, searched by ``parallel/sharded.
sharded_exact_search`` over a mesh of the indexer's devices).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.data.storage import corpus_to_device
from vectordb_retrieval_tpu_torch.models.base import (
    BaseIndexer,
    BaseSearcher,
    IndexArtifact,
    register_indexer,
    register_searcher,
)
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.utils.profiling import span


@register_indexer("BruteForceIndexer")
class BruteForceIndexer(BaseIndexer):
    """Stores raw float32 vectors as a device-resident ``flat`` artifact.

    For ``cosine`` the database is L2-normalised once at build time and the
    artifact instructs searchers to normalise queries. Memmap and BigStore
    corpora upload in chunks (``data/storage.corpus_to_device``), so host
    RSS stays O(chunk).
    """

    def build(self, vectors: np.ndarray, dimension: int) -> IndexArtifact:
        dev = corpus_to_device(vectors, device=self.device)
        if self.metric == "cosine":
            dev = dops.normalize(dev)
        data = {"vectors": dev}
        if self.metric == "l2":
            data["sqnorms"] = dops.sq_norms(dev)
        return IndexArtifact(
            kind="flat",
            data=data,
            metadata={
                "metric": self.metric,
                "dimension": int(dimension),
                "n_vectors": int(dev.shape[0]),
                "normalize_queries": self.metric == "cosine",
            },
        )


@register_indexer("ShardedFlatIndexer")
class ShardedFlatIndexer(BaseIndexer):
    """Flat index sharded row-wise over a mesh of ``n_devices`` of the
    indexer's devices (0 = all; a list may repeat a device).
    ``LinearSearcher`` serves it with the cross-shard merge."""

    def __init__(self, metric: str = "l2", n_devices: int = 0, **params):
        super().__init__(metric=metric, **params)
        self.n_devices = int(n_devices)

    def build(self, vectors: np.ndarray, dimension: int) -> IndexArtifact:
        from vectordb_retrieval_tpu_torch.models.sharded import host_rows
        from vectordb_retrieval_tpu_torch.parallel import make_mesh, shard_database

        x = host_rows(vectors, self.metric)  # cosine normalised on the host
        n_dev = self.n_devices or len(self.devices)
        mesh = make_mesh(n_dev, devices=self.devices)
        sharded, n = shard_database(x, mesh)
        art = IndexArtifact(
            kind="flat_sharded",
            data={"vectors": sharded},
            metadata={
                "metric": self.metric,
                "dimension": int(dimension),
                "n_vectors": int(n),
                "normalize_queries": self.metric == "cosine",
                "n_devices": int(n_dev),
            },
        )
        art.mesh = mesh  # runtime-only (not persisted; rebuilt on load)
        return art


@register_searcher("LinearSearcher")
class LinearSearcher(BaseSearcher):
    """Exact search over a ``flat`` artifact on the searcher's device, or
    over a ``flat_sharded`` one by the cross-shard merge."""

    def attach(self, artifact: IndexArtifact) -> None:
        if artifact.kind not in ("flat", "flat_sharded"):
            raise ValueError(
                f"LinearSearcher requires a 'flat' artifact, got {artifact.kind!r}"
            )
        if artifact.kind == "flat_sharded":
            if not hasattr(artifact, "mesh"):
                # loaded from disk: re-shard over the searcher's devices
                from vectordb_retrieval_tpu_torch.parallel import make_mesh, shard_database

                mesh = make_mesh(artifact.metadata.get("n_devices") or None, devices=self.devices)
                rows = np.asarray(artifact.data["vectors"].cpu())[: artifact.metadata["n_vectors"]]
                artifact.data["vectors"], _ = shard_database(rows, mesh)
                artifact.mesh = mesh
            self.artifact = artifact
            return
        on = artifact.data["vectors"].device
        if on != self.device:
            raise ValueError(f"artifact lives on {on}, searcher on {self.device}")
        self.artifact = artifact

    def device_kernel(self, qd: torch.Tensor, k: int):
        """Device queries in, device ``(dists, ids)`` out; no host copy."""
        meta = self.artifact.metadata
        metric = meta.get("metric", self.metric)
        if meta.get("normalize_queries"):
            qd = dops.normalize(qd)
        eff_k = min(k, meta["n_vectors"])
        if self.artifact.kind == "flat_sharded":
            from vectordb_retrieval_tpu_torch.parallel import sharded_exact_search

            return sharded_exact_search(
                qd, self.artifact.data["vectors"], meta["n_vectors"], eff_k, self.artifact.mesh,
                metric=metric if metric != "cosine" else "ip",
            )
        # refine=True: overfetch + accurate rescoring so near-ties at the k
        # boundary resolve exactly (dense path; blockmin is exact already)
        return dops.exact_search(
            qd,
            self.artifact.data["vectors"],
            eff_k,
            metric=metric if metric != "cosine" else "ip",
            db_sqnorms=self.artifact.data.get("sqnorms"),
            refine=True,
            device=self.device,
        )

    def device_batch_search(self, queries: np.ndarray, k: int):
        """Dispatch without waiting: returns (dists_dev, ids_dev, n_rows)."""
        if self.artifact is None:
            raise RuntimeError("searcher not attached to an artifact")
        with span("vrt.h2d"):
            q = torch.as_tensor(
                np.ascontiguousarray(queries, dtype=np.float32), device=self.device
            )
        with span("vrt.search"):
            dists, ids = self.device_kernel(q, k)
        return dists, ids, q.shape[0]

    def batch_search(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        dists, ids, _ = self.device_batch_search(queries, k)
        with span("vrt.d2h"):
            d = dists.cpu().numpy()
            i = ids.cpu().numpy()
            if d.shape[1] < k:  # pad to requested k with inf/-1
                pad = k - d.shape[1]
                d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)
                i = np.pad(i, ((0, 0), (0, pad)), constant_values=-1)
        return d, i
