"""Flat (exact) index: raw vectors on the device + exact search.

Counterpart of ``vectordb_retrieval_tpu/models/flat.py``, unsharded. The
row-sharded ``ShardedFlatIndexer`` comes with the multi-device slice,
ROADMAP queue 1 item 10.
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


@register_searcher("LinearSearcher")
class LinearSearcher(BaseSearcher):
    """Exact search over a ``flat`` artifact on the searcher's device."""

    def attach(self, artifact: IndexArtifact) -> None:
        if artifact.kind == "flat_sharded":
            raise NotImplementedError(
                "row-sharded flat artifacts are ported with the multi-device "
                "slice, ROADMAP queue 1 item 10"
            )
        if artifact.kind != "flat":
            raise ValueError(
                f"LinearSearcher requires a 'flat' artifact, got {artifact.kind!r}"
            )
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
        q = torch.as_tensor(
            np.ascontiguousarray(queries, dtype=np.float32), device=self.device
        )
        dists, ids = self.device_kernel(q, k)
        return dists, ids, q.shape[0]

    def batch_search(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        dists, ids, _ = self.device_batch_search(queries, k)
        d = dists.cpu().numpy()
        i = ids.cpu().numpy()
        if d.shape[1] < k:  # pad to requested k with inf/-1
            pad = k - d.shape[1]
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)
            i = np.pad(i, ((0, 0), (0, pad)), constant_values=-1)
        return d, i
