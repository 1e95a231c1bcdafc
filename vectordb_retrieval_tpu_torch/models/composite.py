"""CompositeAlgorithm: adapts an (indexer, searcher) pair to BaseAlgorithm.

The pair is instantiated from the string-keyed registries via config dicts,
on the algorithm's device, and both components' ``describe()`` output is
folded into the reported parameters. ``save_index``/``load_index`` persist
the artifact in the JAX package's format (``models/persist.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from vectordb_retrieval_tpu_torch.models.base import (
    BaseAlgorithm,
    INDEXER_REGISTRY,
    SEARCHER_REGISTRY,
)
from vectordb_retrieval_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
    resolve_devices,
)


def _instantiate(
    registry: Dict[str, Any], config: Dict[str, Any], role: str, device
):
    if not isinstance(config, dict) or "type" not in config:
        raise ValueError(f"{role} config must be a dict with a 'type' key: {config!r}")
    cfg = dict(config)
    type_name = cfg.pop("type")
    if type_name not in registry:
        raise ValueError(
            f"unknown {role} type {type_name!r}; known: {sorted(registry)}"
        )
    return registry[type_name](device=device, **cfg)


class CompositeAlgorithm(BaseAlgorithm):
    """BaseAlgorithm facade over a registry-resolved indexer+searcher pair."""

    def __init__(
        self,
        dimension: int,
        indexer: Optional[Dict[str, Any]] = None,
        searcher: Optional[Dict[str, Any]] = None,
        metric: str = "l2",
        name: Optional[str] = None,
        device: DeviceLike = None,
        **params: Any,
    ):
        super().__init__(dimension=dimension, metric=metric, **params)
        if indexer is None or searcher is None:
            raise ValueError(
                "CompositeAlgorithm requires both 'indexer' and 'searcher' configs"
            )
        self.device = resolve_device(device)
        devices = resolve_devices(device)  # a list builds a sharded index's mesh
        # Components inherit the algorithm metric unless they pin their own.
        indexer = {"metric": metric, **indexer}
        searcher = {"metric": metric, **searcher}
        self.indexer = _instantiate(INDEXER_REGISTRY, indexer, "indexer", devices)
        self.searcher = _instantiate(
            SEARCHER_REGISTRY, searcher, "searcher", devices
        )
        if name:
            self.name = name
        self.artifact = None

    def build_index(self, vectors: np.ndarray) -> None:
        self.artifact = self.indexer.build(vectors, self.dimension)
        self.searcher.attach(self.artifact)
        self.is_built = True

    def batch_search(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        if not self.is_built:
            raise RuntimeError("index not built")
        self.record_stream_ops(int(queries.shape[0]))
        return self.searcher.batch_search(queries, k)

    def device_kernel(self, q, k: int):
        """Device queries in, device ``(dists, ids)`` out (no host copy)."""
        return self.searcher.device_kernel(q, k)

    @property
    def has_device_kernel(self) -> bool:
        return hasattr(self.searcher, "device_kernel")

    def record_stream_ops(self, n_queries: int) -> None:
        """Analytic op accounting for ``n_queries`` searched queries."""
        n = self.artifact.metadata.get("n_vectors", 0) if self.artifact else 0
        self.record_operation(
            "ndis", self.searcher.estimated_ops_per_query(n) * int(n_queries)
        )

    def get_parameters(self) -> Dict[str, Any]:
        p = super().get_parameters()
        p["indexer"] = self.indexer.describe()
        p["searcher"] = self.searcher.describe()
        return p

    # -- persistence (models/persist.py) --------------------------------
    def save_index(self, path: str, context: Optional[Dict[str, Any]] = None) -> None:
        from vectordb_retrieval_tpu_torch.models import persist

        if self.artifact is None:
            raise RuntimeError("nothing to save: index not built")
        persist.save_artifact(self.artifact, path, context or {})

    def load_index(self, path: str, context: Optional[Dict[str, Any]] = None) -> None:
        from vectordb_retrieval_tpu_torch.models import persist

        self.artifact = persist.load_artifact(path, context or {}, device=self.device)
        self.searcher.attach(self.artifact)
        self.is_built = True
