"""ExactSearch: brute-force exact k-NN algorithm (the ground-truth oracle),
a flat-artifact composite over the port's exact search."""

from __future__ import annotations

from typing import Any

from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike


class ExactSearch(CompositeAlgorithm):
    def __init__(
        self, dimension: int, metric: str = "l2", device: DeviceLike = None,
        **params: Any,
    ):
        super().__init__(
            dimension=dimension,
            metric=metric,
            indexer={"type": "BruteForceIndexer"},
            searcher={"type": "LinearSearcher"},
            name="ExactSearch",
            device=device,
            **params,
        )
