"""ApproximateSearch: factory-grammar ANN algorithm, a composite over
:class:`FactoryIndexer` + :class:`ANNSearcher` with runtime ``nprobe``
(counterpart of ``vectordb_retrieval_tpu/models/approximate.py``)."""

from __future__ import annotations

from typing import Any, Optional

from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike


class ApproximateSearch(CompositeAlgorithm):
    def __init__(
        self,
        dimension: int,
        metric: str = "l2",
        index_type: str = "IVF100,Flat",
        nprobe: int = 10,
        list_dtype: Optional[str] = None,
        exact_rescore: Optional[bool] = None,
        device: DeviceLike = None,
        **params: Any,
    ):
        indexer = {
            "type": "FactoryIndexer",
            "index_key": index_type,
            "nprobe": nprobe,
        }
        if list_dtype is not None:
            indexer["list_dtype"] = list_dtype
        if exact_rescore is not None:
            indexer["exact_rescore"] = exact_rescore
        super().__init__(
            dimension=dimension,
            metric=metric,
            indexer=indexer,
            searcher={"type": "ANNSearcher", "nprobe": nprobe},
            name="ApproximateSearch",
            device=device,
            **params,
        )
