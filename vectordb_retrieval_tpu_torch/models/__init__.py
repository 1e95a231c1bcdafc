"""Index families and the algorithm registry.

Every name of the JAX registry is ported: the exact family
(``exact``/``ExactSearch``, flat artifacts), the factory family for
IVF-Flat/PQ/SQ8, PQ and SQ8 (``approx``/``ApproximateSearch``;
``FactoryIndexer``/``ANNSearcher`` and their ``Faiss*`` aliases in the
component registries), the graph family
(``hnsw``/``HNSW``; ``GraphIndexer``/``HNSWIndexer``), the cover tree
(``covertree``/``CoverTree``/``CoverTreeV2_2``) and the LSH family
(``lsh``/``LSH``; ``LSHIndexer``/``LSHSearcher``, ``BinaryLSHIndexer``/
``FaissLSHIndexer``) and the row-sharded indexers (``ShardedFlatIndexer``,
``ShardedIVFIndexer``, ``ShardedGraphIndexer``). An unknown name raises the same ``ValueError`` as
there.
"""

from typing import Any, Dict, Type

from vectordb_retrieval_tpu_torch.models.base import (  # noqa: F401
    BaseAlgorithm,
    BaseIndexer,
    BaseSearcher,
    IndexArtifact,
    INDEXER_REGISTRY,
    SEARCHER_REGISTRY,
    artifact_from_numpy,
    register_indexer,
    register_searcher,
)

# Importing this module populates the indexer/searcher registries.
from vectordb_retrieval_tpu_torch.models import flat  # noqa: F401,E402
from vectordb_retrieval_tpu_torch.models import factory  # noqa: F401,E402
from vectordb_retrieval_tpu_torch.models import lsh as _lsh  # noqa: E402
from vectordb_retrieval_tpu_torch.models import graph as _graph  # noqa: E402
from vectordb_retrieval_tpu_torch.models import sharded as _sharded  # noqa: F401,E402
from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm  # noqa: E402
from vectordb_retrieval_tpu_torch.models.covertree import CoverTree  # noqa: E402
from vectordb_retrieval_tpu_torch.models.exact import ExactSearch  # noqa: E402
from vectordb_retrieval_tpu_torch.models.approximate import ApproximateSearch  # noqa: E402
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike  # noqa: E402

ALGORITHM_REGISTRY: Dict[str, Type[BaseAlgorithm]] = {
    "exact": ExactSearch,
    "ExactSearch": ExactSearch,
    "approx": ApproximateSearch,
    "ApproximateSearch": ApproximateSearch,
    "composite": CompositeAlgorithm,
    "CompositeAlgorithm": CompositeAlgorithm,
    "modular": CompositeAlgorithm,
    "lsh": _lsh.LSH,
    "LSH": _lsh.LSH,
    "hnsw": _graph.HNSW,
    "HNSW": _graph.HNSW,
    "covertree": CoverTree,
    "CoverTree": CoverTree,
    "CoverTreeV2_2": CoverTree,
}


def get_algorithm_instance(
    algorithm_type: str, dimension: int, device: DeviceLike = None, **params: Any
) -> BaseAlgorithm:
    """Factory: name -> configured instance on ``device``."""
    if algorithm_type not in ALGORITHM_REGISTRY:
        raise ValueError(
            f"unknown algorithm type {algorithm_type!r}; "
            f"known: {sorted(ALGORITHM_REGISTRY)}"
        )
    cls = ALGORITHM_REGISTRY[algorithm_type]
    return cls(dimension=dimension, device=device, **params)
