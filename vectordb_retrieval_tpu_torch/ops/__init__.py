"""Compute functions on tensors: distances, top-k, exact search, kernels."""

from vectordb_retrieval_tpu_torch.ops.distances import (  # noqa: F401
    METRICS,
    exact_search,
    normalize,
    pairwise_distances,
    top_k_smallest,
)
