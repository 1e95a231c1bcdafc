"""The exact guarantee: every answer is the exact top-k of the corpus,
ties aside. The index is the corpus itself."""

from retrieval_bench.reference import exact_topk


def build(x, workload, fmt=None):
    return {"x": x}


def search(index, q, k, metric, fmt=None):
    return exact_topk(q, index["x"], k, metric, fmt)
