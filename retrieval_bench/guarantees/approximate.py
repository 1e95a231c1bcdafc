"""The approximate guarantee of a graph index (HNSW-class): no exact set
is promised. What is promised, and judged:

* every returned id is a real row and no id repeats in a row
  (``bad_rows``);
* each returned distance is its id's distance at the precision the index
  stores (the block graph: bf16 residuals against an f32 block mean, the
  f32 query split three ways), so it lies within ``dist_err`` of the
  float64 distance (``dist_err``);
* most answers are among the true top-k: the share of answered entries
  beyond a tie of the exact distance at the same rank stays under
  ``wrong_share``.

The yardstick is the exact float64 top-k of the corpus, as under the
exact guarantee (``topk_gap`` is left without a limit). The index is the
corpus itself: a float64 reference that built its own graph from the same
draws would diverge from the program's f32 k-means, so the walk's own
semantics are checked apart, against ``plain_block_beam.walk`` on the
program's layout.
"""

from retrieval_bench.reference import exact_topk


def build(x, workload, fmt=None):
    return {"x": x}


def search(index, q, k, metric, fmt=None):
    return exact_topk(q, index["x"], k, metric, fmt)
