"""PyTorch / CUDA port of the vector retrieval benchmarking framework.

Mirrors the layout and names of the JAX package ``vectordb_retrieval_tpu``
(the reference) and imports nothing from it:

  bench/     benchmark orchestration, experiments, evaluation, metrics
  models/    index families (exact; IVF-Flat, IVF-SQ8 and SQ8 from the
             factory grammar) and artifact persistence
  ops/       distances, top-k, exact search, k-means, IVF, SQ8;
             ``ops/kernels.py`` holds the hand-written CUDA kernels
             (sources in ``csrc/``)
  data/      dataset synthesis, ground truth, caching, device upload
  utils/     device resolution, hashing

Entry points take ``device=None``: the CUDA card, raising when there is
none. Pass ``device="cpu"`` to run on the host (the kernels' plain PyTorch
versions then stand in for them).
"""

__version__ = "0.1.0"
