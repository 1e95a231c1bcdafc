"""Command-line tools of the port, each run as
``python -m vectordb_retrieval_tpu_torch.scripts.<name>``: the full
benchmark, a single experiment, parameter sweeps, repeated-run algorithm
comparisons and the reference timing protocol; the surrogate calibrations
(GloVe-50, MS MARCO, manifold), the per-list rotations A/B, the binary-LSH
candidate frontier, the SIFT1M surrogate writer and the MS MARCO dataprep
pipeline; and the research probes behind the shipped graph, LSH and
rotation defaults (the LSH guarantee frontier, the cover-tree walks A/B,
the GloVe reachability and geometry sweeps, the block-graph geometry sweep,
the manifold-structure probe); and the tuning probes behind the exact, IVF
and cover-tree defaults (block width, slack, batch and selection, the exact
path's and IVF stream's stages, tail and rescore, both cover-tree walks and
their costs)."""
