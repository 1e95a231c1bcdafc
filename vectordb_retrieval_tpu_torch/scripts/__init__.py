"""Command-line tools of the port, each run as
``python -m vectordb_retrieval_tpu_torch.scripts.<name>``: the full
benchmark, a single experiment, parameter sweeps, repeated-run algorithm
comparisons and the reference timing protocol."""
