"""The benchmark of vectordb_retrieval_tpu_torch on one NVIDIA H100 (see README.md)."""
