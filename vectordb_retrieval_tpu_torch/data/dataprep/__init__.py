"""Offline dataprep: MS MARCO subsampling and embedding (host files in,
the ``msmarco`` loader's layout out)."""
