"""MS MARCO dataprep pipeline: subsample then embed, from one YAML config
(reference pattern: subsample_msmarco.py + embed_msmarco.py driven by
configs/ms_marco_subset_embed.yaml). The counterpart of the JAX package's
``scripts/prepare_msmarco.py`` on the port's ``data/dataprep`` modules.

No step downloads. The config must name local TSVs (``corpus_tsv``,
``queries_tsv``): sampling without them streams the corpus through
``ir_datasets``, which downloads it. The embed step must be
``synthetic: true``: the MiniLM encoders need the model's weights, which
are not in the repository. Both refusals come before anything is written.

    python -m vectordb_retrieval_tpu_torch.scripts.prepare_msmarco \
        [--config configs/ms_marco_subset_embed.yaml] [--device cpu]

``--device`` (passed on to the embedder) defaults to the CUDA card and
fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import yaml

from vectordb_retrieval_tpu_torch.data.dataprep import embed_msmarco, subsample_msmarco
from vectordb_retrieval_tpu_torch.utils.device import resolve_device


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/ms_marco_subset_embed.yaml")
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    with open(args.config) as f:
        cfg = yaml.safe_load(f)

    sub = cfg.get("subsample", {})
    emb = cfg.get("embed", {})
    missing = [key for key in ("corpus_tsv", "queries_tsv") if not sub.get(key)]
    if missing:
        raise SystemExit(
            f"{args.config}: subsample needs local {missing}; without them "
            "ir_datasets downloads the corpus"
        )
    if not emb.get("synthetic"):
        raise SystemExit(
            f"{args.config}: embed needs synthetic: true; the MiniLM encoders "
            "need the model's weights, which are not in the repository"
        )

    nc = subsample_msmarco.sample_corpus(
        sub.get("output_dir", "data/msmarco_subset"),
        sub.get("corpus_sample", 1_000_000),
        sub.get("seed", 42),
        sub["corpus_tsv"],
    )
    nq = subsample_msmarco.sample_queries(
        sub.get("output_dir", "data/msmarco_subset"),
        sub.get("query_sample", 1000),
        sub.get("seed", 42),
        sub["queries_tsv"],
    )
    print(f"subsampled {nc} passages, {nq} queries")

    return embed_msmarco.main([
        "--input-dir", emb.get("input_dir", "data/msmarco_subset"),
        "--output-dir", emb.get("output_dir", "data/msmarco_embeddings"),
        "--seed", str(emb.get("seed", 42)),
        "--synthetic",
        "--device", str(device),
    ])


if __name__ == "__main__":
    raise SystemExit(main())
