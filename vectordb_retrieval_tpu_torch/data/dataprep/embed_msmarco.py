"""MS MARCO embedder.

Encodes ``corpus.tsv`` / ``queries.tsv`` into ``passage_embeddings.npy`` /
``query_embeddings.npy``, the id arrays and ``metadata.json``: the layout
the ``msmarco`` dataset loader reads (``data/datasets.py``).

Encoders, in order of preference:
  1. ``sentence-transformers`` (``all-MiniLM-L6-v2``), where installed;
  2. ``transformers`` ``AutoModel`` of the same model, mean-pooled;
  3. ``--synthetic``: seeded clustered unit vectors, for pipeline tests on
     hosts without the model's weights. The same NumPy draws in the same
     order as the JAX package's ``data/dataprep/embed_msmarco.py``, so the
     same seed gives bit-identical vectors.

The model encoders run on ``--device`` (default: the CUDA card, failing
without one; ``cpu`` runs on the host) and need the model's weights.

    python -m vectordb_retrieval_tpu_torch.data.dataprep.embed_msmarco \
        --input-dir data/msmarco_subset --output-dir data/msmarco_embeddings \
        [--synthetic] [--seed 42] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.data.tfidf import read_tsv
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device

MODEL_NAME = "sentence-transformers/all-MiniLM-L6-v2"
DIM = 384
BATCH = 256


def _encode_sentence_transformers(texts: List[str], device: torch.device) -> np.ndarray:
    from sentence_transformers import SentenceTransformer

    model = SentenceTransformer(MODEL_NAME, device=str(device))
    return np.asarray(
        model.encode(texts, batch_size=BATCH, show_progress_bar=True),
        dtype=np.float32,
    )


def _encode_transformers(texts: List[str], device: torch.device) -> np.ndarray:
    from transformers import AutoModel, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(MODEL_NAME)
    model = AutoModel.from_pretrained(MODEL_NAME).to(device)
    model.eval()
    out = []
    with torch.no_grad():
        for start in range(0, len(texts), BATCH):
            batch = texts[start : start + BATCH]
            enc = tok(
                batch, padding=True, truncation=True, max_length=256,
                return_tensors="pt",
            ).to(device)
            hidden = model(**enc).last_hidden_state  # [B, T, H]
            mask = enc["attention_mask"].unsqueeze(-1).float()
            pooled = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
            out.append(pooled.cpu().numpy().astype(np.float32))
    return np.concatenate(out, axis=0)


def _encode_synthetic(texts: List[str], seed: int) -> np.ndarray:
    """Clustered low-intrinsic-dimension unit vectors.

    Uniform high-d sphere points make nearest-neighbour structure
    degenerate (all distances concentrate), which is unrepresentative of
    real sentence embeddings; a gaussian mixture on a low-rank subspace
    reproduces the cluster/manifold structure ANN indexes exploit.
    """
    rng = np.random.default_rng(seed)
    n = len(texts)
    n_clusters = max(8, min(1024, n // 64))
    rank = 64  # intrinsic dimensionality
    basis = rng.standard_normal((rank, DIM)).astype(np.float32)
    centers_z = rng.standard_normal((n_clusters, rank)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    z = centers_z[assign] + 0.35 * rng.standard_normal((n, rank)).astype(
        np.float32
    )
    x = z @ basis + 0.05 * rng.standard_normal((n, DIM)).astype(np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def encode(
    texts: List[str], synthetic: bool = False, seed: int = 0, device: DeviceLike = None
) -> np.ndarray:
    """``[len(texts), 384]`` f32 embeddings: synthetic ones from ``seed``,
    else the model's on ``device``."""
    if synthetic:
        return _encode_synthetic(texts, seed)
    dev = resolve_device(device)
    try:
        return _encode_sentence_transformers(texts, dev)
    except ImportError:
        return _encode_transformers(texts, dev)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Embed MS MARCO subset")
    parser.add_argument("--input-dir", default="data/msmarco_subset")
    parser.add_argument("--output-dir", default="data/msmarco_embeddings")
    parser.add_argument(
        "--synthetic", action="store_true",
        help="seeded random unit embeddings (no model download needed)",
    )
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.output_dir, exist_ok=True)
    passage_ids, passages = read_tsv(os.path.join(args.input_dir, "corpus.tsv"))
    query_ids, queries = read_tsv(os.path.join(args.input_dir, "queries.tsv"))

    p_emb = encode(passages, synthetic=args.synthetic, seed=args.seed, device=device)
    q_emb = encode(queries, synthetic=args.synthetic, seed=args.seed ^ 0xE, device=device)

    np.save(os.path.join(args.output_dir, "passage_embeddings.npy"), p_emb)
    np.save(os.path.join(args.output_dir, "query_embeddings.npy"), q_emb)
    np.save(
        os.path.join(args.output_dir, "passage_ids.npy"),
        np.asarray(passage_ids),
    )
    np.save(os.path.join(args.output_dir, "query_ids.npy"), np.asarray(query_ids))
    with open(os.path.join(args.output_dir, "metadata.json"), "w") as f:
        json.dump(
            {
                "model": "synthetic" if args.synthetic else MODEL_NAME,
                "dimensions": int(p_emb.shape[1]),
                "n_passages": len(passage_ids),
                "n_queries": len(query_ids),
                "normalized": bool(args.synthetic),
            },
            f,
            indent=2,
        )
    print(
        f"wrote {p_emb.shape} passages, {q_emb.shape} queries to "
        f"{args.output_dir}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
