"""Generate a SIFT1M-shaped surrogate corpus as standard .fvecs files.

A distribution-matched stand-in for SIFT1M (the real corpus needs a
download) with the descriptor family's structural properties; results on
it are labelled synthetic, not real-SIFT numbers:

  * 128-d non-negative integer-valued rows (SIFT = quantized gradient
    histograms, values 0..~220);
  * heavy sparsity (~50% zeros in real SIFT) from ReLU-truncated mixture
    noise;
  * hierarchical cluster structure (visual-word neighbourhoods): Zipf-
    weighted parents -> children -> points, like real descriptor space;
  * near-constant row norms (SIFT is L2-normalised then scaled to 512
    before quantisation): generated rows are normalised to ~512 with a
    small spread, then rounded.

Writes {out}/sift_base.fvecs, {out}/sift_query.fvecs (the TEXMEX format
the ``sift1m`` loader parses) and the ``PROVENANCE.json`` marker that
labels the corpus a surrogate. A copy of the JAX package's
``scripts/make_sift1m_surrogate.py``: the same NumPy draws in the same
order, so the same arguments write the same bytes, sidecar included. Host
files only: no tensor is made, so there is no device to choose.

    python -m vectordb_retrieval_tpu_torch.scripts.make_sift1m_surrogate \
        [--n 1000000] [--queries 1024] [--out data/sift1m_synth] [--seed 20]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np


def write_fvecs(path: str, mat: np.ndarray) -> None:
    n, d = mat.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = mat.astype(np.float32).view(np.int32)
    out.tofile(path)


def gen_rows(rng, n, parents, children, probs, point_scale):
    d = children.shape[-1]
    assign = rng.choice(children.shape[0], size=n, p=probs)
    pts = children[assign] + point_scale * rng.standard_normal(
        (n, d), dtype=np.float32
    )
    # ReLU: SIFT histogram bins are non-negative and ~half are zero
    pts = np.maximum(pts, 0.0)
    # constant-norm geometry (L2-normalise, scale to 512, quantise)
    norms = np.linalg.norm(pts, axis=1, keepdims=True)
    pts = pts / np.maximum(norms, 1e-6) * 512.0
    pts *= rng.normal(1.0, 0.03, size=(n, 1)).astype(np.float32)
    return np.round(np.clip(pts, 0, 255)).astype(np.float32)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--out", default="data/sift1m_synth")
    ap.add_argument("--seed", type=int, default=20)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    d = 128
    n_parents, children_per = 256, 16
    # cluster centers in the positive orthant with sparse support
    parents = np.maximum(
        rng.standard_normal((n_parents, d), dtype=np.float32) + 0.3, 0.0
    )
    support = rng.random((n_parents, d)) < 0.55  # per-cluster active bins
    parents *= support
    children = (
        parents[:, None, :]
        + 0.45 * rng.standard_normal(
            (n_parents, children_per, d), dtype=np.float32
        )
    ).reshape(n_parents * children_per, d)
    ranks = np.arange(1, children.shape[0] + 1, dtype=np.float64)
    probs = ranks**-0.7
    probs /= probs.sum()

    os.makedirs(args.out, exist_ok=True)
    base_path = os.path.join(args.out, "sift_base.fvecs")
    chunk = 250_000
    with open(base_path, "wb") as f:
        for start in range(0, args.n, chunk):
            rows = gen_rows(
                rng, min(chunk, args.n - start), parents, children, probs,
                point_scale=0.6,
            )
            buf = np.empty((rows.shape[0], d + 1), dtype=np.int32)
            buf[:, 0] = d
            buf[:, 1:] = rows.view(np.int32)
            buf.tofile(f)
            print(f"base {start + rows.shape[0]}/{args.n}", flush=True)
    queries = gen_rows(
        rng, args.queries, parents, children, probs, point_scale=0.6
    )
    write_fvecs(os.path.join(args.out, "sift_query.fvecs"), queries)
    # provenance marker: data/datasets._load_sift1m labels any corpus with
    # this file (or a "synth" dir name) as SURROGATE in benchmark reports.
    # The same document as the JAX package's generator writes (its
    # "generator" names that script, whose draws these are), so a corpus
    # made by either is byte-identical
    with open(os.path.join(args.out, "PROVENANCE.json"), "w") as f:
        json.dump(
            {
                "surrogate": True,
                "surrogate_for": "SIFT1M (TEXMEX 128d)",
                "generator": "scripts/make_sift1m_surrogate.py",
                "n": args.n,
                "queries": args.queries,
            },
            f,
        )
    zf = float((queries == 0).mean())
    print(
        f"wrote {args.n} base + {args.queries} query rows to {args.out} "
        f"(zero fraction {zf:.2f}, mean norm "
        f"{np.linalg.norm(queries, axis=1).mean():.0f})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
