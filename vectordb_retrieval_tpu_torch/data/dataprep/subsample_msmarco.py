"""MS MARCO subsampler.

Streams the msmarco-passage corpus and dev queries, takes a seeded random
sample of row indices, and writes ``corpus.tsv`` / ``queries.tsv``. Reads
local TSV files (``--corpus-tsv`` / ``--queries-tsv``) where given, else
``ir_datasets`` (imported only then; it downloads). A copy of the JAX
package's ``data/dataprep/subsample_msmarco.py``: the same seeds give the
same samples, byte for byte. Host files only: no tensor is made, so there
is no device to choose.

    python -m vectordb_retrieval_tpu_torch.data.dataprep.subsample_msmarco \
        --output-dir data/msmarco_subset --corpus-tsv corpus.tsv \
        --queries-tsv queries.tsv
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Iterator, List, Optional, Tuple


def _sample_indices(total: int, sample: int, seed: int) -> set:
    rng = random.Random(seed)
    if sample >= total:
        return set(range(total))
    return set(rng.sample(range(total), sample))


def _write_sampled(
    rows: Iterator[Tuple[str, str]],
    keep: set,
    out_path: str,
) -> int:
    written = 0
    with open(out_path, "w", encoding="utf-8") as f:
        for idx, (doc_id, text) in enumerate(rows):
            if idx in keep:
                text = text.replace("\t", " ").replace("\n", " ")
                f.write(f"{doc_id}\t{text}\n")
                written += 1
    return written


def _iter_ir_dataset(name: str) -> Tuple[Iterator[Tuple[str, str]], int]:
    import ir_datasets

    ds = ir_datasets.load(name)
    if "queries" in name or name.endswith("/dev"):
        it = ((q.query_id, q.text) for q in ds.queries_iter())
        return it, ds.queries_count()
    it = ((d.doc_id, d.text) for d in ds.docs_iter())
    return it, ds.docs_count()


def _iter_tsv(path: str) -> Tuple[Iterator[Tuple[str, str]], int]:
    def gen():
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t", 1)
                if len(parts) == 2:
                    yield parts[0], parts[1]

    with open(path, "r", encoding="utf-8") as f:
        total = sum(1 for _ in f)
    return gen(), total


def sample_corpus(
    output_dir: str,
    corpus_sample: int = 1_000_000,
    seed: int = 42,
    corpus_tsv: str = "",
) -> int:
    os.makedirs(output_dir, exist_ok=True)
    if corpus_tsv:
        rows, total = _iter_tsv(corpus_tsv)
    else:
        rows, total = _iter_ir_dataset("msmarco-passage")
    keep = _sample_indices(total, corpus_sample, seed)
    return _write_sampled(rows, keep, os.path.join(output_dir, "corpus.tsv"))


def sample_queries(
    output_dir: str,
    query_sample: int = 1000,
    seed: int = 42,
    queries_tsv: str = "",
) -> int:
    os.makedirs(output_dir, exist_ok=True)
    if queries_tsv:
        rows, total = _iter_tsv(queries_tsv)
    else:
        rows, total = _iter_ir_dataset("msmarco-passage/dev")
    keep = _sample_indices(total, query_sample, seed ^ 0x9E)
    return _write_sampled(rows, keep, os.path.join(output_dir, "queries.tsv"))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Subsample MS MARCO")
    parser.add_argument("--output-dir", default="data/msmarco_subset")
    parser.add_argument("--corpus-sample", type=int, default=1_000_000)
    parser.add_argument("--query-sample", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--corpus-tsv", default="", help="local TSV fallback")
    parser.add_argument("--queries-tsv", default="", help="local TSV fallback")
    args = parser.parse_args(argv)
    nc = sample_corpus(
        args.output_dir, args.corpus_sample, args.seed, args.corpus_tsv
    )
    nq = sample_queries(
        args.output_dir, args.query_sample, args.seed, args.queries_tsv
    )
    print(f"wrote {nc} corpus rows, {nq} query rows to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
