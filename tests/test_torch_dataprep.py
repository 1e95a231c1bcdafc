"""The port's MS MARCO dataprep against the JAX package's, on the CPU: the
sampled TSVs byte for byte, the synthetic embeddings bit for bit, and the
result read by the port's ``msmarco`` loader (``device="cpu"``)."""

import json
import os

import numpy as np
import pytest
import torch

from vectordb_retrieval_tpu.data.dataprep import embed_msmarco as jembed
from vectordb_retrieval_tpu.data.dataprep import subsample_msmarco as jsub
from vectordb_retrieval_tpu_torch.data import tfidf
from vectordb_retrieval_tpu_torch.data.dataprep import embed_msmarco, subsample_msmarco
from vectordb_retrieval_tpu_torch.data.datasets import Dataset

torch.set_num_threads(2)


def _write_tsv(path, n, prefix):
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{prefix}{i}\tsome text number {i}\twith a tab\n")
        f.write("a line without a tab\n")


def _raw(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    _write_tsv(str(raw / "corpus_full.tsv"), 200, "d")
    _write_tsv(str(raw / "queries_full.tsv"), 50, "q")
    return raw


@pytest.mark.parametrize("seed", [1, 42])
def test_samples_are_byte_identical_to_jax(tmp_path, seed):
    raw = _raw(tmp_path)
    counts = {}
    for name, mod in (("port", subsample_msmarco), ("jax", jsub)):
        out = str(tmp_path / name)
        counts[name] = (
            mod.sample_corpus(out, corpus_sample=100, seed=seed,
                              corpus_tsv=str(raw / "corpus_full.tsv")),
            mod.sample_queries(out, query_sample=20, seed=seed,
                               queries_tsv=str(raw / "queries_full.tsv")),
        )
    # the sample is drawn over every line, the tab-less one included, which
    # yields no row: both packages write the same rows
    assert counts["port"] == counts["jax"]
    assert 99 <= counts["port"][0] <= 100 and 19 <= counts["port"][1] <= 20
    for f in ("corpus.tsv", "queries.tsv"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    # tabs inside a text were flattened: two fields a line
    ids, texts = tfidf.read_tsv(str(tmp_path / "port" / "corpus.tsv"))
    assert len(ids) == counts["port"][0] and all("\t" not in t for t in texts)


def test_sample_larger_than_the_file_keeps_every_row(tmp_path):
    raw = _raw(tmp_path)
    n = subsample_msmarco.sample_queries(str(tmp_path / "s"), query_sample=1000, seed=3,
                                         queries_tsv=str(raw / "queries_full.tsv"))
    assert n == 50  # every row; the tab-less line is none


@pytest.mark.parametrize("n", [5, 100, 700])
def test_synthetic_embeddings_bit_identical(n):
    texts = [f"t{i}" for i in range(n)]
    got = embed_msmarco.encode(texts, synthetic=True, seed=9)
    want = jembed.encode(texts, synthetic=True, seed=9)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, 384)
    np.testing.assert_array_equal(got, want)


def test_model_encoders_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        embed_msmarco.encode(["text"], synthetic=False)


def test_pipeline_through_the_port_loads_in_the_msmarco_loader(tmp_path):
    raw = _raw(tmp_path)
    subset = str(tmp_path / "subset")
    assert subsample_msmarco.main([
        "--output-dir", subset, "--corpus-sample", "100", "--query-sample", "20",
        "--seed", "1", "--corpus-tsv", str(raw / "corpus_full.tsv"),
        "--queries-tsv", str(raw / "queries_full.tsv")]) == 0
    emb, jemb = str(tmp_path / "emb"), str(tmp_path / "jemb")
    assert embed_msmarco.main(["--input-dir", subset, "--output-dir", emb, "--synthetic",
                               "--device", "cpu"]) == 0
    import sys

    argv = sys.argv
    sys.argv = ["x", "--input-dir", subset, "--output-dir", jemb, "--synthetic"]
    try:
        jembed.main()
    finally:
        sys.argv = argv
    for f in ("passage_embeddings.npy", "query_embeddings.npy", "passage_ids.npy",
              "query_ids.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(emb, f)),
                                      np.load(os.path.join(jemb, f)))
    with open(os.path.join(emb, "metadata.json")) as f, \
            open(os.path.join(jemb, "metadata.json")) as g:
        meta = json.load(f)
        assert meta == json.load(g)
    assert meta["n_passages"] == 100 and meta["n_queries"] == 20

    ds = Dataset(
        "msmarco",
        data_dir=str(tmp_path / "data"),
        options={"embedded_dataset_dir": emb, "base_limit": 80, "query_limit": 10,
                 "ground_truth_k": 5, "use_cache": False},
        device="cpu",
    ).load()
    assert ds.train_vectors.shape == (80, 384)
    assert ds.test_vectors.shape == (10, 384)
    assert ds.ground_truth.shape == (10, 5)
    assert ds.metric == "cosine"
    np.testing.assert_array_equal(ds.train_vectors,
                                  np.load(os.path.join(emb, "passage_embeddings.npy"))[:80])
