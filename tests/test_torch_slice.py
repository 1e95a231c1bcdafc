"""The port's slices, end to end against the JAX package: ground truth
(dense and blockmin paths), the BenchmarkRunner on the smoke config's
exact, ivf_flat and ivf_sq8 rows, and search over a JAX-built index carried
across with ``artifact_from_numpy``. Everything runs on the CPU
(``device="cpu"``).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from vectordb_retrieval_tpu.bench.runner import BenchmarkRunner as JaxRunner
from vectordb_retrieval_tpu.data import datasets as jdata
from vectordb_retrieval_tpu.models.flat import (
    BruteForceIndexer as JaxIndexer,
    LinearSearcher as JaxSearcher,
)
from vectordb_retrieval_tpu_torch.bench.experiment import ExperimentRunner
from vectordb_retrieval_tpu_torch.bench.config import ExperimentConfig
from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner
from vectordb_retrieval_tpu_torch.data import datasets as tdata
from vectordb_retrieval_tpu_torch.data.storage import corpus_to_device
from vectordb_retrieval_tpu_torch.models import (
    ExactSearch,
    artifact_from_numpy,
    get_algorithm_instance,
)
from vectordb_retrieval_tpu_torch.models.base import IndexArtifact
from vectordb_retrieval_tpu_torch.models.flat import BruteForceIndexer, LinearSearcher

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOFLINE_KEYS = {
    "kernel_flops_per_batch", "achieved_tflops", "kernel_bytes_per_batch",
    "achieved_gbps",
}


def _dist(train, queries, ids, metric):
    x, q = train.astype(np.float64), queries.astype(np.float64)
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    v = x[ids]  # [B, k, d]
    if metric == "l2":
        return ((v - q[:, None, :]) ** 2).sum(-1)
    return -(v * q[:, None, :]).sum(-1)


def assert_gt_equal_modulo_ties(got, want, train, queries, metric):
    """Rank by rank the two id lists point at the same distances (to f32
    rounding); ids differ only where distances tie."""
    assert got.shape == want.shape and got.dtype == np.int64
    dg = _dist(train, queries, got, metric)
    dw = _dist(train, queries, want, metric)
    scale = np.abs(dw).max()
    np.testing.assert_allclose(dg, dw, rtol=0, atol=1e-5 * scale)
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("n,d", [(2000, 32), (40_000, 8)])  # dense, blockmin
def test_compute_ground_truth_matches_jax(rng, metric, n, d):
    train = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((24, d)).astype(np.float32)
    want = jdata.compute_ground_truth(train, queries, 20, metric)
    got = tdata.compute_ground_truth(train, queries, 20, metric, device="cpu")
    assert_gt_equal_modulo_ties(got, want, train, queries, metric)


def _smoke_exact_config(tmp_path, out_name, rows=("exact",)):
    with open(os.path.join(REPO, "configs", "benchmark_config_smoke.yaml")) as f:
        cfg = yaml.safe_load(f)
    picked = {name: cfg["algorithms"][name] for name in rows}
    cfg["algorithms"] = picked
    cfg["indexers"] = {r["indexer_ref"]: cfg["indexers"][r["indexer_ref"]]
                       for r in picked.values()}
    cfg["searchers"] = {r["searcher_ref"]: cfg["searchers"][r["searcher_ref"]]
                        for r in picked.values()}
    cfg["output_dir"] = str(tmp_path / out_name)
    cfg["data_dir"] = str(tmp_path / "data")
    path = tmp_path / f"{out_name}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path), cfg


def test_benchmark_runner_matches_jax_on_smoke_exact_row(tmp_path):
    path_j, cfg = _smoke_exact_config(tmp_path, "jax")
    path_t, _ = _smoke_exact_config(tmp_path, "torch")
    res_j = JaxRunner(path_j).run()
    runner = BenchmarkRunner(path_t, device="cpu")
    res_t = runner.run()

    row_j, row_t = res_j["random"]["exact"], res_t["random"]["exact"]
    assert "error" not in row_t, row_t
    assert row_t["recall@10"] == row_j["recall@10"] == 1.0
    assert set(row_t) == set(row_j) and ROOFLINE_KEYS <= set(row_t)
    assert set(res_t["random"]) == set(res_j["random"])

    ds = cfg["datasets"][0]
    opts = dict(ds["dataset_options"], metric=ds["metric"])
    dj = jdata.Dataset("random", str(tmp_path / "data"), opts).load()
    dt = tdata.Dataset("random", str(tmp_path / "data"), opts, device="cpu").load()
    np.testing.assert_array_equal(dt.train_vectors, dj.train_vectors)
    np.testing.assert_array_equal(dt.test_vectors, dj.test_vectors)
    assert_gt_equal_modulo_ties(dt.ground_truth, dj.ground_truth,
                                dt.train_vectors, dt.test_vectors, "l2")

    out = runner.output_dir
    for name in ("all_results.json", "benchmark_summary.md", "one-page-summary.md",
                 "qps_recall_random.svg", os.path.join("random", "exact_results.json")):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "all_results.json")) as f:
        assert json.load(f)["random"]["exact"]["recall"] == 1.0
    with open(os.path.join(out, "benchmark_summary.md")) as f:
        summary = f.read()
    assert "| exact | 1.0000 |" in summary and "v5e" not in summary


def test_benchmark_runner_matches_jax_on_smoke_ivf_rows(tmp_path):
    """The smoke config's ivf_flat (IVF16,Flat, bf16 lists) and ivf_sq8
    (IVF16,SQ8) rows, nprobe 8 of 16 lists, through both runners. The
    builds differ only in their random draws (k-means init and sample), so
    recall@10 is held within 0.05 of JAX's; observed on the CPU: ivf_flat
    0.8578 vs 0.8563, ivf_sq8 0.8547 vs 0.8578 (port vs JAX), a gap of
    0.0016-0.0031."""
    rows = ("ivf_flat", "ivf_sq8")
    path_j, _ = _smoke_exact_config(tmp_path, "jax", rows)
    path_t, _ = _smoke_exact_config(tmp_path, "torch", rows)
    res_j = JaxRunner(path_j).run()["random"]
    res_t = BenchmarkRunner(path_t, device="cpu").run()["random"]
    assert set(res_t) == set(res_j)
    for name in rows:
        row_j, row_t = res_j[name], res_t[name]
        assert "error" not in row_t, row_t
        assert set(row_t) == set(row_j) and ROOFLINE_KEYS <= set(row_t)
        assert abs(row_t["recall@10"] - row_j["recall@10"]) <= 0.05
        assert row_t["recall@10"] > 0.8
        assert row_t["index_memory_mb"] > 0 and row_t["qps"] > 0


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_artifact_from_numpy_carries_jax_index(rng, metric):
    train = rng.standard_normal((1500, 16)).astype(np.float32)
    queries = rng.standard_normal((10, 16)).astype(np.float32)
    jart = JaxIndexer(metric=metric).build(train, 16)
    art = artifact_from_numpy(
        jart.kind, {k: np.asarray(v) for k, v in jart.data.items()},
        jart.metadata, device="cpu",
    )
    assert isinstance(art, IndexArtifact) and art.kind == "flat"
    assert set(art.data) == set(jart.data)
    assert art.device_nbytes() == jart.device_nbytes()
    assert art.metadata == jart.metadata

    searcher = LinearSearcher(metric=metric, device="cpu")
    searcher.attach(art)
    got_d, got_i = searcher.batch_search(queries, 12)
    js = JaxSearcher(metric=metric)
    js.attach(jart)
    want_d, want_i = js.batch_search(queries, 12)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-6)
    assert (got_i == want_i).mean() > 0.99

    built = BruteForceIndexer(metric=metric, device="cpu").build(train, 16)
    assert built.metadata == jart.metadata
    for key in jart.data:
        np.testing.assert_allclose(built.data[key].numpy(), np.asarray(jart.data[key]),
                                   rtol=1e-6, atol=1e-6)


def test_exact_search_algorithm_pads_to_k(rng):
    train = rng.standard_normal((6, 4)).astype(np.float32)
    algo = ExactSearch(4, metric="l2", device="cpu")
    algo.build_index(train)
    d, i = algo.batch_search(train[:2], 9)
    assert d.shape == i.shape == (2, 9)
    assert (i[:, 6:] == -1).all() and np.isinf(d[:, 6:]).all()
    assert (i[:, 0] == [0, 1]).all()
    assert algo.get_operations()["ndis"] == 12
    assert algo.index_memory_bytes() == 6 * 4 * 4 + 6 * 4


@pytest.mark.parametrize("key", ["IVF8,Flat", "IVF8,SQ8", "SQ8"])
def test_approximate_search_matches_jax(rng, key):
    from vectordb_retrieval_tpu.models import get_algorithm_instance as jax_get

    train = rng.standard_normal((1200, 16)).astype(np.float32)
    queries = rng.standard_normal((7, 16)).astype(np.float32)
    algo = get_algorithm_instance("approx", 16, index_type=key, nprobe=4, device="cpu")
    jalgo = jax_get("approx", 16, index_type=key, nprobe=4)
    assert algo.get_parameters() == jalgo.get_parameters()
    algo.build_index(train)
    jalgo.build_index(train)
    d, i = algo.batch_search(queries, 5)
    jd, ji = jalgo.batch_search(queries, 5)
    assert d.shape == i.shape == jd.shape == (7, 5) and i.dtype == np.int64
    # builds differ in their draws: most, not all, ids are shared
    shared = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(i, ji)])
    assert shared >= 0.6
    assert algo.get_operations()["ndis"] > 0


@pytest.mark.parametrize("b,buckets", [(5, ()), (8, ()), (3, (4, 16)), (9, (4, 16))])
def test_pad_batch_matches_jax(b, buckets):
    from vectordb_retrieval_tpu.models.base import pad_batch as jax_pad_batch
    from vectordb_retrieval_tpu_torch.models.base import pad_batch

    q = np.arange(b * 3, dtype=np.float32).reshape(b, 3)
    got, n = pad_batch(q, buckets)
    want, wn = jax_pad_batch(q, buckets)
    assert n == wn == b
    np.testing.assert_array_equal(got, want)


def test_timed_blocking_returns_host_arrays():
    from vectordb_retrieval_tpu_torch.models.base import timed_blocking

    (a, (b,)), secs = timed_blocking(lambda: (torch.ones(3), [torch.zeros(2)]))
    assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
    assert a.sum() == 3 and secs >= 0


def test_unknown_algorithm_type_raises_like_jax():
    from vectordb_retrieval_tpu.models import get_algorithm_instance as jax_get

    # a config's algorithm name, not a registry type: both registries reject it
    with pytest.raises(ValueError, match="unknown algorithm type 'faiss_lsh'"):
        get_algorithm_instance("faiss_lsh", 8, device="cpu")
    with pytest.raises(ValueError, match="unknown algorithm type 'faiss_lsh'"):
        jax_get("faiss_lsh", 8)
    with pytest.raises(ValueError, match="unknown algorithm type 'nope'; known: ") as t:
        get_algorithm_instance("nope", 8, device="cpu")
    with pytest.raises(ValueError, match="unknown algorithm type 'nope'; known: "):
        jax_get("nope", 8)
    assert "'exact'" in str(t.value)


def _sharded_search(artifact, searcher, x, k=3):
    """A stacked row-sharded artifact attached (placed over 4 CPU
    devices) and searched: each row of ``x`` finds itself first."""
    searcher.attach(artifact)
    assert artifact.mesh.shape == {"db": 4}
    d, i = searcher.batch_search(x, k)
    np.testing.assert_array_equal(i[:, 0], np.arange(x.shape[0]))
    assert np.allclose(d[:, 0], 0.0, atol=1e-4)


def _not_ported(kind, tmp_path):
    if kind == "memmap":
        mm = np.memmap(tmp_path / "m.bin", dtype=np.float32, mode="w+", shape=(4, 2))
        mm[:] = np.arange(8, dtype=np.float32).reshape(4, 2)
        mm.flush()
        got = corpus_to_device(mm, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(mm))
    elif kind == "dataset":
        # msmarco's default memmap corpus: its ground truth streams
        np.save(tmp_path / "passage_embeddings.npy", np.eye(8, 4, dtype=np.float32) + 0.1)
        np.save(tmp_path / "query_embeddings.npy", np.ones((2, 4), np.float32))
        ds = tdata.Dataset("msmarco", str(tmp_path), {"embedded_dataset_dir": str(tmp_path)},
                           device="cpu").load()
        assert isinstance(ds.train_vectors, np.memmap) and ds.ground_truth.shape == (2, 8)
    elif kind == "storage_memmap":
        ds = tdata.Dataset("random", str(tmp_path), {"storage": "memmap", "train_size": 300,
                                                     "test_size": 3, "ground_truth_k": 4},
                           device="cpu").load()
        assert isinstance(ds.train_vectors, np.memmap) and ds.ground_truth.shape == (3, 4)
    else:
        # the row-sharded kinds of ROADMAP item 10: a stub that raised, now
        # stacked arrays as persisted, placed and searched on attach
        from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher
        from vectordb_retrieval_tpu_torch.parallel import (
            build_sharded_graph,
            build_sharded_ivf_coded,
            make_mesh,
        )

        x = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
        mesh = make_mesh(devices=["cpu"] * 4)
        meta = {"metric": "l2", "dimension": 8, "n_vectors": 64}
        if kind == "sharded":
            art = IndexArtifact("flat_sharded", {"vectors": torch.as_tensor(x)},
                                dict(meta, n_devices=4))
            return _sharded_search(art, LinearSearcher(device=["cpu"] * 4), x)
        if kind == "pq_index_key":
            data, build = build_sharded_ivf_coded(x, mesh, nlist=2, coding="pq", m=8, seed=1)
        else:
            data, build = build_sharded_graph(x, mesh, M=4, seed=1)
        build.pop("build_seconds")
        art = IndexArtifact(kind="ivf_pq_sharded" if kind == "pq_index_key" else "graph_sharded",
                            data={k: torch.as_tensor(np.asarray(v)) for k, v in data.items()},
                            metadata=dict(meta, nprobe=8, efSearch=32, **build))
        _sharded_search(art, ANNSearcher(device=["cpu"] * 4), x)


@pytest.mark.parametrize(
    "kind",
    ["memmap", "dataset", "storage_memmap", "sharded", "pq_index_key",
     "graph_artifact"],
)
def test_not_yet_ported_paths_raise(kind, tmp_path):
    """Paths that were stubs raising ``NotImplementedError``: the
    out-of-core kinds (ROADMAP item 9b) and the row-sharded kinds (item
    10) now run and check their result."""
    _not_ported(kind, tmp_path)


def _persistence_row(tmp_path, persistence):
    cfg = ExperimentConfig(
        dataset="random", data_dir=str(tmp_path / "data"),
        dataset_options={"dimensions": 8, "train_size": 64, "test_size": 8,
                         "ground_truth_k": 5, "use_cache": False},
        n_queries=8, topk=5, query_batch_size=3, repeat=2,
        algorithms={"exact": {"type": "ExactSearch", "metric": "l2",
                              "persistence": persistence}},
    )
    res = ExperimentRunner(cfg, output_dir=str(tmp_path / "out"), device="cpu").run()
    return res["exact"]


def test_persistence_build_and_retrieve_runs_without_saving(tmp_path):
    """A build_and_retrieve mode with persistence not enabled: the row is
    built and searched as usual, and nothing is written."""
    row = _persistence_row(tmp_path, {"enabled": False, "mode": "build_and_retrieve"})
    assert "error" not in row, row
    assert row["recall"] == 1.0
    assert row["persistence_mode"] is None and row["persist_dir"] is None
    assert row["config_hash"] is None
    assert row["operations_per_query"] == 64
    assert not os.path.exists(tmp_path / "out" / "artifacts")


def test_persistence_build_and_retrieve_saves_and_searches(tmp_path):
    """build_and_retrieve with persistence on: the row is searched as
    usual, and the artifact is also saved."""
    row = _persistence_row(tmp_path, {"enabled": True})
    assert "error" not in row, row
    assert row["recall"] == 1.0
    assert row["persistence_mode"] == "build_and_retrieve"
    assert row["persist_dir"] == str(tmp_path / "out" / "artifacts" / "exact")
    assert row["index_source"] == "built" and row["config_hash"]
    assert row["operations_per_query"] == 64
    assert os.path.exists(tmp_path / "out" / "artifacts" / "exact" / "WRITE_COMPLETE")


def test_dataset_cache_roundtrip_uses_own_tag(tmp_path):
    opts = {"dimensions": 8, "train_size": 50, "test_size": 5, "ground_truth_k": 4}
    first = tdata.Dataset("random", str(tmp_path), copy.deepcopy(opts), device="cpu").load()
    again = tdata.Dataset("random", str(tmp_path), copy.deepcopy(opts), device="cpu")
    assert again._load_cache()
    np.testing.assert_array_equal(again.ground_truth, first.ground_truth)
    assert again.metadata["gt_method"] == tdata.GROUND_TRUTH_METHOD
    assert tdata.GROUND_TRUTH_METHOD != jdata.GROUND_TRUTH_METHOD
    jds = jdata.Dataset("random", str(tmp_path), copy.deepcopy(opts))
    assert jds._cache_path() != again._cache_path()
