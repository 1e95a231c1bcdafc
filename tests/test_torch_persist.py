"""Artifacts cross between the packages through models/persist.py.

JAX-built IVF-Flat / IVF-SQ8 / SQ8 and graph (block mode, and node mode
without and with a bf16 or SQ8 neighbour table) artifacts saved by the JAX
package are loaded and searched by the port, and the port's own builds are
loaded and searched by the JAX package: ids must equal the other side's as
sorted sets per query (tie-free random or clustered data). The manifest checks fire alike, and
the port's ExperimentRunner runs ``build_only`` then ``retrieve_only``.
Everything runs on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from vectordb_retrieval_tpu.models import persist as jpersist
from vectordb_retrieval_tpu.models.factory import (
    ANNSearcher as JaxSearcher,
    FactoryIndexer as JaxIndexer,
)
from vectordb_retrieval_tpu.models.graph import GraphIndexer as JaxGraphIndexer
from vectordb_retrieval_tpu_torch.bench import experiment as texp
from vectordb_retrieval_tpu_torch.bench.config import ExperimentConfig
from vectordb_retrieval_tpu_torch.models import persist as tpersist
from vectordb_retrieval_tpu_torch.models.base import IndexArtifact
from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher, FactoryIndexer
from vectordb_retrieval_tpu_torch.models.graph import GraphIndexer

torch.set_num_threads(2)
K = 10

CASES = [
    ("IVF24,Flat", {}),
    ("IVF24,Flat", {"list_dtype": "f32"}),
    ("IVF24,Flat", {"exact_rescore": True}),
    ("IVF24,SQ8", {}),
    ("SQ8", {}),
]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    return (rng.standard_normal((4000, 32)).astype(np.float32),
            rng.standard_normal((40, 32)).astype(np.float32))


def _same_ids(a, b):
    np.testing.assert_array_equal(np.sort(a, 1), np.sort(b, 1))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("key,opts", CASES)
def test_jax_built_artifact_searches_alike_in_the_port(tmp_path, data, key, opts, metric):
    x, q = data
    jart = JaxIndexer(metric=metric, index_key=key, nprobe=5, **opts).build(x, 32)
    path = str(tmp_path / "jax_art")
    jpersist.save_artifact(jart, path, {"config_hash": "h"})
    with open(os.path.join(path, jpersist.MANIFEST)) as f:
        keys = json.load(f)["array_keys"]
    assert ("list_vecs.bf16" in keys) == (key.endswith("Flat") and not opts.get("list_dtype"))

    art = tpersist.load_artifact(path, {"config_hash": "h"}, device="cpu")
    assert art.kind == jart.kind and art.metadata == jart.metadata
    assert set(art.data) == set(jart.data)
    for k_, v in jart.data.items():
        got = art.data[k_]
        if got.dtype == torch.bfloat16:
            assert str(v.dtype) == "bfloat16"
            got = got.float()
        np.testing.assert_array_equal(got.numpy(), np.asarray(v).astype(got.numpy().dtype))
    assert art.device_nbytes() == jart.device_nbytes()

    js = JaxSearcher(metric=metric, nprobe=5)
    js.attach(jart)
    want_d, want_i = js.batch_search(q, K)
    ts = ANNSearcher(metric=metric, nprobe=5, device="cpu")
    ts.attach(art)
    got_d, got_i = ts.batch_search(q, K)
    _same_ids(got_i, want_i)
    np.testing.assert_allclose(np.sort(got_d, 1), np.sort(want_d, 1),
                               rtol=1e-5, atol=1e-5 * np.abs(want_d).max())


@pytest.mark.parametrize("key,opts", CASES)
def test_port_built_artifact_searches_alike_in_jax(tmp_path, data, key, opts):
    x, q = data
    art = FactoryIndexer(index_key=key, nprobe=5, device="cpu", **opts).build(x, 32)
    ts = ANNSearcher(nprobe=5, device="cpu")
    ts.attach(art)
    got_d, got_i = ts.batch_search(q, K)

    path = str(tmp_path / "torch_art")
    tpersist.save_artifact(art, path, {"dataset_fingerprint": "f"})
    jart = jpersist.load_artifact(path, {"dataset_fingerprint": "f"})
    assert jart.kind == art.kind and jart.metadata == art.metadata
    if "list_vecs" in art.data:
        want_dtype = "bfloat16" if art.data["list_vecs"].dtype == torch.bfloat16 else "float32"
        assert str(jart.data["list_vecs"].dtype) == want_dtype
    js = JaxSearcher(nprobe=5)
    js.attach(jart)
    want_d, want_i = js.batch_search(q, K)
    _same_ids(got_i, want_i)
    # and back into the port: a round trip changes no bit
    again = tpersist.load_artifact(path, device="cpu")
    for k_, v in art.data.items():
        assert again.data[k_].dtype == v.dtype and torch.equal(again.data[k_], v)


# graph artifacts: (indexer knobs, searcher efSearch); block mode at 16-row
# blocks so its beam runs two waves
GRAPH_CASES = {
    "block": ({"M": 8, "mode": "block", "block_size": 16}, 8),
    "node": ({"M": 8, "mode": "node", "nbr_table": "off"}, 40),
    "node_bf16": ({"M": 8, "mode": "node", "nbr_table": "on", "nbr_table_dtype": "bf16"}, 40),
    "node_int8": ({"M": 8, "mode": "node", "nbr_table": "on", "nbr_table_dtype": "int8"}, 40),
}


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(22)
    centers = rng.standard_normal((30, 32)).astype(np.float32) * 1.5
    x = centers[rng.integers(0, 30, 3000)] + 0.6 * rng.standard_normal((3000, 32))
    q = x[:24] + 0.3 * rng.standard_normal((24, 32))
    return x.astype(np.float32), q.astype(np.float32)


def _graph_keys(case):
    if case == "block":
        return {"entries", "entry_block", "slot_ids", "list_vecs", "list_sqnorms",
                "entry_adj", "list_mu"}
    keys = {"vectors", "sqnorms", "adjacency", "entry_ids"}
    if case != "node":
        keys |= {"nbr_vecs", "nbr_sqn"}
    if case == "node_int8":
        keys |= {"nbr_vmin", "nbr_step"}
    return keys


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_jax_built_graph_artifact_searches_alike_in_the_port(tmp_path, clustered, case, metric):
    x, q = clustered
    knobs, ef = GRAPH_CASES[case]
    jart = JaxGraphIndexer(metric=metric, **knobs).build(x, 32)
    path = str(tmp_path / "jax_graph")
    jpersist.save_artifact(jart, path)
    art = tpersist.load_artifact(path, device="cpu")
    assert art.kind == "graph" and art.metadata == jart.metadata
    assert set(art.data) == set(jart.data) == _graph_keys(case)
    if case == "block":
        assert art.data["list_vecs"].dtype == torch.bfloat16
    js = JaxSearcher(metric=metric, efSearch=ef)
    js.attach(jart)
    want_d, want_i = js.batch_search(q, K)
    ts = ANNSearcher(metric=metric, efSearch=ef, device="cpu")
    ts.attach(art)
    got_d, got_i = ts.batch_search(q, K)
    _same_ids(got_i, want_i)
    np.testing.assert_allclose(np.sort(got_d, 1), np.sort(want_d, 1),
                               rtol=0, atol=1e-5 * np.abs(want_d).max())


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_port_built_graph_artifact_searches_alike_in_jax(tmp_path, clustered, case):
    x, q = clustered
    knobs, ef = GRAPH_CASES[case]
    art = GraphIndexer(device="cpu", **knobs).build(x, 32)
    assert set(art.data) == _graph_keys(case)
    for key in ("slot_ids", "entry_block", "entry_adj", "adjacency", "entry_ids"):
        if key in art.data:  # ids stored as the JAX package stores them
            assert art.data[key].dtype == torch.int32
    ts = ANNSearcher(efSearch=ef, device="cpu")
    ts.attach(art)
    got_d, got_i = ts.batch_search(q, K)
    path = str(tmp_path / "torch_graph")
    tpersist.save_artifact(art, path)
    jart = jpersist.load_artifact(path)
    assert jart.kind == "graph" and jart.metadata == art.metadata
    js = JaxSearcher(efSearch=ef)
    js.attach(jart)
    want_d, want_i = js.batch_search(q, K)
    _same_ids(got_i, want_i)
    again = tpersist.load_artifact(path, device="cpu")
    for k_, v in art.data.items():
        assert again.data[k_].dtype == v.dtype and torch.equal(again.data[k_], v)


def _saved(tmp_path):
    art = IndexArtifact(
        "flat", {"vectors": torch.ones(3, 2), "nested": {"v": torch.zeros(2).to(torch.bfloat16)}},
        {"metric": "l2"},
    )
    path = str(tmp_path / "a")
    tpersist.save_artifact(art, path, {"dataset_fingerprint": "fp", "config_hash": "ch"})
    return path


@pytest.mark.parametrize(
    "fault,match",
    [
        ("sentinel", "incomplete"),
        ("fingerprint", "dataset_fingerprint mismatch"),
        ("config_hash", "config_hash mismatch"),
        ("schema", "schema_version"),
        ("kind", "kind"),
        ("missing_dir", None),
    ],
)
def test_manifest_validation_fires_like_jax(tmp_path, fault, match):
    path = _saved(tmp_path)
    ctx = {}
    if fault == "sentinel":
        os.remove(os.path.join(path, tpersist.SENTINEL))
    elif fault == "fingerprint":
        ctx = {"dataset_fingerprint": "other"}
    elif fault == "config_hash":
        ctx = {"config_hash": "other"}
    elif fault == "schema":
        mpath = os.path.join(path, tpersist.MANIFEST)
        with open(mpath) as f:
            m = json.load(f)
        m["schema_version"] = 99
        with open(mpath, "w") as f:
            json.dump(m, f)
    elif fault == "kind":
        ctx = {"kind": "ivf_flat"}
    elif fault == "missing_dir":
        path = str(tmp_path / "nowhere")
    exc = FileNotFoundError if fault == "missing_dir" else ValueError
    with pytest.raises(exc, match=match) as t:
        tpersist.load_artifact(path, ctx, device="cpu")
    with pytest.raises(exc) as j:
        jpersist.load_artifact(path, ctx)
    assert str(t.value) == str(j.value)


def test_nested_keys_and_bf16_leaves_round_trip(tmp_path):
    path = _saved(tmp_path)
    with np.load(os.path.join(path, tpersist.ARRAYS)) as z:
        assert sorted(z.files) == ["nested/v.bf16", "vectors"]
        assert z["nested/v.bf16"].dtype == np.uint16
    art = tpersist.load_artifact(path, device="cpu")
    assert art.data["nested"]["v"].dtype == torch.bfloat16
    jart = jpersist.load_artifact(path)
    assert str(jart.data["nested"]["v"].dtype) == "bfloat16"


def _exp_config(tmp_path, mode, enabled=True):
    algo = {
        "indexer": {"type": "FactoryIndexer", "index_key": "IVF16,SQ8", "nprobe": 4},
        "searcher": {"type": "ANNSearcher", "nprobe": 4},
        "metric": "l2",
    }
    if enabled:
        algo["persistence"] = {"enabled": True, "mode": mode,
                               "artifact_dir": str(tmp_path / "artifacts")}
    return ExperimentConfig(
        dataset="random", data_dir=str(tmp_path / "data"),
        dataset_options={"dimensions": 16, "train_size": 3000, "test_size": 40,
                         "ground_truth_k": 10, "seed": 5, "use_cache": False},
        n_queries=40, topk=10, query_batch_size=16,
        algorithms={"ivf_sq8": algo},
    )


def test_build_only_then_retrieve_only_in_the_port(tmp_path, monkeypatch):
    seen = []
    orig = texp.ExperimentRunner._timed_search

    def keep(self, *a, **kw):
        out = orig(self, *a, **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(texp.ExperimentRunner, "_timed_search", keep)
    run = lambda mode, out, **kw: texp.ExperimentRunner(  # noqa: E731
        _exp_config(tmp_path, mode, **kw), output_dir=str(tmp_path / out), device="cpu"
    ).run()["ivf_sq8"]
    built = run("build_only", "o1")
    assert built["status"] == "build_only" and "qps" not in built
    assert built["persist_dir"] == str(tmp_path / "artifacts" / "ivf_sq8")
    assert os.path.exists(os.path.join(built["persist_dir"], tpersist.SENTINEL))
    assert seen == []
    loaded = run("retrieve_only", "o2")
    assert "error" not in loaded, loaded
    assert loaded["index_source"] == "loaded" and loaded["build_time_s"] == 0.0
    assert loaded["dataset_fingerprint"] == built["dataset_fingerprint"]
    fresh = run("build_and_retrieve", "o3", enabled=False)
    assert fresh["index_source"] == "built" and fresh["persist_dir"] is None
    np.testing.assert_array_equal(seen[0], seen[1])
    assert loaded["recall@10"] == fresh["recall@10"]


def test_retrieve_only_missing_artifact_is_a_row_error(tmp_path):
    res = texp.ExperimentRunner(
        _exp_config(tmp_path, "retrieve_only"), output_dir=str(tmp_path / "o"),
        device="cpu",
    ).run()
    assert "persisted index missing" in res["ivf_sq8"]["error"]


def test_composite_save_requires_a_built_index(tmp_path):
    algo = CompositeAlgorithm(
        8, indexer={"type": "FactoryIndexer", "index_key": "SQ8"},
        searcher={"type": "ANNSearcher"}, device="cpu",
    )
    assert algo.supports_persistence
    with pytest.raises(RuntimeError, match="not built"):
        algo.save_index(str(tmp_path / "x"))
