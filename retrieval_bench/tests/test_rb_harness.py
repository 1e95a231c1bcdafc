"""The harness finds its pieces by name, its generators copy the port's,
and its readers and judge compute what their files say."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from retrieval_bench import harness, reference, trace

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_files_by_name(name):
    cell = harness.load_cell(name)
    wl, cfg = cell["workload"], cell["config"]
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert wl["config"] == entry["config"] == cfg["name"]
    harness.load_module("generators", cfg["generator"]).generate
    harness.load_module("guarantees", wl["guarantee"]).search
    assert wl["control"]["precision"] in reference.FORMATS
    assert set(wl["limits"]) <= {"bad_rows", "topk_gap", "wrong_share", "dist_err"}


def test_configs_of_benchmark_json_are_their_files():
    for c in BENCH["configs"]:
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("name", PER_LAYER)
def test_each_per_layer_metric_has_a_reader(name):
    reader = harness.load_module("layer_metrics", name)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert reader.UNIT == entry["unit"] and callable(reader.read)


def test_sift_generator_is_the_ports_draws(tmp_path):
    from vectordb_retrieval_tpu_torch.scripts import make_sift1m_surrogate as port

    port.main(["--n", "3000", "--queries", "40", "--seed", "11", "--out", str(tmp_path)])
    gen = harness.load_module("generators", "sift1m_surrogate")
    base, pool = gen.generate(11, 3000, 40)
    for arr, name in ((base, "sift_base.fvecs"), (pool, "sift_query.fvecs")):
        raw = np.fromfile(tmp_path / name, dtype=np.int32).reshape(arr.shape[0], 129)
        assert (raw[:, 0] == 128).all()
        assert raw[:, 1:].tobytes() == arr.tobytes()


def test_msmarco_generator_is_the_ports_draws(tmp_path):
    from vectordb_retrieval_tpu_torch.data.datasets import Dataset

    cfg = harness.load_cell("msmarco100k.exact")["config"]
    ds = Dataset("msmarco_surrogate", str(tmp_path),
                 {"train_limit": 1500, "test_size": 30, "seed": 9, "use_cache": False,
                  "ground_truth_k": 5}, device="cpu").load()
    gen = harness.load_module("generators", cfg["generator"])
    corpus, pool = gen.generate(9, 1500, 30, **cfg["generator_options"])
    assert corpus.dtype == ds.train_vectors.dtype and corpus.tobytes() == ds.train_vectors.tobytes()
    assert pool.tobytes() == ds.test_vectors.tobytes()


K1_F32 = "void vrt::btc::blockmin_tc_kernel<(vrt::btc::Mode)2, 1>(vrt::btc::Params)"
K3 = "void vrt::btc::blockmin_tc_kernel<(vrt::btc::Mode)4, 1>(vrt::btc::Params)"
TOPK = "void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>(...)"
SORT = "void at::native::bitonicSortKVInPlace<2, -1, 16, 16, float, long>(...)"


def synthetic_records():
    """Two requests of 1 ms each (0-1 ms, 1.5-2.5 ms): K1 0.2 ms and a
    top-k 0.1 ms in the first, K3 0.3 ms and a sort 0.05 ms in the
    second, a 0.05 ms upload in each."""
    us = 1000
    return {
        "requests": [(trace.REQUEST, 0, 1000 * us), (trace.REQUEST, 1500 * us, 2500 * us)],
        "kernels": [(K1_F32, 100 * us, 300 * us), (TOPK, 300 * us, 400 * us),
                    (K3, 1600 * us, 1900 * us), (SORT, 2000 * us, 2050 * us)],
        "copies": [("Memcpy HtoD (Pageable -> Device)", 50 * us, 100 * us),
                   ("Memcpy HtoD (Pageable -> Device)", 1550 * us, 1600 * us)],
        "host_ops": [("aten::topk", 250 * us, 450 * us), ("aten::to", 2100 * us, 2400 * us)],
    }


def read(name, rec, guarantee="exact"):
    cell = harness.load_cell("msmarco100k.exact")
    cell["workload"] = dict(cell["workload"], guarantee=guarantee)
    return harness.load_module("layer_metrics", name).read(rec, cell)


def test_readers_on_a_synthetic_trace():
    rec = synthetic_records()
    # busy: 0.05 + 0.2 + 0.1 + 0.05 + 0.3 + 0.05 = 0.75 ms of a 2.5 ms window
    assert read("device_idle_pct", rec) == pytest.approx(100 * (1 - 0.75 / 2.5))
    # host: (1 - 0.35) and (1 - 0.4) ms
    assert read("host_ms_per_batch", rec) == pytest.approx((0.65 + 0.6) / 2)
    assert read("device_ms_per_batch", rec) == pytest.approx((0.2 + 0.1 + 0.3 + 0.05) / 2)
    assert read("select_ms_per_batch", rec) == pytest.approx((0.1 + 0.05) / 2)
    assert read("k1_ms_per_batch", rec) == pytest.approx(0.2 / 2)  # K3 is not K1


def test_k1_roofline_is_the_functions_least_time_over_k1s():
    rec = synthetic_records()
    cell = harness.load_cell("msmarco100k.exact")
    b, n, d = cell["workload"]["batch"], cell["config"]["n"], cell["config"]["d"]
    least = max(2 * b * n * d / 989e12, 4 * (n * d + b * d) / 3.35e12)
    assert read("k1_roofline_pct", rec) == pytest.approx(100 * least / 0.1e-3)
    assert read("k1_roofline_pct", rec, guarantee="ivf_probed") is None


def test_readers_find_nothing_without_their_kernels():
    rec = synthetic_records()
    rec["kernels"] = [k for k in rec["kernels"] if "blockmin" not in k[0]]
    assert read("k1_ms_per_batch", rec) is None and read("k1_roofline_pct", rec) is None


def test_breakdown_names_ops_and_labels_gaps():
    out = trace.breakdown(synthetic_records())
    assert out["device_ops"][0] == [K3, pytest.approx(0.3e-3)]
    # 0.4-1.5 ms is idle: 0.4-1.0 inside the first request, 1.0-1.5 between
    assert out["idle_gaps"][:3] == [
        [trace.REQUEST, pytest.approx(0.6e-3)],
        ["between requests", pytest.approx(0.5e-3)],
        [trace.REQUEST + " / aten::to", pytest.approx(0.45e-3)],  # 2.05-2.5 ms
    ]


def test_judge_counts_recall_with_ties_and_wrong_answers():
    # six rows on a line, one query at 0: distances 0, 1, 1, 4, 9, 16
    x = torch.tensor([[0.0], [1.0], [-1.0], [2.0], [3.0], [4.0]], dtype=torch.float64)
    q = torch.zeros((1, 1), dtype=torch.float64)
    exact = torch.tensor([[0.0, 1.0, 1.0]], dtype=torch.float64)
    good = (0, np.array([[0.0, 1.0, 1.0]], np.float32), np.array([[0, 2, 1]]))
    wrong = (0, np.array([[0.0, 1.0, 4.0]], np.float32), np.array([[0, 1, 3]]))
    dup = (0, np.array([[0.0, 1.0, 1.0]], np.float32), np.array([[0, 1, 1]]))
    out = reference.judge([good, wrong, dup], 1, 3, x, q, "l2", exact, exact)
    assert out["bad_rows"] == 1  # the repeated id
    assert out["recall"] == pytest.approx(5 / 9)  # 3 + 2 hits of 9 entries
    assert out["topk_gap"] == pytest.approx((4 - 1) / 1)  # scale: the k-th distance
    assert out["wrong_share"] == pytest.approx(1 / 9)
    assert out["dist_err"] == 0.0


def test_a_new_cell_config_and_metric_are_files_only(tmp_path, monkeypatch):
    """A later PR adds a configuration, a workload and a per-layer metric
    as new files and BENCHMARK.json entries: the harness runs them with no
    edit to any file it has."""
    bench = tmp_path / "retrieval_bench"
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((bench / "configs" / "msmarco100k.json").read_text())
    cfg.update(name="tiny", n=2000, pool=100)
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / "workloads" / "msmarco100k.exact.json").read_text())
    wl.update(config="tiny", batch=32, k=5)
    (bench / "workloads" / "tiny.exact.json").write_text(json.dumps(wl))
    (bench / "layer_metrics" / "traced_requests.py").write_text(
        'UNIT = "count"\n\n\ndef read(rec, cell):\n    return float(len(rec["requests"]))\n')
    entries = json.loads(json.dumps(BENCH))
    entries["workloads"].append({"name": "tiny.exact", "config": "tiny", "traffic": "exact",
                                 "chips": 1, "why": "test"})
    entries["per_layer"].append({"name": "traced_requests", "unit": "count", "better": "higher",
                                 "source": "program_counter", "layer": "test", "moves": "qps",
                                 "workloads": ["tiny.exact"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(entries))
    monkeypatch.setattr(harness, "BENCH_DIR", str(bench))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    out = harness.run("tiny.exact", 5, 0.6, True, device="cpu")
    assert out["correct"] and out["metrics"]["traced_requests"]["value"] > 0
    out = harness.run("tiny.exact", 5, 0.3, False, device="cpu")
    assert set(out["metrics"]) == {"qps", "batch_p95_ms", "recall", "setup_s"}
    assert list(out)[-1] == "checks"


def test_the_window_runs_the_pool_in_order_wrapping_round():
    rows = reference.pool_rows([0, 3, 6], 3, 7)
    assert rows.tolist() == [0, 1, 2, 3, 4, 5, 6, 0, 1]


@pytest.mark.parametrize("config", ["sift1m", "msmarco100k"])
def test_a_pool_seed_draws_another_pool_for_the_same_corpus(config):
    cfg = harness.load_json("configs", f"{config}.json")
    gen = harness.load_module("generators", cfg["generator"])
    opts = cfg["generator_options"]
    base, pool = gen.generate(cfg["data_seed"], 1200, 30, **opts)
    base_a, pool_a = gen.generate(cfg["data_seed"], 1200, 30, pool_seed=7, **opts)
    base_b, pool_b = gen.generate(cfg["data_seed"], 1200, 30, pool_seed=8, **opts)
    assert base_a.tobytes() == base.tobytes() == base_b.tobytes()
    assert pool_a.shape == pool.shape and not np.array_equal(pool_a, pool_b)
    again = gen.generate(cfg["data_seed"], 1200, 30, pool_seed=7, **opts)[1]
    assert again.tobytes() == pool_a.tobytes()
