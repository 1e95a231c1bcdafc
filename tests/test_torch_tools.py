"""The port's entry points and utils against the JAX package, on the CPU:
vector helpers, timing, counted work (``utils/profiling.cost_estimate`` and
the kernel wrappers' formulas), the runner's roofline keys, the parameter
sweep, the algorithm comparator, the CLIs, the flagship and the matched
conditions rows (``device="cpu"`` everywhere)."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from vectordb_retrieval_tpu.ops import distances as jdist
from vectordb_retrieval_tpu.utils import vector_utils as JV
from vectordb_retrieval_tpu_torch import flagship
from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner
from vectordb_retrieval_tpu_torch.ops import distances as tdist
from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.scripts import matched_conditions
from vectordb_retrieval_tpu_torch.scripts.compare_algorithms import AlgorithmComparator
from vectordb_retrieval_tpu_torch.scripts.parameter_sweep import ParameterSweepRunner
from vectordb_retrieval_tpu_torch.utils import profiling, timing
from vectordb_retrieval_tpu_torch.utils import vector_utils as TV

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOFLINE_KEYS = ("kernel_flops_per_batch", "achieved_tflops", "kernel_bytes_per_batch",
                 "achieved_gbps")
CPU_ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def _jax_script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- vector_utils ----------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_vector_utils_bit_identical(metric):
    x = TV.random_unit_vectors(10, 8, seed=1)
    np.testing.assert_array_equal(x, JV.random_unit_vectors(10, 8, seed=1))
    np.testing.assert_allclose(np.linalg.norm(x, axis=1), 1.0, atol=1e-5)
    raw = np.random.default_rng(3).standard_normal((6, 8)) * 5
    np.testing.assert_array_equal(TV.normalize_vectors(raw), JV.normalize_vectors(raw))
    for a, b in ((x[0], x[1]), (raw[2], raw[3]), (raw[4], raw[4])):
        assert TV.compute_distance(a, b, metric) == JV.compute_distance(a, b, metric)
    self_d = TV.compute_distance(x[0], x[0], metric)
    assert self_d == pytest.approx({"l2": 0.0, "ip": -1.0, "cosine": -1.0}[metric], abs=1e-5)


def test_vector_utils_unknown_metric_raises():
    with pytest.raises(ValueError):
        TV.compute_distance(np.ones(3), np.ones(3), "bogus")


# ---- timing ------------------------------------------------------------------


def test_block_returns_nested_cpu_trees_unchanged():
    a, b = torch.ones(3), torch.zeros(2, 2)
    tree = {"x": [a, (b, 1)], "y": "label"}
    assert timing.block(tree) is tree
    assert timing.block(a) is a
    assert timing.block([]) == []


def test_time_function_and_timer():
    calls = []

    @timing.time_function
    def f(n):
        calls.append(n)
        return {"out": [torch.arange(n), torch.ones(n)]}

    out, seconds = f(4)
    assert calls == [4] and torch.equal(out["out"][0], torch.arange(4))
    assert seconds >= 0.0 and f.__name__ == "f"
    with timing.Timer("t") as t:
        timing.block(torch.ones(10) * 2)
    assert t.elapsed >= 0.0 and t.name == "t"


# ---- counted work ------------------------------------------------------------


def _k1_inputs(b, s, d, w, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, d), generator=g)
    x = torch.randn((s, d), generator=g)
    pen = (x * x).sum(1).reshape(s // w, w).contiguous()
    if dtype == torch.bfloat16:
        x = x.to(torch.bfloat16)
    elif dtype == torch.uint8:
        x = torch.randint(0, 256, (s, d), generator=g, dtype=torch.uint8)
    return q, x, pen


@pytest.mark.parametrize("dtype,item", [(torch.float32, 4), (torch.bfloat16, 2),
                                        (torch.uint8, 1)])
def test_cost_of_dist_blockmin_is_its_formula(dtype, item):
    b, s, d, w = 16, 256, 24, 8
    q, x, pen = _k1_inputs(b, s, d, w, dtype)
    cost = profiling.cost_estimate(kernels.dist_blockmin, q, x, pen, w)
    q_item = 4 if dtype == torch.float32 else 2
    assert cost == {
        "flops": 2.0 * b * s * d + 2.0 * b * s,
        "bytes_accessed": q_item * b * d + item * s * d + 4.0 * s + 4.0 * b * (s // w),
    }
    assert profiling.flops_estimate(kernels.dist_blockmin, q, x, pen, w) == cost["flops"]


def test_cost_of_dist_blockmin_pair_counts_both_pens():
    b, s, d, w = 8, 128, 16, 8
    q, x, pen = _k1_inputs(b, s, d, w, torch.bfloat16)
    cost = profiling.cost_estimate(kernels.dist_blockmin_pair, q, x, pen, pen.clone(), w)
    assert cost == {
        "flops": 2.0 * b * s * d + 4.0 * b * s,
        "bytes_accessed": 2.0 * b * d + 2.0 * s * d + 2 * (4.0 * s + 4.0 * b * (s // w)),
    }


def test_cost_of_assign_blockmin_and_slab_dots_are_their_formulas():
    g = torch.Generator().manual_seed(1)
    n, k, d = 300, 17, 12
    p, c = torch.randn((n, d), generator=g), torch.randn((k, d), generator=g)
    assert profiling.cost_estimate(kernels.assign, p, c) == {
        "flops": 2.0 * n * k * d + 3.0 * n * k,
        "bytes_accessed": 4.0 * (n * d + k * d) + 12.0 * n}

    b, rows, w = 5, 4096, 8
    q, db = torch.randn((b, d), generator=g), torch.randn((rows, d), generator=g)
    assert profiling.cost_estimate(kernels.blockmin, q, db, w) == {
        "flops": 2.0 * b * rows * d + 3.0 * b * rows,
        "bytes_accessed": 4.0 * (b * d + rows * d + b * (rows // w))}

    nb, length = 10, 16
    lv = torch.randn((nb, length, d), generator=g).to(torch.bfloat16)
    sel = torch.tensor([[0, 3, 3], [9, 0, 1], [3, 3, 3], [1, 1, 1], [0, 0, 9]],
                       dtype=torch.int32)
    distinct = 4  # slabs 0, 1, 3, 9
    assert profiling.cost_estimate(kernels.slab_dots, q, lv, sel) == {
        "flops": 2.0 * b * 3 * length * d,
        "bytes_accessed": distinct * length * d * 2 + 4.0 * b * d + 4.0 * b * 3
        + 4.0 * b * 3 * length}


def test_cost_of_a_matmul_counts_its_products_and_bytes():
    a, b = torch.randn(5, 7), torch.randn(7, 3)
    assert profiling.cost_estimate(torch.matmul, a, b) == {
        "flops": 2.0 * 5 * 7 * 3, "bytes_accessed": 4.0 * (5 * 7 + 7 * 3 + 5 * 3)}
    batched = profiling.cost_estimate(torch.matmul, torch.randn(2, 5, 7), torch.randn(2, 7, 3))
    assert batched["flops"] == 2.0 * 2 * 5 * 7 * 3
    assert profiling.cost_estimate(lambda: None) == {}
    assert profiling.flops_estimate(lambda: None) is None


def test_wrapper_internals_are_not_counted_twice():
    """The plain version inside a wrapper runs a matmul; only the wrapper's
    formula is counted, and the count is the same with nested scopes."""
    q, x, pen = _k1_inputs(4, 64, 8, 8, torch.float32)
    with kernels.count_work() as outer:
        cost = profiling.cost_estimate(kernels.dist_blockmin, q, x, pen, 8)
    flops, nbytes = kernels.dist_blockmin_work(4, 64, 8, 8, torch.float32)
    assert cost == {"flops": flops, "bytes_accessed": nbytes}
    assert outer == {"flops": flops, "bytes": nbytes, "calls": 1}
    assert not kernels.inside_wrapper()


def test_exact_search_blockmin_path_counts_k1_by_its_formula():
    """At 40,000 rows exact search takes the blockmin path: K1 f32's and
    K6's shares of the count are their formulas (K6's bytes: the distinct
    blocks stage 2 selected), and the aten ops around them add the rest."""
    rng = np.random.default_rng(5)
    n, d, b, k = 40_000, 8, 16, 10
    x = torch.as_tensor(rng.standard_normal((n, d), dtype=np.float32))
    q = torch.as_tensor(rng.standard_normal((b, d), dtype=np.float32))
    sqn = tdist.sq_norms(x)
    w = tdist.blockmin_width(n)
    _, blk = tdist._blockmin_blocks(q, x, sqn, k, "l2", tdist.DEFAULT_CHUNK_ROWS, w)
    with kernels.count_work() as work:
        cost = profiling.cost_estimate(tdist.exact_search, q, x, k, "l2", sqn, device="cpu")
    flops, nbytes = kernels.dist_blockmin_work(b, n, d, w, torch.float32)
    k6_flops, k6_bytes = kernels.block_rescore_work(b, blk.shape[1], w, d,
                                                    int(torch.unique(blk).numel()), "l2")
    assert work == {"flops": flops + k6_flops, "bytes": nbytes + k6_bytes, "calls": 2}
    assert cost["flops"] >= flops + k6_flops and cost["bytes_accessed"] > nbytes + k6_bytes


# ---- the runner's roofline keys -----------------------------------------------


def _smoke_config(tmp_path):
    with open(os.path.join(REPO, "configs", "benchmark_config_smoke.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["output_dir"] = str(tmp_path / "out")
    cfg["data_dir"] = str(tmp_path / "data")
    path = tmp_path / "smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg


def test_runner_fills_the_roofline_keys_on_every_smoke_row(tmp_path):
    path, cfg = _smoke_config(tmp_path)
    runner = BenchmarkRunner(path, device="cpu")
    rows = runner.run()["random"]
    assert set(rows) == set(cfg["algorithms"])
    batch = cfg["query_batch_size"]
    for name, row in rows.items():
        assert "error" not in row, (name, row)
        for key in ROOFLINE_KEYS:
            assert math.isfinite(row[key]) and row[key] > 0, (name, key, row[key])
        batches_per_s = row["qps"] / batch
        assert row["achieved_tflops"] == pytest.approx(
            row["kernel_flops_per_batch"] * batches_per_s / 1e12, rel=1e-12)
        assert row["achieved_gbps"] == pytest.approx(
            row["kernel_bytes_per_batch"] * batches_per_s / 1e9, rel=1e-12)
    # the exact row's dense path: one [64, 32] x [32, 2000] product a batch
    assert rows["exact"]["kernel_flops_per_batch"] == 2.0 * 64 * 32 * 2000
    with open(os.path.join(runner.output_dir, "benchmark_summary.md")) as f:
        summary = f.read()
    assert "H100" in summary and "v5e" not in summary
    line = next(ln for ln in summary.splitlines() if ln.startswith("| exact |"))
    assert "| - |" not in line


# ---- sweep and comparator, both packages -------------------------------------

SWEEP_CONFIG = {
    "dataset": "random",
    "dataset_options": {
        "dimensions": 8, "train_size": 128, "test_size": 16,
        "ground_truth_k": 10, "seed": 3, "use_cache": False,
    },
    "n_queries": 8,
    "topk": 5,
    "algorithm_name": "ivf",
    "algorithm": {"type": "ApproximateSearch", "metric": "l2"},
    "sweep": {"nprobe": [2, 4], "index_type": ["IVF4,Flat"]},
}

COMPARE_CONFIG = {
    "algorithms": {
        "exact": {"type": "ExactSearch", "metric": "l2"},
        "ivf": {"type": "ApproximateSearch", "index_type": "IVF4,Flat",
                "metric": "l2", "nprobe": 4},
    },
    "datasets": [
        {
            "name": "random",
            "n_queries": 8,
            "topk": 5,
            "dataset_options": {
                "dimensions": 8, "train_size": 128, "test_size": 16,
                "ground_truth_k": 10, "seed": 3, "use_cache": False,
            },
        }
    ],
    "seed": 42,
}


def _files(path):
    return sorted(f for f in os.listdir(path) if os.path.isfile(os.path.join(path, f)))


def test_parameter_sweep_matches_jax(tmp_path):
    jax_rows = _jax_script("parameter_sweep").ParameterSweepRunner(
        SWEEP_CONFIG, str(tmp_path / "jax")).run()
    rows = ParameterSweepRunner(SWEEP_CONFIG, str(tmp_path / "port"), device="cpu").run()
    assert len(rows) == len(jax_rows) == 2
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for got, want in zip(rows, jax_rows):
        assert set(got) == set(want) and "error" not in got
        assert {k: got[k] for k in ("combo", "nprobe", "index_type")} == \
            {k: want[k] for k in ("combo", "nprobe", "index_type")}
        assert abs(got["recall"] - want["recall"]) <= 0.03
    data = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "sweep_results.json") as f:
            data[side] = json.load(f)
    assert set(data["port"]["analysis"]) == set(data["jax"]["analysis"])
    assert data["port"]["analysis"]["n_combinations"] == 2
    assert data["port"]["analysis"]["best_recall"]
    with open(tmp_path / "port" / "sweep_results.csv") as f:
        assert f.readline().strip().split(",") == sorted(rows[0])


def test_algorithm_comparator_matches_jax(tmp_path):
    want = _jax_script("compare_algorithms").AlgorithmComparator(
        COMPARE_CONFIG, n_runs=2, output_dir=str(tmp_path / "jax")).run()
    got = AlgorithmComparator(COMPARE_CONFIG, n_runs=2, output_dir=str(tmp_path / "port"),
                              device="cpu").run()
    assert got["n_runs"] == want["n_runs"] == 2
    assert set(got) == set(want)
    assert set(got["statistics"]) == set(want["statistics"]) == {"exact", "ivf"}
    for alg, stats in got["statistics"].items():
        assert set(stats) == set(want["statistics"][alg])
        for key, s in stats.items():
            assert set(s) == set(want["statistics"][alg][key]) and s["n"] == 2
        assert abs(stats["recall"]["mean"] - want["statistics"][alg]["recall"]["mean"]) <= 0.03
    assert got["statistics"]["exact"]["recall"]["mean"] == 1.0
    assert want["statistics"]["exact"]["recall"]["mean"] == 1.0
    assert set(got["significance"]) == set(want["significance"]) == {"exact_vs_ivf"}
    assert set(got["significance"]["exact_vs_ivf"]) == set(want["significance"]["exact_vs_ivf"])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


# ---- the CLIs, as subprocesses ------------------------------------------------


def test_create_config_equals_the_jax_scripts(tmp_path):
    for name, cmd in (
        ("port", [sys.executable, "-m",
                  "vectordb_retrieval_tpu_torch.scripts.run_full_benchmark"]),
        ("jax", [sys.executable, os.path.join(REPO, "scripts", "run_full_benchmark.py")]),
    ):
        r = subprocess.run(cmd + ["--create-config", str(tmp_path / f"{name}.yaml")],
                           capture_output=True, text=True, timeout=120, cwd=REPO, env=CPU_ENV)
        assert r.returncode == 0, r.stderr
    port = yaml.safe_load((tmp_path / "port.yaml").read_text())
    assert port == yaml.safe_load((tmp_path / "jax.yaml").read_text())
    assert "algorithms" in port and "indexers" in port and "datasets" in port


def _tiny_main_config(tmp_path):
    cfg = {
        "dataset": "random", "data_dir": str(tmp_path / "data"),
        "dataset_options": {"dimensions": 16, "train_size": 600, "test_size": 40,
                            "ground_truth_k": 20, "seed": 3, "use_cache": False},
        "n_queries": 32, "topk": 10, "query_batch_size": 16, "seed": 42, "metric": "l2",
        "algorithms": {
            "exact": {"type": "ExactSearch", "metric": "l2"},
            "approx": {"type": "ApproximateSearch", "index_type": "IVF8,Flat",
                       "metric": "l2", "nprobe": 8},
        },
    }
    path = tmp_path / "main.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _row_lines(stdout):
    return dict(line.split(": ", 1) for line in stdout.splitlines()
                if line.startswith(("exact:", "approx:")))


@pytest.mark.parametrize("module", ["main", "scripts.run_experiment"])
def test_main_and_run_experiment_on_the_cpu(tmp_path, module):
    path = _tiny_main_config(tmp_path)
    r = subprocess.run(
        [sys.executable, "-m", f"vectordb_retrieval_tpu_torch.{module}", "--config", path,
         "--output-dir", str(tmp_path / "out"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=CPU_ENV)
    assert r.returncode == 0, r.stderr
    (name,) = [f for f in os.listdir(tmp_path / "out") if f.endswith("_all_results.json")]
    with open(tmp_path / "out" / name) as f:
        results = json.load(f)
    assert set(results) == {"exact", "approx"}
    assert results["exact"]["recall"] == 1.0 and results["approx"]["recall"] > 0.9
    if module == "main":
        rows = _row_lines(r.stdout)
        assert set(rows) == {"exact", "approx"}
        assert rows["exact"].startswith("recall=1.0 qps=")
        jax = subprocess.run(
            [sys.executable, os.path.join(REPO, "main.py"), "--config", path,
             "--output-dir", str(tmp_path / "jax")],
            capture_output=True, text=True, timeout=300, cwd=REPO, env=CPU_ENV)
        assert jax.returncode == 0, jax.stderr
        jax_rows = _row_lines(jax.stdout)
        assert set(jax_rows) == set(rows)
        for name in rows:  # recall within 0.03 (IVF builds differ in their draws)
            got, want = (float(r[name].split()[0].split("=")[1]) for r in (rows, jax_rows))
            assert abs(got - want) <= 0.03


@pytest.mark.parametrize("module", ["main", "flagship", "scripts.run_full_benchmark"])
def test_cli_without_device_fails_without_a_card(tmp_path, module):
    args = {"main": ["--config", _tiny_main_config(tmp_path),
                     "--output-dir", str(tmp_path / "out")],
            "flagship": [],
            "scripts.run_full_benchmark": ["--config", _smoke_config(tmp_path)[0]]}[module]
    env = dict(CPU_ENV, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", f"vectordb_retrieval_tpu_torch.{module}", *args],
                       capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode != 0
    assert "no CUDA device available" in r.stderr


# ---- the flagship -------------------------------------------------------------


def test_flagship_small_on_the_cpu_matches_jax_exact_search():
    n, d, batches = 4096, 32, 4
    record, ids = flagship.run(n=n, d=d, batches=batches, device="cpu")
    assert set(record) == {"metric", "value", "unit", "vs_baseline", "device",
                           "power_limit_w"}
    assert record["device"] == "cpu" and record["power_limit_w"] is None
    assert record["unit"] == "queries/s" and record["value"] > 0
    assert record["metric"] == "exact_search_qps_4k_32d_top20"
    assert ids.shape == (batches, flagship.BATCH, flagship.K)
    # the same draws as the workload; JAX's exact search on them
    db, sqn, queries = flagship.make_workload(n, d, batches, flagship.BATCH, flagship.SEED,
                                              torch.device("cpu"))
    x, qs = db.numpy(), queries.numpy()
    for i in range(batches):
        _, want = jdist.exact_search(qs[i], x, flagship.K, metric="l2",
                                     db_sqnorms=sqn.numpy())
        want = np.asarray(want)
        got = ids[i]
        dg = ((x[got] - qs[i][:, None, :]) ** 2).sum(-1)
        dw = ((x[want] - qs[i][:, None, :]) ** 2).sum(-1)
        np.testing.assert_allclose(dg, dw, rtol=1e-5, atol=1e-4)
        assert (got == want).mean() > 0.99


def test_flagship_data_is_bench_py_draws():
    db, _, queries = flagship.make_workload(64, 8, 2, 4, 7, torch.device("cpu"))
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(db.numpy(), rng.standard_normal((64, 8)).astype(np.float32))
    np.testing.assert_array_equal(queries.numpy(),
                                  rng.standard_normal((2, 4, 8)).astype(np.float32))


# ---- matched conditions ---------------------------------------------------------


def test_matched_conditions_on_a_tiny_random_row(tmp_path, capsys):
    datasets = {"random": (
        {"name": "random", "options": {
            "dimensions": 16, "train_size": 1000, "test_size": 256,
            "ground_truth_k": 20, "seed": 7, "use_cache": False}},
        8, matched_conditions.DATASETS["random"][2])}
    algos = {name: matched_conditions.ALGOS[name] for name in ("exact", "ivf_flat", "pq")}
    rows = matched_conditions.run_rows(datasets, algos, data_dir=str(tmp_path), device="cpu")
    assert [r["algorithm"] for r in rows] == ["exact", "ivf_flat", "pq"]
    assert rows[0]["recall"] == 1.0 and rows[1]["recall"] > 0.5
    for r in rows:
        assert set(r) == {"dataset", "algorithm", "qps_reference_protocol", "recall",
                          "qps_reference_published_cpu"}
        assert r["qps_reference_protocol"] > 0
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == rows


def test_matched_conditions_default_out_is_no_file_of_the_repo():
    out = matched_conditions.DEFAULT_OUT
    assert not os.path.exists(os.path.join(REPO, out))
    assert out != "docs/matched_conditions_rows.json"
