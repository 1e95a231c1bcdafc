"""The ``glove50.hnsw`` cell on the host: its files, cut to a small size in
a copy, run through the harness with ``correct`` true and a planted fault
refused; its new readers on synthetic records; the plain block beam
imports neither JAX nor the program."""

import json
import os
import shutil

import pytest

from retrieval_bench import control, harness, trace
from retrieval_bench.tests.test_rb_isolation import JAX, PROGRAM, top_level_imports

CELL = "glove50.hnsw"
NEW = ("k2_ms_per_batch", "k2_roofline_pct", "seed_dispatch_ms_per_batch",
       "wave_dispatch_ms_per_batch")
US = 1000
K2 = ("void (anonymous namespace)::slab_prep_kernel<false>(int const*)",
      "void (anonymous namespace)::slab_scan_kernel(int const*, int*)",
      "void (anonymous namespace)::slab_scatter_kernel(int const*)",
      "void (anonymous namespace)::slab_dots_tc_kernel<false>((anonymous namespace)::SlabParams)")
NOT_K2 = ("void vrt::btc::blockmin_tc_kernel<(vrt::btc::Mode)2, 1>(vrt::btc::Params)",
          "void vrt::k6::block_rescore_kernel<32, 4, 1, true>(vrt::k6::Params)",
          "void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>(...)",
          "slab_prep_kernel_v2", "my_slab_scan_kernel", "Memset (Device)")


@pytest.fixture
def small_copy(tmp_path, monkeypatch):
    """The benchmark's files in a copy, the cell cut to 60,000 rows, a
    512-query pool and 64-query batches (235 blocks: two waves at efSearch
    200), the harness pointed at the copy."""
    bench = tmp_path / "retrieval_bench"
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = bench / "configs" / "glove50.json"
    cfg = json.loads(path.read_text())
    cfg.update(n=60_000, pool=512)
    path.write_text(json.dumps(cfg))
    path = bench / "workloads" / f"{CELL}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), batch=64)))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    monkeypatch.setattr(harness, "BENCH_DIR", str(bench))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    return tmp_path


def test_the_cell_runs_small_on_the_host_and_is_correct(small_copy):
    out = harness.run(CELL, 2**33 + 3, 2.0, True, device="cpu")
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert list(out["checks"]) == ["bad_rows", "dist_err", "wrong_share"]
    for m in ("seed_dispatch_ms_per_batch", "wave_dispatch_ms_per_batch",
              "dispatch_ms_per_batch", "h2d_ms_per_batch", "d2h_ms_per_batch"):
        assert out["metrics"][m]["value"] > 0, m
    # the host runs K2's plain version: no K2 kernel, no roofline
    assert "k2_ms_per_batch" not in out["metrics"] and "k2_roofline_pct" not in out["metrics"]
    assert out["metrics"]["wave_dispatch_ms_per_batch"]["value"] \
        > out["metrics"]["seed_dispatch_ms_per_batch"]["value"]
    out = harness.run(CELL, 2**33 + 3, 0.3, False, device="cpu")
    assert set(out["metrics"]) == {"qps", "batch_p95_ms", "recall", "setup_s"}


@pytest.mark.parametrize("fault", control.FAULTS)
def test_the_cell_refuses_a_planted_fault(small_copy, fault):
    out = harness.run(CELL, 2**33 + 3, 0.3, False, device="cpu", factory=control.factory(fault))
    assert out["attempted"] > 0 and not out["correct"], out["checks"]


def _records(names, ns=100 * US):
    """One request of 1 ms holding one kernel of each name, ``ns`` each,
    and the beam's spans: a seed of 50 us and two waves of 200 us."""
    kernels, t = [], 100 * US
    for name in names:
        kernels.append((name, t, t + ns))
        t += ns
    return {
        "requests": [(trace.REQUEST, 0, 1000 * US)],
        "kernels": kernels, "copies": [],
        "host_ops": [("vrt.search", 10 * US, 900 * US), ("vrt.seed", 20 * US, 70 * US),
                     ("vrt.wave", 70 * US, 270 * US), ("vrt.wave", 270 * US, 470 * US)],
    }


def read(name, rec):
    return harness.load_module("layer_metrics", name).read(rec, harness.load_cell(CELL))


def test_k2s_pattern_matches_only_its_four_kernels():
    assert read("k2_ms_per_batch", _records(K2 + NOT_K2)) == pytest.approx(0.4)
    assert read("k2_ms_per_batch", _records(NOT_K2)) is None
    assert read("k2_roofline_pct", _records(NOT_K2)) is None


def test_k2_roofline_reads_100_at_the_floor_and_never_more():
    cell = harness.load_cell(CELL)
    reader = harness.load_module("layer_metrics", "k2_roofline_pct")
    waves, w, length = reader.geometry(cell["config"]["n"], cell["config"]["d"], 200)
    assert (waves, w, length) == (2, 96, 256)
    b, d = cell["workload"]["batch"], cell["config"]["d"]
    wave_s = max(2.0 * b * w * length * d / 989e12, 4.0 * (b * d + b * w * length) / 3.35e12)
    assert wave_s == 4.0 * (b * d + b * w * length) / 3.35e12  # the bytes bound
    floor_ns = waves * wave_s * 1e9
    assert read("k2_roofline_pct", _records(K2[-1:], floor_ns)) == pytest.approx(100.0)
    assert read("k2_roofline_pct", _records(K2, floor_ns / 4)) <= 100.0 + 1e-9
    assert read("k2_roofline_pct", _records(K2, floor_ns)) == pytest.approx(25.0)
    other = harness.load_cell("sift1m.exact")
    assert reader.read(_records(K2), other) is None  # no graph index there


def test_the_beams_dispatch_readers():
    rec = _records(K2)
    assert read("seed_dispatch_ms_per_batch", rec) == pytest.approx(0.05)
    assert read("wave_dispatch_ms_per_batch", rec) == pytest.approx(0.4)
    for name, span in (("seed_dispatch_ms_per_batch", "vrt.seed"),
                       ("wave_dispatch_ms_per_batch", "vrt.wave")):
        bare = dict(rec, host_ops=[op for op in rec["host_ops"] if op[0] != span])
        assert read(name, bare) is None
        assert read(name, dict(rec, requests=[])) is None


def test_the_new_metrics_are_benchmark_entries_of_the_cell():
    bench = harness.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert entries[name]["workloads"] == [CELL] and entries[name]["moves"] == "qps"
        assert harness.load_module("layer_metrics", name).UNIT == entries[name]["unit"]
    listed = harness.metric_names(CELL, True)
    assert set(NEW) <= set(listed)
    assert not {"k1_ms_per_batch", "k1_roofline_pct", "k6_ms_per_batch",
                "probe_dispatch_ms_per_batch", "rescore_dispatch_ms_per_batch"} & set(listed)


def test_the_plain_beam_imports_neither_jax_nor_the_program():
    path = os.path.join(harness.BENCH_DIR, "plain_block_beam.py")
    assert top_level_imports(path) == {"__future__", "typing", "torch"}
    assert not top_level_imports(path) & (JAX | {PROGRAM})


def test_a_pool_seed_draws_another_glove_pool_for_the_same_corpus():
    cfg = harness.load_json("configs", "glove50.json")
    gen = harness.load_module("generators", cfg["generator"])
    opts = cfg["generator_options"]
    base, pool = gen.generate(cfg["data_seed"], 1200, 30, **opts)
    base_a, pool_a = gen.generate(cfg["data_seed"], 1200, 30, pool_seed=7, **opts)
    base_b, pool_b = gen.generate(cfg["data_seed"], 1200, 30, pool_seed=2**40 + 8, **opts)
    assert base_a.tobytes() == base.tobytes() == base_b.tobytes()
    assert pool_a.shape == pool.shape and not (pool_a == pool_b).all()
    assert gen.generate(cfg["data_seed"], 1200, 30, pool_seed=7, **opts)[1].tobytes() \
        == pool_a.tobytes()
