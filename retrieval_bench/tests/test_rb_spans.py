"""The span readers (``spans.py`` and the ``layer_metrics/`` that use it)
compute what their files say on a synthetic trace, find nothing where the
program has no span, and read every span metric of a traced CPU run."""

import pytest

from retrieval_bench import harness, spans, trace
from retrieval_bench.tests.conftest import small_cell

BENCH = harness.benchmark()
SPAN_METRICS = {
    "h2d_ms_per_batch": "vrt.h2d",
    "dispatch_ms_per_batch": "vrt.search",
    "dispatch_idle_ms_per_batch": "vrt.search",
    "probe_dispatch_ms_per_batch": "vrt.probe",
    "rescore_dispatch_ms_per_batch": "vrt.rescore",
    "d2h_ms_per_batch": "vrt.d2h",
    "launches_per_batch": "vrt.search",
}
US = 1000


def _us(*triples):
    return [(n, s * US, e * US) for n, s, e in triples]


def synthetic_records():
    """Two requests (0-1000 us, 1500-2500 us), each with its upload,
    search and copy back; the second probes and rescores twice, and its
    copy back runs 100 us past the request's end. A search span between
    the requests, with a launch in it, lies outside both."""
    return {
        "requests": _us((trace.REQUEST, 0, 1000), (trace.REQUEST, 1500, 2500)),
        "kernels": _us(("k_a", 150, 400), ("k_b", 550, 600), ("k_c", 1600, 1900)),
        "copies": _us(("Memcpy HtoD (Pageable -> Device)", 20, 50),
                      ("Memcpy DtoD (Device -> Device)", 1850, 1950)),
        "host_ops": sorted(_us(
            ("vrt.h2d", 10, 60), ("cudaMemcpyAsync", 20, 50),
            ("vrt.search", 60, 700), ("cudaLaunchKernel", 100, 110),
            ("cudaLaunchKernel", 200, 210), ("aten::topk", 250, 450),
            ("cuLaunchKernel", 300, 305), ("cudaMemsetAsync", 400, 405),
            ("vrt.rescore", 500, 650), ("cudaLaunchKernelExC_v11060", 520, 525),
            ("vrt.d2h", 700, 990), ("cudaMemcpyAsync", 710, 720),
            ("cudaStreamSynchronize", 720, 980),
            ("vrt.search", 1100, 1200), ("cudaLaunchKernel", 1150, 1155),
            ("vrt.h2d", 1510, 1550),
            ("vrt.search", 1550, 2100), ("vrt.probe", 1560, 1700),
            ("cudaLaunchKernel", 1600, 1605), ("vrt.rescore", 1800, 1900),
            ("cudaMemcpyAsync", 1810, 1815), ("vrt.rescore", 1950, 2050),
            ("vrt.d2h", 2100, 2600),
        ), key=lambda t: t[1]),
    }


def read(name, rec):
    return harness.load_module("layer_metrics", name).read(rec, harness.load_cell("sift1m.ivf_flat"))


@pytest.mark.parametrize("name,expected", [
    ("h2d_ms_per_batch", (0.050 + 0.040) / 2),
    ("dispatch_ms_per_batch", (0.640 + 0.550) / 2),  # the span between requests is left out
    # idle: 640 - 250 - 50 us; 550 less the kernel and copy's union, 1600-1950 us
    ("dispatch_idle_ms_per_batch", (0.340 + 0.200) / 2),
    ("probe_dispatch_ms_per_batch", 0.140 / 2),
    ("rescore_dispatch_ms_per_batch", (0.150 + 0.100 + 0.100) / 2),
    ("d2h_ms_per_batch", (0.290 + 0.400) / 2),  # clipped at the request's end
    # five in the first search (not aten::topk), two in the second
    ("launches_per_batch", (5 + 2) / 2),
])
def test_each_span_reader_on_a_synthetic_trace(name, expected):
    assert read(name, synthetic_records()) == pytest.approx(expected, abs=1e-12)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_each_span_reader_is_none_without_its_span(name):
    rec = synthetic_records()
    rec["host_ops"] = [op for op in rec["host_ops"] if op[0] != SPAN_METRICS[name]]
    assert read(name, rec) is None
    assert read(name, dict(synthetic_records(), requests=[])) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_each_span_reader_is_none_for_a_span_outside_every_request(name):
    rec = synthetic_records()
    rec["requests"] = rec["requests"][:1]
    rec["host_ops"] = [op for op in rec["host_ops"] if op[1] > 1000 * US]
    assert read(name, rec) is None


def test_launch_names_the_profiler_gives():
    for n in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
              "cudaLaunchKernelExC_v11060", "cudaMemcpyAsync", "cudaMemsetAsync"):
        assert spans.LAUNCH_CALLS.match(n), n
    for n in ("cudaStreamSynchronize", "cudaMemcpy", "aten::empty", "cudaLaunchKernelFoo",
              "cuLaunchKernelEx"):
        assert not spans.LAUNCH_CALLS.match(n), n


def test_span_metrics_are_benchmark_entries_with_readers():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SPAN_METRICS:
        assert entries[name]["moves"] == "qps" and entries[name]["better"] == "lower"
        assert harness.load_module("layer_metrics", name).UNIT == entries[name]["unit"]


@pytest.mark.parametrize("name,size", [("sift1m.ivf_flat", {}),
                                       ("sift1m.exact", dict(n=33_000, pool=96, batch=32))])
def test_a_traced_cpu_run_reports_every_span_metric_of_the_cell(name, size):
    out = harness.run(name, 2**33 + 7, 0.6, True, device="cpu", cell=small_cell(name, **size))
    assert out["attempted"] > 0 and out["failed"] == 0  # correctness: test_rb_correctness.py
    listed = [m for m in harness.metric_names(name, True) if m in SPAN_METRICS]
    assert listed and set(listed) <= set(out["metrics"])
    for m in listed:
        assert out["metrics"][m]["value"] >= 0
    assert out["metrics"]["dispatch_ms_per_batch"]["value"] > 0
