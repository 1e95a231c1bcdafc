"""ivf_rescore_ms_per_batch's reader on synthetic records: it matches the
IVF bf16 rescore kernel's names and no other kernel (K6's included), and
reads None where that kernel did not run."""

import pytest

from retrieval_bench import harness, trace

IVF_SIFT = ("void vrt::ivfr::ivf_block_rescore_kernel<16, 16, 8, 1, true>(float const*, "
            "unsigned short const*, int const*, long const*, float const*, float*, long*, "
            "long long, int, int, int, long long)")
IVF_WIDE = ("void vrt::ivfr::ivf_block_rescore_kernel<32, 8, 8, 2, false>(float const*, "
            "unsigned short const*, int const*, long const*, float const*, float*, long*, "
            "long long, int, int, int, long long)")
K6_SIFT = ("void vrt::k6::block_rescore_kernel<32, 4, 1, true>(float const*, float const*, "
           "long const*, float*, long*, long long, int, int, int, long long, long long)")
OTHERS = [
    K6_SIFT,
    "void vrt::btc::blockmin_tc_kernel<(vrt::btc::Mode)0, 1>(vrt::btc::Params)",  # K1 bf16
    "void vrt::slab_dots_kernel<true>(vrt::SlabParams)",  # K2
    "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, "
    "long, long, long, bool)",
    "void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>(...)",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
    "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() "
    "const::{lambda(c10::BFloat16)#1}, ...>(int, ...)",
]


def records(kernels):
    """Two requests of 1 ms each (0-1 ms, 1.5-2.5 ms), ``kernels`` as
    ``(name, start_us, end_us)``."""
    us = 1000
    return {
        "requests": [(trace.REQUEST, 0, 1000 * us), (trace.REQUEST, 1500 * us, 2500 * us)],
        "kernels": [(n, s * us, e * us) for n, s, e in kernels],
        "copies": [],
        "host_ops": [],
    }


def read(rec, cell="sift1m.ivf_flat"):
    reader = harness.load_module("layer_metrics", "ivf_rescore_ms_per_batch")
    return reader.read(rec, harness.load_cell(cell))


def test_reader_sums_the_ivf_rescore_kernel_alone_over_the_requests():
    rec = records([(OTHERS[1], 100, 400), (IVF_SIFT, 400, 520), (OTHERS[4], 520, 600),
                   (K6_SIFT, 600, 700), (IVF_WIDE, 1600, 1700), (OTHERS[3], 1700, 1750)])
    assert read(rec) == pytest.approx((0.12 + 0.1) / 2)


@pytest.mark.parametrize("name", OTHERS)
def test_pattern_matches_no_other_kernel(name):
    reader = harness.load_module("layer_metrics", "ivf_rescore_ms_per_batch")
    assert not reader.PATTERN.search(name)
    assert reader.PATTERN.search(IVF_SIFT) and reader.PATTERN.search(IVF_WIDE)


@pytest.mark.parametrize("name", [IVF_SIFT, IVF_WIDE])
def test_k6_reader_does_not_count_the_ivf_kernel(name):
    k6 = harness.load_module("layer_metrics", "k6_ms_per_batch")
    assert not k6.PATTERN.search(name)


@pytest.mark.parametrize("cell", ["sift1m.exact", "msmarco100k.exact", "sift1m.ivf_flat",
                                  "glove50.hnsw"])
def test_reader_is_none_without_the_kernel(cell):
    """The parent's program, and the cells whose path has no IVF stage 3."""
    rec = records([(n, 100 + 50 * i, 140 + 50 * i) for i, n in enumerate(OTHERS)])
    assert read(rec, cell) is None
    assert read(records([]), cell) is None


def test_metric_is_a_benchmark_entry_of_the_ivf_cell():
    entry = next(m for m in harness.benchmark()["per_layer"]
                 if m["name"] == "ivf_rescore_ms_per_batch")
    assert entry == {"name": "ivf_rescore_ms_per_batch", "unit": "ms", "better": "lower",
                     "source": "device_trace",
                     "layer": "search ops (ops/distances, ops/ivf, ops/pq)",
                     "moves": "qps", "workloads": ["sift1m.ivf_flat"]}
    assert "ivf_rescore_ms_per_batch" in harness.metric_names("sift1m.ivf_flat", True)
    for cell in ("sift1m.exact", "msmarco100k.exact", "glove50.hnsw"):
        assert "ivf_rescore_ms_per_batch" not in harness.metric_names(cell, True)
