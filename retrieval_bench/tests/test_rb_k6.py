"""k6_ms_per_batch's reader on synthetic records: it matches K6's kernel
names and no other kernel, and reads None where K6 did not run."""

import pytest

from retrieval_bench import harness, trace

K6_SIFT = ("void vrt::k6::block_rescore_kernel<32, 4, 1, true>(float const*, float const*, "
           "long const*, float*, long*, long long, int, int, int, long long, long long)")
K6_MSMARCO = ("void vrt::k6::block_rescore_kernel<8, 4, 3, false>(float const*, float const*, "
              "long const*, float*, long*, long long, int, int, int, long long, long long)")
OTHERS = [
    "void vrt::btc::blockmin_tc_kernel<(vrt::btc::Mode)2, 1>(vrt::btc::Params)",  # K1 f32
    "void vrt::btc::blockmin_tc_kernel<(vrt::btc::Mode)0, 1>(vrt::btc::Params)",  # K1 bf16
    "void vrt::slab_dots_kernel<true>(vrt::SlabParams)",  # K2
    "void vrt::matmul_floor_kernel<2>(vrt::FloorParams)",  # K5
    "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, "
    "long, long, long, bool)",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, float, float>::operator()"
    "(at::TensorIteratorBase&)::{lambda(float, float)#1}>, unsigned int, float, 4, 4> >"
    "(at::native::ReduceOp<float, at::native::func_wrapper_t<float, "
    "at::native::sum_functor<float, float, float>::operator()(at::TensorIteratorBase&)"
    "::{lambda(float, float)#1}>, unsigned int, float, 4, 4>)",
    "void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>(...)",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
    "at::native::BinaryFunctor<float, float, float, at::native::binary_internal::MulFunctor"
    "<float> > >(at::TensorIteratorBase&, at::native::BinaryFunctor<float, float, float, "
    "at::native::binary_internal::MulFunctor<float> > const&)::{lambda(int)#1}>(int, "
    "at::native::gpu_kernel_impl_nocast<...>::{lambda(int)#1})",
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


def read(rec, cell="sift1m.exact"):
    return harness.load_module("layer_metrics", "k6_ms_per_batch").read(rec, harness.load_cell(cell))


def test_k6_reader_sums_k6_alone_over_the_requests():
    rec = records([(OTHERS[0], 100, 400), (K6_SIFT, 400, 550), (OTHERS[5], 550, 600),
                   (K6_MSMARCO, 1600, 1650), (OTHERS[4], 1650, 1700)])
    assert read(rec) == pytest.approx((0.15 + 0.05) / 2)


@pytest.mark.parametrize("name", OTHERS)
def test_k6_pattern_matches_no_other_kernel(name):
    reader = harness.load_module("layer_metrics", "k6_ms_per_batch")
    assert not reader.PATTERN.search(name)
    assert reader.PATTERN.search(K6_SIFT) and reader.PATTERN.search(K6_MSMARCO)


@pytest.mark.parametrize("cell", ["sift1m.exact", "msmarco100k.exact", "sift1m.ivf_flat"])
def test_k6_reader_is_none_without_k6(cell):
    rec = records([(n, 100 + 50 * i, 140 + 50 * i) for i, n in enumerate(OTHERS)])
    assert read(rec, cell) is None
    assert read(records([]), cell) is None


def test_k6_metric_is_a_benchmark_entry_of_the_exact_cells():
    entry = next(m for m in harness.benchmark()["per_layer"] if m["name"] == "k6_ms_per_batch")
    assert entry["workloads"] == ["msmarco100k.exact", "sift1m.exact"]
    assert entry["moves"] == "qps" and entry["unit"] == "ms" and entry["source"] == "device_trace"
    assert "k6_ms_per_batch" in harness.metric_names("sift1m.exact", True)
    assert "k6_ms_per_batch" not in harness.metric_names("sift1m.ivf_flat", True)
