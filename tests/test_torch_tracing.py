"""The port's spans (``utils/profiling.span``) on the CPU: free with no
profiler running, and under ``torch.profiler`` one event per stage of the
search path, nested as the code nests them, found by the benchmark's
``retrieval_bench.trace.collect`` among the host's operators."""

import os
import re

import numpy as np
import pytest
import torch

from retrieval_bench import trace
from vectordb_retrieval_tpu_torch.models import get_algorithm_instance
from vectordb_retrieval_tpu_torch.ops import distances as tdist
from vectordb_retrieval_tpu_torch.ops import ivf as tivf
from vectordb_retrieval_tpu_torch.utils import profiling

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "vectordb_retrieval_tpu_torch")


def _exact_algo(n=40_000, d=16, metric="l2"):
    rows = np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)
    algo = get_algorithm_instance(
        "composite", dimension=d, device="cpu", metric=metric,
        indexer={"type": "BruteForceIndexer"}, searcher={"type": "LinearSearcher"})
    algo.build_index(rows)
    return algo


def _ivf_algo(exact_rescore, n=4000, d=16):
    rows = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    algo = get_algorithm_instance(
        "composite", dimension=d, device="cpu", metric="l2",
        indexer={"type": "FactoryIndexer", "index_key": "IVF16,Flat", "nprobe": 4, "seed": 1,
                 "exact_rescore": exact_rescore},
        searcher={"type": "ANNSearcher", "nprobe": 4})
    algo.build_index(rows)
    return algo


def _queries(d=16, b=32, seed=2):
    return np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)


def _traced(algo, q, k):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.REQUEST):
            out = algo.batch_search(q, k)
    return out, trace.collect(prof)


def _spans(rec):
    return [(n, s, e) for n, s, e in rec["host_ops"] if n.startswith("vrt.")]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("vrt.search"), profiling.span("vrt.h2d")
    assert a is b is profiling._NO_SPAN
    with a:
        pass


def test_an_unknown_span_name_raises_under_the_profiler():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="vrt.nothing"):
            profiling.span("vrt.nothing")


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_exact_blockmin_search_spans_in_order_inside_the_request(metric, monkeypatch):
    calls = []
    blockmin = tdist._exact_search_blockmin
    monkeypatch.setattr(tdist, "_exact_search_blockmin",
                        lambda *a, **k: calls.append(1) or blockmin(*a, **k))
    _, rec = _traced(_exact_algo(metric=metric), _queries(), 10)
    assert calls == [1]  # n > 32,768: the blockmin path
    spans = _spans(rec)
    assert [n for n, _, _ in spans] == ["vrt.h2d", "vrt.search", "vrt.rescore", "vrt.d2h"]
    (request,) = rec["requests"]
    h2d, search, rescore, d2h = spans
    assert all(_inside(s, request) for s in spans)
    assert _inside(rescore, search)
    assert h2d[2] <= search[1] and search[2] <= d2h[1]


@pytest.mark.parametrize("exact_rescore,rescores", [(False, 1), (True, 2)])
def test_ivf_flat_fused_stream_spans_nest_inside_search(exact_rescore, rescores, monkeypatch):
    calls = []
    fused = tivf._fused_stream
    monkeypatch.setattr(tivf, "_fused_stream",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    algo = _ivf_algo(exact_rescore)
    assert algo.artifact.data["list_vecs"].dtype == torch.bfloat16
    assert ("full_vectors" in algo.artifact.data) == exact_rescore
    _, rec = _traced(algo, _queries(), 10)
    assert calls == [1]  # the fused probed stream
    spans = _spans(rec)
    names = [n for n, _, _ in spans]
    assert names == ["vrt.h2d", "vrt.search", "vrt.probe"] + ["vrt.rescore"] * rescores + ["vrt.d2h"]
    (request,) = rec["requests"]
    search = spans[1]
    assert all(_inside(s, request) for s in spans)
    assert all(_inside(s, search) for s in spans[2:-1])
    inner = spans[2:-1]
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))  # one after another


HOST_ENTRY = {
    "linear": dict(algorithm_type="composite", indexer={"type": "BruteForceIndexer"},
                   searcher={"type": "LinearSearcher"}),
    "ivf_flat": dict(algorithm_type="composite",
                     indexer={"type": "FactoryIndexer", "index_key": "IVF2,Flat", "nprobe": 2,
                              "seed": 1},
                     searcher={"type": "ANNSearcher", "nprobe": 2}),
    "lsh": dict(algorithm_type="lsh", num_tables=4, hash_size=4),
    "covertree": dict(algorithm_type="covertree"),
}


@pytest.mark.parametrize("kind", list(HOST_ENTRY))
def test_every_searcher_shares_one_host_entry(kind):
    """``models/base.host_search`` is every searcher's host entry and the
    cover tree's: the upload, the search and the copy back as ``vrt.h2d``,
    ``vrt.search`` and ``vrt.d2h`` in order inside the request, float32
    dists and int64 ids on the host, padded to ``k`` with inf / -1 past
    the index's rows; the cover tree records its walk's ``ndis`` (plus a
    full scan a flagged row) once a call."""
    n, d, k = 24, 8, 32
    rows = np.random.default_rng(3).standard_normal((n, d)).astype(np.float32)
    spec = dict(HOST_ENTRY[kind])
    algo = get_algorithm_instance(spec.pop("algorithm_type"), dimension=d, device="cpu",
                                  metric="l2", **spec)
    algo.build_index(rows)
    q = _queries(d=d, b=5, seed=4)
    if kind == "covertree":
        _, _, ndis, n_flagged = algo._answer(torch.from_numpy(q), k)
        want_ndis = int(ndis.sum()) + n_flagged * n
        algo.reset_operations()
    (dists, ids), rec = _traced(algo, q, k)
    names = [n for n, _, _ in _spans(rec)]
    assert names[:2] == ["vrt.h2d", "vrt.search"] and names[-1] == "vrt.d2h"
    assert names.count("vrt.h2d") == names.count("vrt.search") == names.count("vrt.d2h") == 1
    (request,) = rec["requests"]
    assert all(_inside(s, request) for s in _spans(rec))
    assert dists.dtype == np.float32 and ids.dtype == np.int64
    assert dists.shape == ids.shape == (5, k)
    assert np.isinf(dists[:, n:]).all() and (ids[:, n:] == -1).all()
    assert (ids[:, :1] >= 0).all() and np.isfinite(dists[:, :1]).all()
    if kind == "covertree":
        assert algo.get_operations() == {"ndis": want_ndis}
        assert algo._ndis_per_query == int(ndis.sum()) / 5


@pytest.mark.parametrize("kind", ["exact", "ivf_bf16", "ivf_rescored"])
def test_answers_are_bit_identical_with_the_profiler_on_and_off(kind):
    algo = {"exact": _exact_algo, "ivf_bf16": lambda: _ivf_algo(False),
            "ivf_rescored": lambda: _ivf_algo(True)}[kind]()
    q = _queries(seed=5)
    d_off, i_off = algo.batch_search(q, 10)
    (d_on, i_on), rec = _traced(algo, q, 10)
    assert _spans(rec)
    assert d_on.tobytes() == d_off.tobytes() and i_on.tobytes() == i_off.tobytes()
    assert d_on.dtype == d_off.dtype and i_on.dtype == i_off.dtype


def test_every_span_name_in_the_source_is_in_spans_and_perf_md():
    used = set()
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    used |= set(re.findall(r"""\bspan\(\s*["'](vrt\.[\w.]+)["']""", fh.read()))
    assert used and used <= set(profiling.SPANS)
    assert used == set(profiling.SPANS)  # no name in SPANS goes unused
    with open(os.path.join(REPO, "PERF.md")) as fh:
        perf = fh.read()
    assert all(f"`{name}`" in perf for name in profiling.SPANS)
