"""The port's block beam on the GloVe-50 surrogate, on the CPU: the same
walk as the plain float64 beam of ``retrieval_bench/plain_block_beam.py``
on the port's own layout (cosine and l2, one to four waves, so that the
frontier's push runs), the layout as the plain checks read it, the
benchmark's frozen generator against the port's loader, and the beam's
spans (``vrt.seed``, ``vrt.wave``) under ``torch.profiler``."""

import numpy as np
import pytest
import torch

from retrieval_bench import harness, trace
from retrieval_bench import plain_block_beam as plain
from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.models import get_algorithm_instance
from vectordb_retrieval_tpu_torch.models import graph as gm
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import graph as gops

torch.set_num_threads(4)

GEN = harness.load_module("generators", "glove50_surrogate")
# the rule of the probes' agree_where_distinct: a rank is certain where its
# float64 distance lies more than this share from both neighbours'
TIE_REL = 2.0 ** -21
K = 10
QUERIES = 128
_BUILT = {}


def _built(rows, block_size, ef, metric):
    """The port's block graph over ``rows`` surrogate rows, its normalised
    corpus and queries, and its beam geometry at ``ef`` (one build a
    layout, shared by the efSearch cases)."""
    key = (rows, block_size, metric)
    if key not in _BUILT:
        x, q = GEN.generate(11, rows, QUERIES)
        indexer = {"type": "GraphIndexer", "metric": metric, "mode": "block"}
        if block_size:
            indexer["block_size"] = block_size
        algo = get_algorithm_instance("composite", dimension=50, device="cpu", metric=metric,
                                      indexer=indexer, searcher={"type": "ANNSearcher",
                                                                 "metric": metric})
        algo.build_index(x)
        xs, qs = torch.as_tensor(x), torch.as_tensor(q)
        if metric == "cosine":
            xs, qs = dops.normalize(xs), dops.normalize(qs)
        _BUILT[key] = (algo, xs, qs, q)
    algo, xs, qs, q = _BUILT[key]
    meta = algo.artifact.metadata
    geom = gm.block_geometry(meta["n_blocks"], ef, K, meta["block_len"])
    return algo, xs, qs, q, geom


def _program_pops(layout, qs, geom, metric):
    """The entries the port's beam pops, query by query and wave by wave."""
    efb, expand, iters = geom
    beam = gops.BlockBeam(qs, layout["entries"], layout["entry_block"], layout["slot_ids"],
                          layout["list_vecs"], layout["list_sqnorms"], layout["entry_adj"],
                          layout.get("list_mu"), k=K, efb=efb, expand=expand, iters=iters,
                          metric=metric)
    st, pops = beam.seed(), []
    for t in range(iters):
        st, p = beam.pop(st, t)
        pops.append(torch.where(p.sel_valid, p.sel_entries, -1).tolist())
        st = beam.merge(st, p, beam.score(p))
        if t < iters - 1:
            st = beam.push(st, p)
    return [[sorted(e for e in pops[t][j] if e >= 0) for t in range(iters)]
            for j in range(qs.shape[0])]


# (rows, block size, efSearch, waves): 60,000 rows make 235 blocks of 256,
# one wave at efSearch 100 and two at 200; 20,000 rows in 64-row blocks
# make 313 blocks and four waves
CASES = [(60_000, 0, 100, 1), (60_000, 0, 200, 2), (20_000, 64, 200, 4)]


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("rows,block_size,ef,waves", CASES)
def test_the_block_beam_walks_as_the_plain_beam(rows, block_size, ef, waves, metric):
    algo, xs, qs, q, geom = _built(rows, block_size, ef, metric)
    efb, expand, iters = geom
    assert iters == waves
    algo.searcher.params["efSearch"] = ef
    got_d, got_i = algo.batch_search(q, K)
    layout = algo.artifact.data
    score = "ip" if metric == "cosine" else "l2"
    ref_d, ref_i, ref_pops = plain.walk(layout, qs, K + 1, efb, expand, iters, score)
    assert _program_pops(layout, qs, geom, score) == [[sorted(w) for w in p] for p in ref_pops]
    certain = plain.certain(ref_d, TIE_REL).numpy()
    assert certain.mean() > 0.9
    assert (got_i[certain] == ref_i[:, :K].numpy()[certain]).all()
    ref = ref_d[:, :K].numpy()
    assert np.abs(got_d - ref).max() <= 1e-5 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_the_layout_passes_the_plain_checks(metric):
    algo, xs, _, _, _ = _built(60_000, 0, 200, metric)
    checks = plain.check_layout(algo.artifact.data, xs)
    assert checks == dict.fromkeys(checks, True) and len(checks) == 5


@pytest.mark.parametrize("fault,fails", [
    ("row_moved", "decoded"), ("slab_value", "decoded"), ("entry", "entry_means"),
    ("row_twice", "rows_once")])
def test_the_plain_checks_refuse_a_planted_fault(fault, fails):
    algo, xs, _, _, _ = _built(60_000, 0, 200, "cosine")
    layout = dict(algo.artifact.data)
    if fault in ("row_moved", "row_twice"):
        slots = layout["slot_ids"].clone()
        a, b = int(slots[3, 5]), int(slots[100, 7])
        slots[3, 5] = b  # row b now also, or only, claims slot (3, 5)
        if fault == "row_moved":
            slots[100, 7] = a
        layout["slot_ids"] = slots
    elif fault == "slab_value":
        vecs = layout["list_vecs"].clone()
        vecs[7, 11, 13] += 4 * torch.finfo(torch.bfloat16).eps * vecs[7, 11, 13].abs().clamp(min=0.1)
        layout["list_vecs"] = vecs
    else:
        entries = layout["entries"].clone()
        entries[5, 0] += 1e-4
        layout["entries"] = entries
    checks = plain.check_layout(layout, xs)
    assert not checks[fails], checks


@pytest.mark.parametrize("options", [
    {}, {"background_frac": 0.1, "anisotropy": 0.3, "n_parents": 40}])
def test_the_generator_is_the_ports_loader(tmp_path, options):
    cfg = harness.load_json("configs", "glove50.json")
    opts = dict(cfg["generator_options"], **options)
    ds = Dataset("glove50_surrogate", str(tmp_path),
                 dict(opts, train_limit=1500, test_size=30, seed=9, use_cache=False,
                      ground_truth_k=5), device="cpu").load()
    corpus, pool = GEN.generate(9, 1500, 30, **opts)
    assert corpus.dtype == ds.train_vectors.dtype == np.float32
    assert corpus.tobytes() == ds.train_vectors.tobytes()
    assert pool.tobytes() == ds.test_vectors.tobytes()
    other, pool_b = GEN.generate(9, 1500, 30, pool_seed=4, **opts)
    assert other.tobytes() == corpus.tobytes() and pool_b.shape == pool.shape
    assert not np.array_equal(pool_b, pool)


def _traced(algo, q):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.REQUEST):
            out = algo.batch_search(q, K)
    rec = trace.collect(prof)
    return out, [(n, s, e) for n, s, e in rec["host_ops"] if n.startswith("vrt.")], rec


@pytest.mark.parametrize("rows,block_size,ef,waves", CASES)
def test_the_beams_spans_nest_inside_search(rows, block_size, ef, waves):
    algo, _, _, q, _ = _built(rows, block_size, ef, "cosine")
    algo.searcher.params["efSearch"] = ef
    off = algo.batch_search(q[:32], K)
    (d, i), spans, rec = _traced(algo, q[:32])
    assert [n for n, _, _ in spans] == (["vrt.h2d", "vrt.search", "vrt.seed"]
                                        + ["vrt.wave"] * waves + ["vrt.d2h"])
    search = spans[1]
    inner = spans[2:-1]
    assert all(search[1] <= s <= e <= search[2] for _, s, e in inner)
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))  # one after another
    request = rec["requests"][0]
    assert all(request[1] <= s <= e <= request[2] for _, s, e in spans)
    assert d.tobytes() == off[0].tobytes() and i.tobytes() == off[1].tobytes()
