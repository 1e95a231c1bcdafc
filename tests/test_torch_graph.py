"""The port's graph family (ops/graph.py, models/graph.py) against the JAX
package's, on the CPU.

Searches run on artifacts the JAX package built, handed to both packages as
the same arrays (bf16 kept bit for bit): the block beam with f32 and bf16
slabs, l2 and ip, one and three waves, and a spilled layout; the node beam
with no table, a bf16 table and an SQ8 table. Ids must be equal as sorted
sets per query (clustered, tie-free data); distances within 1e-5 relative
to the largest (f32 sums taken in another order). Build parts run on the
same inputs in both packages, the block layout from the same centroids
(k-means inits differ: ``jax.random`` against a ``torch.Generator``), and
end to end the two packages' recalls agree within 0.02.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectordb_retrieval_tpu.bench.metrics import recall_at_k
from vectordb_retrieval_tpu.data import datasets as jdata
from vectordb_retrieval_tpu.models import graph as jmg
from vectordb_retrieval_tpu.models.composite import CompositeAlgorithm as JaxComposite
from vectordb_retrieval_tpu.ops import graph as jg
from vectordb_retrieval_tpu.ops import kmeans as jkm
from vectordb_retrieval_tpu_torch.data import datasets as tdata
from vectordb_retrieval_tpu_torch.models import get_algorithm_instance
from vectordb_retrieval_tpu_torch.models import graph as tmg
from vectordb_retrieval_tpu_torch.models.base import leaf_to_tensor
from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.ops import graph as tg
from vectordb_retrieval_tpu_torch.ops import kernels as tkn
from vectordb_retrieval_tpu_torch.ops import kmeans as tkm

torch.set_num_threads(2)
CPU = torch.device("cpu")
K = 10


def _t(a):
    """A numpy (or JAX) array as a CPU tensor, bf16 kept bit for bit."""
    return leaf_to_tensor("a", np.asarray(a), CPU)[1]


def _clustered(seed, n=3000, d=32, n_clusters=40, nq=24):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 1.5
    x = centers[rng.integers(0, n_clusters, n)] + 0.6 * rng.standard_normal((n, d))
    x = x.astype(np.float32)
    q = x[rng.choice(n, nq, replace=False)] + 0.3 * rng.standard_normal((nq, d))
    return x, q.astype(np.float32)


def _exact_ids(x, q, k, metric="l2"):
    if metric == "l2":
        d = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    else:
        d = -(q.astype(np.float64) @ x.T.astype(np.float64))
    return np.argsort(d, axis=1)[:, :k]


def _assert_same(got, want):
    gd, gi = (v.numpy() for v in got)
    wd, wi = (np.asarray(v) for v in want)
    assert gi.shape == wi.shape
    np.testing.assert_array_equal(np.sort(gi, 1), np.sort(wi, 1))
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    scale = np.abs(wd[fin]).max()
    np.testing.assert_allclose(np.sort(gd, 1)[fin], np.sort(wd, 1)[fin],
                               rtol=0, atol=1e-5 * scale)


@pytest.fixture(scope="module")
def data():
    return _clustered(5)


@pytest.fixture(scope="module")
def block_parts(data):
    """JAX-built block layouts: f32 and bf16 slabs, and a spilled one."""
    x, _ = data
    jx = jnp.asarray(x)
    return {
        "f32": jg.build_block_graph(jx, 60, 8, slab_dtype="f32"),
        "bf16": jg.build_block_graph(jx, 60, 8, slab_dtype="bf16"),
        "spill": jg.build_block_graph(jx, 60, 8, spill=0.2, slab_dtype="bf16"),
    }


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("slab", ["f32", "bf16", "spill"])
def test_block_graph_search_matches_jax(data, block_parts, slab, metric, iters):
    _, q = data
    parts = block_parts[slab]
    kw = dict(k=K, efb=24, expand=6, iters=iters, metric=metric, dedup=slab == "spill")
    want = jg.block_graph_search(jnp.asarray(q), *parts, **kw)
    got = tg.block_graph_search(_t(q), *[None if p is None else _t(p) for p in parts], **kw)
    _assert_same(got, want)
    assert (slab == "f32") == (parts[6] is None)
    for row in got[1].numpy():  # no row id twice, clones included
        assert len(set(row[row >= 0].tolist())) == (row >= 0).sum()


def test_block_beam_stages_compose_to_the_search(data, block_parts):
    """The stages, run by hand, give the search's result; each is a
    function of its inputs (running it again changes nothing)."""
    _, q = data
    parts = [_t(p) for p in block_parts["bf16"]]
    beam = tg.BlockBeam(_t(q), *parts, k=K, efb=24, expand=6, iters=2)
    st = beam.seed()
    st1, p = beam.pop(st, 0)
    again, _ = beam.pop(st, 0)
    assert all(torch.equal(a, b) for a, b in zip(st1, again))
    dots = beam.score(p)
    assert torch.equal(dots, beam.score(p))
    st2 = beam.push(beam.merge(st1, p, dots), p)
    st3, p2 = beam.pop(st2, 1)
    got = beam.result(beam.merge(st3, p2, beam.score(p2)))
    want = tg.block_graph_search(_t(q), *parts, k=K, efb=24, expand=6, iters=2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # popped blocks are recorded as visited, never probed twice
    vis = st3.visited.numpy()
    for row in vis:
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row)


def test_block_graph_search_on_cpu_is_the_eager_beam(data, block_parts):
    """CPU tensors take the eager beam, and count as eager calls."""
    _, q = data
    parts = [_t(p) for p in block_parts["bf16"]]
    kw = dict(k=K, efb=24, expand=6, iters=2, metric="ip")
    before = dict(tkn.BEAM_CALLS)
    got = tg.block_graph_search(_t(q), *parts, **kw)
    want = tg.BlockBeam(_t(q), *parts, **kw).run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tkn.BEAM_CALLS == dict(before, eager=before["eager"] + 1)


_GEOMETRY = dict(k=K, efb=24, expand=6, iters=2, metric="l2", dedup=False)
# one change at a time: the batch shape, each geometry parameter, each
# index tensor replaced by an equal copy (another address)
_KEY_CHANGES = (
    ["rows", "width"] + [f"geometry:{g}" for g in _GEOMETRY]
    + [f"index:{i}" for i in range(7)]
)


@pytest.mark.parametrize("change", _KEY_CHANGES)
def test_graph_key_tells_apart_what_a_capture_reads(data, block_parts, change):
    _, q = data
    parts = [_t(p) for p in block_parts["bf16"]]
    queries = _t(q)
    key = tg.graph_key(queries, parts, **_GEOMETRY)
    # a new batch of the same shape over the same index: the same key
    assert tg.graph_key(queries + 1.0, parts, **_GEOMETRY) == key
    other_q, other_parts, other_geom = queries, list(parts), dict(_GEOMETRY)
    if change == "rows":
        other_q = queries[:-1]
    elif change == "width":
        other_q = torch.cat([queries, queries[:, :1]], dim=1)
    elif change.startswith("geometry:"):
        name = change.split(":")[1]
        flipped = {"metric": "ip", "dedup": True}
        other_geom[name] = flipped[name] if name in flipped else other_geom[name] + 1
    else:
        i = int(change.split(":")[1])
        other_parts[i] = parts[i].clone()
    assert tg.graph_key(other_q, other_parts, **other_geom) != key


def test_no_capture_on_the_cpu_or_inside_a_work_count():
    assert not tg.graphs_allowed(CPU)
    with tkn.count_work():  # its slab count reads the card: a synchronisation
        assert not tg.graphs_allowed(torch.device("cuda"))


def test_a_key_ends_with_its_list_vecs_and_the_oldest_goes_first():
    import gc

    saved = dict(tg._GRAPHS)
    try:
        tg._GRAPHS.clear()
        owners = [torch.zeros(2) for _ in range(tg._GRAPH_KEYS + 1)]
        for i, owner in enumerate(owners):
            tg._seen(("key", i), owner)
        assert list(tg._GRAPHS) == [("key", i) for i in range(1, tg._GRAPH_KEYS + 1)]
        del owner
        owners.pop(3)
        gc.collect()
        assert ("key", 3) not in tg._GRAPHS
        assert len(tg._GRAPHS) == tg._GRAPH_KEYS - 1
        owners.pop(0)  # its key was dropped already: its finalizer is detached
        gc.collect()
        assert len(tg._GRAPHS) == tg._GRAPH_KEYS - 1
    finally:
        for fin, _ in tg._GRAPHS.values():
            fin.detach()
        tg._GRAPHS.clear()
        tg._GRAPHS.update(saved)


@pytest.fixture(scope="module")
def node_graph(data):
    x, _ = data
    jx = jnp.asarray(x)
    adj = jg.build_knn_graph(jx, 16, reverse_edges=16)
    entries = jg.pick_entry_points(jx, 64, seed=0)
    tables = {
        "bf16": jg.build_neighbor_table(jx, adj, dtype=jnp.bfloat16),
        "int8": jg.build_neighbor_table(jx, adj, dtype="int8"),
    }
    return adj, entries, tables


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("table", ["none", "bf16", "int8"])
def test_graph_search_matches_jax(data, node_graph, table, metric):
    x, q = data
    adj, entries, tables = node_graph
    jkw = dict(ef=48, expand=6, iters=4, metric=metric, cand_keep=36)
    tkw = dict(jkw)
    if table != "none":
        vecs, sqn, vmin, step = tables[table]
        jkw.update(nbr_vecs=vecs, nbr_sqn=sqn, nbr_vmin=vmin, nbr_step=step, rescore=True)
        tkw.update(nbr_vecs=_t(vecs), nbr_sqn=_t(sqn), rescore=True,
                   nbr_vmin=None if vmin is None else _t(vmin),
                   nbr_step=None if step is None else _t(step))
    want = jg.graph_search(jnp.asarray(q), jnp.asarray(x), adj, entries, K, **jkw)
    got = tg.graph_search(_t(q), _t(x), _t(adj), _t(entries), K, **tkw)
    _assert_same(got, want)
    if table == "int8":
        assert tkw["nbr_vecs"].dtype == torch.uint8


def test_node_beam_stages_compose_to_the_search(data, node_graph):
    x, q = data
    adj, entries, _ = node_graph
    beam = tg.NodeBeam(_t(q), _t(x), _t(adj), _t(entries), K, ef=48, expand=6, iters=3)
    st = beam.seed()
    for _ in range(3):
        nxt = beam.step(st)
        assert all(torch.equal(a, b) for a, b in zip(nxt, beam.step(st)))
        st = nxt
    got = beam.result(st)
    want = tg.graph_search(_t(q), _t(x), _t(adj), _t(entries), K, ef=48, expand=6, iters=3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---- build parts -----------------------------------------------------------


def test_diversify_batch_matches_jax(data):
    x, _ = data
    rng = np.random.default_rng(1)
    nodes = rng.choice(x.shape[0], 64, replace=False)
    d2 = ((x[nodes, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    d2[np.arange(64), nodes] = np.inf
    cand = np.argsort(d2, axis=1)[:, :24].astype(np.int32)
    cd2 = np.take_along_axis(d2, cand, 1).astype(np.float32)
    for degree in (4, 8, 16):
        want = np.asarray(jg._diversify_batch(
            jnp.asarray(cand), jnp.asarray(cd2), jnp.asarray(x[cand]), degree))
        got = tg._diversify_batch(_t(cand), _t(cd2), _t(x[cand]), degree).numpy()
        np.testing.assert_array_equal(got, want)


def test_add_reverse_edges_matches_jax(data):
    x, _ = data
    rng = np.random.default_rng(2)
    adj = rng.integers(0, 400, (400, 6)).astype(np.int32)
    adj[rng.random(adj.shape) < 0.1] = -1  # pad slots
    for rev in (1, 4, 9):
        want = jg.add_reverse_edges(adj, jnp.asarray(x[:400]), rev)
        got = tg.add_reverse_edges(adj, _t(x[:400]), rev)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the JAX test's orphan: row 3 has no incoming edge until reverse edges
    small = np.array([[1, 2], [0, 2], [0, 1], [0, 1]], dtype=np.int32)
    pts = np.array([[0.0, 0], [1, 0], [0, 1], [5, 5]], dtype=np.float32)
    for rev in (2, 3):
        np.testing.assert_array_equal(
            tg.add_reverse_edges(small, _t(pts), rev),
            jg.add_reverse_edges(small, jnp.asarray(pts), rev))
    aug = tg.add_reverse_edges(small, _t(pts), 3)
    assert 3 in aug[0] and 3 in aug[1]


def test_build_knn_graph_matches_jax(data):
    x, _ = data
    sub = x[:1500]
    for reverse in (0, 8):
        want = np.asarray(jg.build_knn_graph(jnp.asarray(sub), 12, reverse_edges=reverse))
        got = tg.build_knn_graph(_t(sub), 12, reverse_edges=reverse)
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        assert (got.numpy() == want).all(axis=1).mean() >= 0.99


def test_ivf_candidate_build_recall():
    """IVF-probe candidates (``method='ivf'``): the graph keeps the JAX
    test's recall floor."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4000, 32)).astype(np.float32)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    adj = tg.build_knn_graph(_t(x), 16, method="ivf", build_nprobe=8, build_nlist=32)
    assert tuple(adj.shape) == (4000, 16)
    assert ((adj >= 0) & (adj < 4000)).all()
    entries = tg.pick_entry_points(_t(x), 64, seed=0)
    _, ids = tg.graph_search(_t(q), _t(x), adj, entries, K, ef=96, expand=16, iters=4,
                             cand_keep=64)
    assert recall_at_k(_exact_ids(x, q, K), ids.numpy(), K) > 0.85


def test_kmeans_assign2_matches_jax(data):
    x, _ = data
    c = x[::100][:24] + 0.01
    a1, a2, m = jkm.kmeans_assign2(jnp.asarray(x), jnp.asarray(c), chunk=700)
    t1, t2, tm = tkm.kmeans_assign2(_t(x), _t(c), chunk=700)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(a2))
    m = np.asarray(m)
    np.testing.assert_allclose(tm.numpy(), m, rtol=0, atol=1e-5 * np.abs(m).max())
    assert (tm >= 0).all()


@pytest.mark.parametrize("slab", ["f32", "bf16"])
def test_encode_slabs_within_one_bf16_ulp(data, slab):
    x, _ = data
    rng = np.random.default_rng(3)
    slots = rng.permutation(3000)[:2560].reshape(20, 128).astype(np.int32)
    slots[-1, 100:] = -1
    mask = (slots >= 0)[:, :, None]
    vecs = x[np.maximum(slots, 0)] * mask
    jv, js, jm = jg._encode_slabs(jnp.asarray(vecs), jnp.asarray(mask), slab)
    tv, ts, tm = tg._encode_slabs(_t(vecs), _t(mask), slab)
    # norms of the reconstructed rows: a residual one bf16 step apart moves
    # a row's norm by up to ~2^-8 of that element's share
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5 if slab == "f32" else 1e-4)
    if slab == "f32":
        assert tm is None and jm is None
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        return
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    assert tv.dtype == torch.bfloat16
    got = tv.view(torch.int16).numpy().astype(np.int64)
    want = np.asarray(jv).view(np.int16).astype(np.int64)
    assert np.abs(got - want).max() <= 1  # same sign, so one step of the bits
    assert (got != want).mean() < 0.01


@pytest.mark.parametrize("spill", [0.0, 0.2])
@pytest.mark.parametrize("slab", ["f32", "bf16"])
def test_block_layout_from_same_centroids(data, monkeypatch, slab, spill):
    """From the same centroids both packages lay out the same blocks."""
    x, _ = data
    cents = x[np.random.default_rng(6).choice(3000, 60, replace=False)]
    monkeypatch.setattr(jkm, "kmeans_fit", lambda *a, **k: (jnp.asarray(cents), 0.0))
    want = [None if p is None else np.asarray(p) for p in jg.build_block_graph(
        jnp.asarray(x), 60, 8, spill=spill, slab_dtype=slab)]
    got = tg._block_layout(_t(x), _t(cents), 8, spill=spill, slab_dtype=slab)
    entries, entry_block, slot_ids, list_vecs, list_sqn, adj, mu = got
    if spill == 0.0:
        np.testing.assert_array_equal(slot_ids.numpy(), want[2])
        np.testing.assert_array_equal(entry_block.numpy(), want[1])
        np.testing.assert_allclose(entries.numpy(), want[0], rtol=0, atol=1e-6)
        assert (adj.numpy() == want[5]).mean() >= 0.999
        assert slot_ids.dtype == entry_block.dtype == adj.dtype == torch.int32
    else:
        # the clone set is the lowest-margin rows: margins from another
        # product order may swap rows at the cut
        assert slot_ids.shape == want[2].shape
        assert (slot_ids.numpy() == want[2]).mean() >= 0.99
    assert (mu is None) == (want[6] is None) == (slab == "f32")
    assert str(list_vecs.dtype).split(".")[-1] == str(want[3].dtype)


def test_geometry_rules_equal():
    for n in (100, 5_000, 50_001, 200_000, 600_000):
        for degree in (8, 32, 64):
            for ef in (10, 64, 100, 400):
                for k in (1, 10, 100):
                    assert tmg.beam_geometry(n, degree, ef, k) == jmg.beam_geometry(n, degree, ef, k)
    for nb in (12, 40, 782, 3907):
        for ef in (8, 32, 64, 100, 400):
            for length in (16, 128, 256):
                assert tmg.block_geometry(nb, ef, 20, length) == jmg.block_geometry(nb, ef, 20, length)
    for kw in ({}, {"slab_dtype": "f32"}, {"block_size": 100}):
        ti, ji = tmg.GraphIndexer(device="cpu", **kw), jmg.GraphIndexer(**kw)
        for n in (10, 3000, 100_000, 1_000_000):
            for d in (32, 128, 384):
                assert ti._block_geom(n, d) == ji._block_geom(n, d)
    assert tmg.block_geometry(782, 100, 20, 128)[1:] == (96, 2)  # MS MARCO geometry


def test_pick_entry_points_from_the_same_centers(data, monkeypatch):
    """From the same k-means centers: the nearest rows, sorted, unique and
    padded with -1 (duplicated centers collapse onto one row)."""
    x, _ = data
    cents = np.concatenate([x[:20] + 0.01, x[:12] + 0.02])  # 12 duplicates
    monkeypatch.setattr(jkm, "kmeans_fit", lambda *a, **k: (jnp.asarray(cents), 0.0))
    monkeypatch.setattr(tkm, "kmeans_fit", lambda *a, **k: (_t(cents), 0.0))
    want = np.asarray(jg.pick_entry_points(jnp.asarray(x), 32))
    got = tg.pick_entry_points(_t(x), 32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[20:] == -1).all() and (got[:20] >= 0).all()
    np.testing.assert_array_equal(
        tg.pick_entry_points(_t(x), 1).numpy(), np.asarray(jg.pick_entry_points(jnp.asarray(x), 1)))


def test_streaming_block_build_names_its_roadmap_item(tmp_path):
    """The streaming block build of ROADMAP item 9b (once a stub that
    raised) runs on a memmap: a block-mode artifact marked
    built_streaming, its recall within 0.05 of the resident block build's
    on the same corpus, with the JAX package's streamed build beside it."""
    x, q = _clustered(6, n=4000)
    path = tmp_path / "corpus.bin"
    x.tofile(path)
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=x.shape)
    gt = _exact_ids(x, q, 10)
    recs = {}
    for name, vectors in (("stream", mm), ("resident", x)):
        algo = _block_algo(CompositeAlgorithm, mode="block")
        algo.build_index(vectors)
        recs[name] = recall_at_k(gt, algo.batch_search(q, 10)[1], 10)
        assert algo.artifact.metadata["mode"] == "block"
        assert algo.artifact.metadata.get("built_streaming", False) == (name == "stream")
    j = _block_algo(JaxComposite, mode="block")
    j.build_index(mm)
    recs["jax_stream"] = recall_at_k(gt, np.asarray(j.batch_search(q, 10)[1]), 10)
    assert recs["stream"] >= recs["resident"] - 0.05, recs
    assert recs["stream"] >= recs["jax_stream"] - 0.05, recs


# ---- end to end --------------------------------------------------------------


def _recall(algo, x, q, metric="l2"):
    algo.build_index(x)
    _, ids = algo.batch_search(q, K)
    return recall_at_k(_exact_ids(x, q, K, metric), ids, K), ids


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_hnsw_node_mode_recall_matches_jax(metric):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2000, 32)).astype(np.float32)
    q = rng.standard_normal((32, 32)).astype(np.float32)
    score = "l2"
    if metric == "cosine":  # ground truth on unit vectors
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        score = "ip"
    r_t, _ = _recall(get_algorithm_instance("hnsw", 32, metric=metric, M=16, efSearch=100,
                                            device="cpu"), x, q, score)
    from vectordb_retrieval_tpu.models import get_algorithm_instance as jax_get

    r_j, _ = _recall(jax_get("HNSW", 32, metric=metric, M=16, efSearch=100), x, q, score)
    assert r_t > 0.9 and abs(r_t - r_j) <= 0.02, (r_t, r_j)


def _block_algo(cls, **indexer):
    return cls(
        dimension=32,
        indexer={"type": "GraphIndexer", "M": 8, "mode": "block", "block_size": 16,
                 **indexer},
        searcher={"type": "ANNSearcher", "efSearch": 8},
        metric="l2",
        **({"device": "cpu"} if cls is CompositeAlgorithm else {}),
    )


def test_graph_indexer_block_mode_recall_matches_jax():
    """Block mode at a two-wave geometry (375 blocks of 16 rows, efSearch
    8: 124 probes in waves of 62)."""
    x, q = _clustered(9, n=6000, nq=32)
    port = _block_algo(CompositeAlgorithm)
    r_t, ids = _recall(port, x, q)
    meta = port.artifact.metadata
    assert meta["mode"] == "block" and meta["slab_dtype"] == "bfloat16"
    assert tmg.block_geometry(meta["n_blocks"], 8, K, meta["block_len"])[2] == 2
    assert port.artifact.data["list_vecs"].dtype == torch.bfloat16
    for row in ids:
        assert len(set(row.tolist())) == K
    r_j, _ = _recall(_block_algo(JaxComposite), x, q)
    assert abs(r_t - r_j) <= 0.02, (r_t, r_j)
    # the spilled layout: unique ids, recall not materially worse
    r_s, ids_s = _recall(_block_algo(CompositeAlgorithm, spill=0.2), x, q)
    for row in ids_s:
        assert len(set(row.tolist())) == K
    assert r_s >= r_t - 0.02


def test_auto_mode_follows_the_selfcheck(monkeypatch):
    x, _ = _clustered(10, n=3000)
    monkeypatch.setattr(tmg, "_BLOCK_AUTO_THRESHOLD", 1000)
    art = tmg.GraphIndexer(M=8, efSearch=64, device="cpu").build(x, 32)
    check = art.metadata["selfcheck_recall"]
    assert ("entries" in art.data) == (check >= 0.85)
    assert art.metadata["mode"] == "block"  # clustered data passes
    monkeypatch.setattr(tmg.GraphIndexer, "_block_selfcheck", lambda self, a, v: 0.5)
    art2 = tmg.GraphIndexer(M=8, efSearch=64, device="cpu").build(x, 32)
    assert "entries" not in art2.data and art2.data.get("adjacency") is not None
    art3 = tmg.GraphIndexer(M=8, efSearch=64, mode="block", device="cpu").build(x, 32)
    assert "entries" in art3.data and art3.metadata["selfcheck_recall"] == 0.5


def test_graph_searcher_ops_estimate_matches_jax():
    x, _ = _clustered(11, n=2000)
    from vectordb_retrieval_tpu.models.factory import ANNSearcher as JaxSearcher
    from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher

    for mode in ("node", "block"):
        port = CompositeAlgorithm(32, indexer={"type": "GraphIndexer", "mode": mode, "M": 8},
                                  searcher={"type": "ANNSearcher"}, device="cpu")
        port.build_index(x)
        js = JaxSearcher(efSearch=50)
        js.artifact = port.artifact
        ts = ANNSearcher(efSearch=50, device="cpu")
        ts.attach(port.artifact)
        assert ts.estimated_ops_per_query(2000) == js.estimated_ops_per_query(2000)


def test_msmarco_surrogate_loader_is_bit_identical(tmp_path):
    opts = {"train_limit": 1500, "test_size": 16, "ground_truth_k": 10, "use_cache": False}
    t = tdata.Dataset("msmarco_surrogate", str(tmp_path), dict(opts), device="cpu").load()
    j = jdata.Dataset("msmarco_surrogate", str(tmp_path), dict(opts)).load()
    assert t.train_vectors.dtype == np.float32 and t.train_vectors.shape == (1500, 384)
    np.testing.assert_array_equal(t.train_vectors, j.train_vectors)
    np.testing.assert_array_equal(t.test_vectors, j.test_vectors)
    # ground truth from two exact searches: near-tied cosine neighbours may
    # trade places at the k-th rank
    assert t.ground_truth.shape == j.ground_truth.shape == (16, 10)
    assert recall_at_k(j.ground_truth, t.ground_truth, 10) >= 0.99
    assert t.metric == j.metric == "cosine"
    for key in ("surrogate", "surrogate_for", "n_train", "n_test", "dimensions", "metric"):
        assert t.metadata[key] == j.metadata[key]
