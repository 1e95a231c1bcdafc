"""The port's LSH family (ops/lsh.py, models/lsh.py, the ``binary_lsh`` kind
of ANNSearcher, the ``lsh`` / ``binary_lsh`` artifacts through persist.py)
against the JAX package's.

The same NumPy inputs, made from a seed, go through both packages on the
CPU. Where the inputs are integers every product is exact, and keys, packed
words, popcounts, votes and Hamming cuts must be bit for bit the JAX
package's, ties included (both keep equal scores in ascending row id). On
float inputs an f32 product summed in another order may move a value across
a cell or sign edge: keys must agree on >= 99.9 % of entries and every
mismatch must lie within 1e-5 relative of an edge. Reranked distances agree
to f32 rounding (rtol 1e-5); ids are compared where no distances tie
(random float data). Searches run on JAX-built artifacts carried across by
``models/persist.py`` (the projections come from ``jax.random`` in one
package and ``torch.Generator`` in the other, so builds differ by
construction); port builds are held by recall, within 0.02 of the JAX
package's at the same parameters.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vectordb_retrieval_tpu.bench.runner import BenchmarkRunner as JaxRunner
from vectordb_retrieval_tpu.models import get_algorithm_instance as jax_get
from vectordb_retrieval_tpu.models import lsh as jlsh
from vectordb_retrieval_tpu.models import persist as jpersist
from vectordb_retrieval_tpu.models.factory import ANNSearcher as JaxANNSearcher
from vectordb_retrieval_tpu.ops import lsh as jops
from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner
from vectordb_retrieval_tpu_torch.models import get_algorithm_instance
from vectordb_retrieval_tpu_torch.models import lsh as tlsh
from vectordb_retrieval_tpu_torch.models import persist as tpersist
from vectordb_retrieval_tpu_torch.models.base import artifact_from_numpy
from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher
from vectordb_retrieval_tpu_torch.ops import lsh as tops

torch.set_num_threads(2)
N, D, B, K = 3000, 24, 48, 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float keys: share of entries that must agree, and how near an edge a
# mismatch may lie (relative to the magnitude of the product's terms)
KEY_MIN_AGREE = 0.999
EDGE_RTOL = 1e-5
DIST_RTOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _u32(t):
    """Port words (int32) as the JAX package's uint32."""
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def jax_artifacts(data, tmp_path_factory):
    """JAX-built artifacts, each saved once with the JAX package's persist
    and loaded with the port's."""
    x, _ = data
    out = {}
    root = tmp_path_factory.mktemp("lsh_artifacts")
    specs = {
        "lsh_l2": jlsh.LSHIndexer(metric="l2", num_tables=6, hash_size=8, bucket_width=2.0),
        "lsh_cosine": jlsh.LSHIndexer(metric="cosine", num_tables=8, hash_size=10),
        "binary_l2": jlsh.BinaryLSHIndexer(metric="l2", num_bits=100),
        "binary_cosine": jlsh.BinaryLSHIndexer(metric="cosine", num_bits=64),
    }
    for name, indexer in specs.items():
        art = indexer.build(x, D)
        path = str(root / name)
        jpersist.save_artifact(art, path)
        out[name] = (art, tpersist.load_artifact(path, device="cpu"))
    return out


# -- bit for bit on integer inputs ----------------------------------------


@pytest.mark.parametrize("nbits", [1, 31, 32, 33, 100, 512])
def test_pack_bits_bit_identical(nbits):
    bits = np.random.default_rng(nbits).random((257, nbits)) < 0.5
    want = np.asarray(jops.pack_bits(jnp.asarray(bits)))
    got = tops.pack_bits(torch.as_tensor(bits))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(_u32(got), want)


def test_popcount_bit_identical():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    edges = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x55555555,
                      0xAAAAAAAA, 0x0F0F0F0F, 0xF0F0F0F0], dtype=np.uint32)
    words = np.concatenate([edges, words])
    want = np.asarray(jax.lax.population_count(jnp.asarray(words))).astype(np.int64)
    got = tops.popcount32(torch.as_tensor(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def _one_hot_projections(rng, t, d, h):
    """Projections that select one coordinate per hash dimension: on integer
    inputs every product, and so every cell, is exact."""
    proj = np.zeros((t, d, h), np.float32)
    pick = rng.integers(0, d, size=(t, h))
    proj[np.arange(t)[:, None], pick, np.arange(h)[None, :]] = 1.0
    return proj


@pytest.mark.parametrize("h", [1, 5, 18, 30])
def test_e2lsh_mix_bit_identical_on_integer_cells(h):
    """E2LSH keys of integer cells (negative ones, and the int32 extremes,
    included): the uint32 mix wraps at 32 bits in both packages."""
    rng = np.random.default_rng(h)
    t, d = 7, 40
    x = rng.integers(-5000, 5000, size=(300, d)).astype(np.float32)
    x[0, :] = -(2.0**31)
    x[1, :] = 2.0**30
    proj = _one_hot_projections(rng, t, d, h)
    offsets = np.zeros((t, h), np.float32)
    want = np.asarray(jops.e2lsh_keys(jnp.asarray(x), jnp.asarray(proj), jnp.asarray(offsets), 1.0))
    got = tops.e2lsh_keys(_t(x), _t(proj), _t(offsets), 1.0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sign_keys_bit_identical_on_integer_inputs():
    rng = np.random.default_rng(1)
    x = rng.integers(-3, 4, size=(500, 16)).astype(np.float32)  # zero products too
    proj = rng.integers(-2, 3, size=(6, 16, 30)).astype(np.float32)
    want = np.asarray(jops.sign_keys(jnp.asarray(x), jnp.asarray(proj)))
    got = tops.sign_keys(_t(x), _t(proj))
    np.testing.assert_array_equal(got.numpy(), want)


def _edge_mismatches(got, want, rel_edge):
    """Mismatched keys, and whether each lies within EDGE_RTOL of an edge."""
    bad = got != want
    return int(bad.sum()), bool(np.all(rel_edge[bad] <= EDGE_RTOL))


def test_float_keys_agree_to_the_edge_rule(data, jax_artifacts):
    x, _ = data
    x64 = x.astype(np.float64)
    # E2LSH: edges at integer (x.r + b) / w
    jart, tart = jax_artifacts["lsh_l2"]
    proj = np.asarray(jart.data["projections"]).astype(np.float64)
    off = np.asarray(jart.data["offsets"]).astype(np.float64)
    w = jart.metadata["bucket_width"]
    want = np.asarray(jart.data["db_keys"])
    got = tops.e2lsh_keys(_t(x), tart.data["projections"], tart.data["offsets"], w).numpy()
    v = np.einsum("nd,tdh->nth", x64, proj) + off[None]
    mag = np.einsum("nd,tdh->nth", np.abs(x64), np.abs(proj)) + np.abs(off)[None]
    rel = (np.abs(v / w - np.round(v / w)) * w / mag).min(axis=2)  # nearest edge over h
    n_bad, near = _edge_mismatches(got, want, rel)
    assert (got == want).mean() >= KEY_MIN_AGREE and near, n_bad
    # sign hash: the edge is x.r = 0
    jart, tart = jax_artifacts["lsh_cosine"]
    xn = np.asarray(jart.data["vectors"])
    proj = np.asarray(jart.data["projections"]).astype(np.float64)
    want = np.asarray(jart.data["db_keys"])
    got = tops.sign_keys(_t(xn), tart.data["projections"]).numpy()
    v = np.einsum("nd,tdh->nth", xn.astype(np.float64), proj)
    mag = np.einsum("nd,tdh->nth", np.abs(xn).astype(np.float64), np.abs(proj))
    rel = (np.abs(v) / mag).min(axis=2)
    n_bad, near = _edge_mismatches(got, want, rel)
    assert (got == want).mean() >= KEY_MIN_AGREE and near, n_bad


def _tied_keys(rng, n, t, span):
    return rng.integers(0, span, size=(n, t)).astype(np.int32)


@pytest.mark.parametrize("n_cand", [1, 37, 600, N])
def test_vote_candidates_bit_identical_with_ties(n_cand):
    """Few distinct keys, so thousands of rows tie in votes at the cut: the
    same votes and the same rows, in the same order."""
    rng = np.random.default_rng(n_cand)
    db = _tied_keys(rng, N, 6, 3)
    qk = _tied_keys(rng, B, 6, 3)
    wv, wi = jops.vote_candidates(jnp.asarray(qk), jnp.asarray(db), n_cand, chunk=1024)
    gv, gi = tops.vote_candidates(_t(qk), _t(db), n_cand)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("n_cand", [1, 37, 600, N])
def test_hamming_candidates_bit_identical_with_ties(n_cand):
    """Two words with few set bits, so Hamming distances tie widely."""
    rng = np.random.default_rng(n_cand + 1)
    db = (rng.random((N, 64)) < 0.05)
    q = (rng.random((B, 64)) < 0.05)
    dbw, qw = (np.asarray(jops.pack_bits(jnp.asarray(a))) for a in (db, q))
    wh, wi = jops.hamming_candidates(jnp.asarray(qw), jnp.asarray(dbw), n_cand, chunk=1024)
    gh, gi = tops.hamming_candidates(_t(qw.view(np.int32)), _t(dbw.view(np.int32)), n_cand)
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("chunk", [7, 512, 1000, None])
def test_scans_do_not_depend_on_the_chunk(chunk, data):
    x, q = data
    rng = np.random.default_rng(5)
    db = _tied_keys(rng, N, 6, 3)
    qk = _tied_keys(rng, B, 6, 3)
    ref = tops.vote_candidates(_t(qk), _t(db), 200, chunk=N)
    got = tops.vote_candidates(_t(qk), _t(db), 200, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    words = tops.pack_bits(torch.as_tensor(rng.random((N, 70)) < 0.1))
    qw = tops.pack_bits(torch.as_tensor(rng.random((B, 70)) < 0.1))
    ref = tops.hamming_candidates(qw, words, 300, chunk=N)
    got = tops.hamming_candidates(qw, words, 300, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    kth = ref[0][:, -1:]
    ref = tops.hamming_threshold_rerank(_t(q), qw, _t(x), words, kth, K, chunk=N)
    got = tops.hamming_threshold_rerank(_t(q), qw, _t(x), words, kth, K, chunk=chunk)
    torch.testing.assert_close(got[0], ref[0], rtol=DIST_RTOL, atol=0)
    assert torch.equal(got[1], ref[1])


def test_chunk_rows_bounds_the_intermediate():
    assert tops.chunk_rows(256 * 16 * 8, 1_000_000) == 16_384  # SIFT's [256, chunk, 16] int64
    assert tops.chunk_rows(256 * 16 * 8, 1000) == 1000
    assert tops.chunk_rows(10**12, 5) == 1


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rerank_matches_jax(metric, data):
    x, q = data
    rng = np.random.default_rng(9)
    cand = rng.integers(-1, N, size=(B, 150)).astype(np.int32)
    wd, wi = jops.rerank(jnp.asarray(q), jnp.asarray(x), jnp.asarray(cand), K, metric=metric)
    gd, gi = tops.rerank(_t(q), _t(x), _t(cand).long(), K, metric=metric)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=DIST_RTOL, atol=1e-6)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # fewer valid candidates than k: padded with inf / -1 in both
    few = np.full((B, 12), -1, np.int32)
    few[:, :4] = cand[:, :4]
    wd, wi = jops.rerank(jnp.asarray(q), jnp.asarray(x), jnp.asarray(few), K, metric=metric)
    gd, gi = tops.rerank(_t(q), _t(x), _t(few).long(), K, metric=metric)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(np.isinf(gd.numpy()), np.isinf(np.asarray(wd)))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_hamming_threshold_rerank_matches_jax(metric, data):
    x, q = data
    rng = np.random.default_rng(11)
    proj = rng.standard_normal((D, 96)).astype(np.float32)
    words = np.asarray(jops.pack_bits(jnp.asarray(x @ proj > 0)))
    qw = np.asarray(jops.pack_bits(jnp.asarray(q @ proj > 0)))
    ham, _ = jops.hamming_candidates(jnp.asarray(qw), jnp.asarray(words), 400)
    kth = np.asarray(ham)[:, -1:]
    wd, wi = jops.hamming_threshold_rerank(
        jnp.asarray(q), jnp.asarray(qw), jnp.asarray(x), jnp.asarray(words), jnp.asarray(kth),
        K, metric=metric, chunk=1024)
    gd, gi = tops.hamming_threshold_rerank(
        _t(q), _t(qw.view(np.int32)), _t(x), _t(words.view(np.int32)), _t(kth).long(), K,
        metric=metric)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=DIST_RTOL, atol=1e-4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


# -- models ----------------------------------------------------------------


def _search_both(jax_searcher, port_searcher, jart, tart, q, k):
    jax_searcher.attach(jart)
    port_searcher.attach(tart)
    return jax_searcher.batch_search(q, k), port_searcher.batch_search(q, k)


def _assert_same_results(jres, tres):
    (jd, ji), (td, ti) = jres, tres
    assert td.shape == jd.shape and ti.dtype == np.int64
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(jd)
    assert np.array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=DIST_RTOL, atol=1e-4)


@pytest.mark.parametrize("name", ["lsh_l2", "lsh_cosine"])
@pytest.mark.parametrize("fallback", [True, False])
@pytest.mark.parametrize("mult", [2.0, 8.0])
def test_jax_built_lsh_artifact_searched_by_both(name, fallback, mult, data, jax_artifacts):
    _, q = data
    jart, tart = jax_artifacts[name]
    metric = jart.metadata["metric"]
    kw = dict(metric=metric, candidate_multiplier=mult, fallback_to_bruteforce=fallback)
    jres, tres = _search_both(jlsh.LSHSearcher(**kw), tlsh.LSHSearcher(device="cpu", **kw),
                              jart, tart, q, K)
    _assert_same_results(jres, tres)
    if fallback:
        assert (tres[1] >= 0).all()


def test_padded_output_without_the_fallback(data, jax_artifacts):
    """Narrow E2LSH cells: most queries collide with fewer than k rows, and
    without the fallback both packages pad with inf / -1."""
    x, q = data
    jart = jlsh.LSHIndexer(metric="l2", num_tables=2, hash_size=12, bucket_width=0.5).build(x, D)
    tart = artifact_from_numpy("lsh", {k: np.asarray(v) for k, v in jart.data.items()},
                               jart.metadata, device="cpu")
    kw = dict(metric="l2", candidate_multiplier=4.0, fallback_to_bruteforce=False)
    jres, tres = _search_both(jlsh.LSHSearcher(**kw), tlsh.LSHSearcher(device="cpu", **kw),
                              jart, tart, q, K)
    _assert_same_results(jres, tres)
    assert (tres[1] == -1).any() and np.isinf(tres[0]).any()
    # with it, the short rows are answered by exact search: full and exact
    kw["fallback_to_bruteforce"] = True
    searcher = tlsh.LSHSearcher(device="cpu", **kw)
    searcher.attach(tart)
    _, _, n_short = searcher._answer(_t(q), K)
    d, i = searcher.batch_search(q, K)
    want = np.sort(((x[None, :, :] - q[:, None, :]) ** 2).sum(-1), axis=1)[:, :K]
    assert n_short > 0 and (i >= 0).all()
    np.testing.assert_allclose(d, want, rtol=DIST_RTOL, atol=1e-4)


def test_k_above_the_corpus_pads_like_jax(data, jax_artifacts):
    x, q = data
    small = x[:7]
    jart = jlsh.LSHIndexer(metric="l2", num_tables=3, hash_size=4, bucket_width=4.0).build(small, D)
    tart = artifact_from_numpy("lsh", {k: np.asarray(v) for k, v in jart.data.items()},
                               jart.metadata, device="cpu")
    kw = dict(metric="l2", candidate_multiplier=2.0, fallback_to_bruteforce=True)
    jres, tres = _search_both(jlsh.LSHSearcher(**kw), tlsh.LSHSearcher(device="cpu", **kw),
                              jart, tart, q, K)
    _assert_same_results(jres, tres)
    assert (tres[1][:, 7:] == -1).all()


@pytest.mark.parametrize("name", ["binary_l2", "binary_cosine"])
@pytest.mark.parametrize("mult", [4.0, 64.0])
def test_jax_built_binary_artifact_searched_by_ann_searcher(name, mult, data, jax_artifacts):
    """``ANNSearcher``'s ``binary_lsh`` kind: 40 candidates a query take the
    gather rerank, 640 the dense threshold pass."""
    _, q = data
    jart, tart = jax_artifacts[name]
    assert tart.data["words"].dtype == torch.int32
    np.testing.assert_array_equal(_u32(tart.data["words"]), np.asarray(jart.data["words"]))
    metric = jart.metadata["metric"]
    kw = dict(metric=metric, lsh_candidate_multiplier=mult)
    jres, tres = _search_both(JaxANNSearcher(**kw), ANNSearcher(device="cpu", **kw),
                              jart, tart, q, K)
    _assert_same_results(jres, tres)
    path = tlsh.binary_rerank_path(tlsh.binary_n_candidates(tart, K, mult))
    assert path == ("gather" if mult == 4.0 else "threshold")


def test_binary_lsh_multiplier_defaults_to_32(data, jax_artifacts):
    _, q = data
    jart, tart = jax_artifacts["binary_l2"]
    jres, tres = _search_both(JaxANNSearcher(metric="l2"), ANNSearcher(metric="l2", device="cpu"),
                              jart, tart, q, K)
    _assert_same_results(jres, tres)
    assert tlsh.binary_n_candidates(tart, K, 32.0) == 320


@pytest.mark.parametrize("kind", ["lsh", "binary_lsh"])
def test_port_saved_artifact_loads_in_jax(kind, data, tmp_path):
    x, q = data
    if kind == "lsh":
        art = tlsh.LSHIndexer(metric="l2", num_tables=6, hash_size=8, bucket_width=2.0,
                              device="cpu").build(x, D)
        kw = dict(metric="l2", candidate_multiplier=8.0, fallback_to_bruteforce=False)
        jax_s, port_s = jlsh.LSHSearcher(**kw), tlsh.LSHSearcher(device="cpu", **kw)
    else:
        art = tlsh.BinaryLSHIndexer(metric="l2", num_bits=100, device="cpu").build(x, D)
        kw = dict(metric="l2", lsh_candidate_multiplier=16.0)
        jax_s, port_s = JaxANNSearcher(**kw), ANNSearcher(device="cpu", **kw)
    path = str(tmp_path / kind)
    tpersist.save_artifact(art, path)
    with np.load(os.path.join(path, tpersist.ARRAYS)) as z:
        if kind == "binary_lsh":
            assert z["words"].dtype == np.uint32
        assert z["vectors"].dtype == np.float32
    jart = jpersist.load_artifact(path)
    assert jart.kind == kind and jart.metadata == art.metadata
    jres, tres = _search_both(jax_s, port_s, jart, art, q, K)
    _assert_same_results(jres, tres)


def _recall(ids, gt, k):
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(ids, gt)]))


@pytest.fixture(scope="module")
def clustered():
    from vectordb_retrieval_tpu_torch.data import datasets as tdata

    ds = tdata.Dataset("glove50_surrogate", "unused", {
        "train_limit": 4000, "test_size": 200, "ground_truth_k": K, "use_cache": False,
    }, device="cpu").load()
    return ds.train_vectors, ds.test_vectors, ds.ground_truth


@pytest.mark.parametrize("family", ["lsh_l2", "lsh_cosine", "binary"])
def test_port_builds_reach_jax_recall(family, clustered):
    """At the same parameters the port's builds reach the JAX package's
    recall within 0.02, each averaged over three build seeds (the
    projections differ between the packages, and one draw of them moves
    recall by up to ~0.03 here)."""
    x, q, gt = clustered
    if family == "binary":
        metric = "l2"
        indexer = {"type": "BinaryLSHIndexer", "num_bits": 256}
        searcher = {"type": "ANNSearcher", "lsh_candidate_multiplier": 24.0}
    else:
        metric = family.split("_")[1]
        indexer = {"type": "LSHIndexer", "num_tables": 24,
                   "hash_size": 3 if metric == "l2" else 6, "bucket_width": 8.0}
        searcher = {"type": "LSHSearcher", "candidate_multiplier": 32.0,
                    "fallback_to_bruteforce": False}
    want = _cosine_gt(x, q) if metric == "cosine" else gt
    got = {}
    for name, factory, kw in (("jax", jax_get, {}),
                              ("port", get_algorithm_instance, {"device": "cpu"})):
        recalls = []
        for seed in (42, 43, 44):
            algo = factory("composite", x.shape[1], metric=metric,
                           indexer=dict(indexer, seed=seed), searcher=dict(searcher), **kw)
            algo.build_index(x)
            recalls.append(_recall(algo.batch_search(q, K)[1], want, K))
        got[name] = float(np.mean(recalls))
    assert 0.3 < got["jax"] < 0.95, got  # the comparison has room on both sides
    assert abs(got["port"] - got["jax"]) <= 0.02, got


def _cosine_gt(x, q):
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    return np.argsort(-(qn @ xn.T), axis=1, kind="stable")[:, :K]


def test_hash_size_cap_raises_in_both():
    with pytest.raises(ValueError, match="hash_size must be <= 30"):
        tlsh.LSHIndexer(hash_size=31, device="cpu")
    with pytest.raises(ValueError, match="hash_size must be <= 30"):
        jlsh.LSHIndexer(hash_size=31)
    tlsh.LSHIndexer(hash_size=30, device="cpu")


def test_lsh_searcher_rejects_other_artifacts(jax_artifacts):
    _, tart = jax_artifacts["binary_l2"]
    with pytest.raises(ValueError, match="needs an 'lsh' artifact"):
        tlsh.LSHSearcher(device="cpu").attach(tart)


@pytest.mark.parametrize("name", ["lsh", "LSH"])
def test_lsh_composite_through_the_registry(name, data):
    x, q = data
    algo = get_algorithm_instance(name, D, metric="l2", num_tables=4, hash_size=6,
                                  bucket_width=3.0, device="cpu")
    assert isinstance(algo, tlsh.LSH) and algo.name == "LSH"
    jax_algo = jax_get(name, D, metric="l2", num_tables=4, hash_size=6, bucket_width=3.0)
    assert type(jax_algo).__name__ == "LSH"
    assert algo.get_parameters() == jax_algo.get_parameters()
    algo.build_index(x)
    d, i = algo.batch_search(q, K)  # the fallback makes every row full and exact
    want = np.sort(((x[None, :, :] - q[:, None, :]) ** 2).sum(-1), axis=1)[:, :K]
    np.testing.assert_allclose(d, want, rtol=DIST_RTOL, atol=1e-4)
    dd, ii = algo.device_kernel(_t(q), K)
    np.testing.assert_array_equal(ii.numpy(), i)


def test_port_build_is_device_independent_of_the_generator(data):
    """Projections come from a CPU generator: two builds agree exactly."""
    x, _ = data
    a = tlsh.BinaryLSHIndexer(num_bits=64, seed=5, device="cpu").build(x, D)
    b = tlsh.BinaryLSHIndexer(num_bits=64, seed=5, device="cpu").build(x, D)
    assert torch.equal(a.data["words"], b.data["words"])
    c = tlsh.BinaryLSHIndexer(num_bits=64, seed=6, device="cpu").build(x, D)
    assert not torch.equal(a.data["words"], c.data["words"])


# -- the slice: both runners on one config --------------------------------


def _slice_config(tmp_path, tag):
    """configs/glove50_smoke.yaml's lsh and faiss_lsh rows (and
    configs/benchmark_config_smoke.yaml's gather-path binary row) on a
    2,000-row glove50_surrogate."""
    with open(os.path.join(REPO, "configs", "glove50_smoke.yaml")) as f:
        src = yaml.safe_load(f)
    cfg = {
        "indexers": {
            "lsh_l2": src["indexers"]["lsh_l2"],
            "binary_lsh_l2": src["indexers"]["binary_lsh_l2"],
            "binary_128": {"type": "BinaryLSHIndexer", "num_bits": 128, "metric": "l2"},
        },
        "searchers": {
            "lsh_search_l2": src["searchers"]["lsh_search_l2"],
            "binary_rerank": src["searchers"]["binary_rerank"],
            "binary_rerank_16": {"type": "ANNSearcher", "metric": "l2",
                                 "lsh_candidate_multiplier": 16.0},
        },
        "algorithms": {
            "lsh": src["algorithms"]["lsh"],
            "faiss_lsh": src["algorithms"]["faiss_lsh"],
            "faiss_lsh_gather": {"indexer_ref": "binary_128", "searcher_ref": "binary_rerank_16",
                                 "metric": "l2"},
        },
        "datasets": [{"name": "glove50_surrogate", "metric": "l2", "dataset_options": {
            "train_limit": 2000, "test_size": 64, "ground_truth_k": 20, "use_cache": False}}],
        "topk": 10, "n_queries": 64, "query_batch_size": 32, "repeat": 1,
        "output_dir": str(tmp_path / f"out_{tag}"), "data_dir": str(tmp_path / "data"),
        "seed": 42,
    }
    path = tmp_path / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_slice_runner_reports_jax_recall(tmp_path):
    jres = JaxRunner(_slice_config(tmp_path, "jax")).run()["glove50_surrogate"]
    tres = BenchmarkRunner(_slice_config(tmp_path, "port"), device="cpu").run()["glove50_surrogate"]
    for row in ("lsh", "faiss_lsh", "faiss_lsh_gather"):
        assert "error" not in tres[row], tres[row]
        got, want = tres[row]["recall@10"], jres[row]["recall@10"]
        if row == "faiss_lsh_gather":  # 160 candidates of 2,000: the builds differ
            assert abs(got - want) <= 0.02, (row, got, want)
        else:  # the fallback / a radius over every row: exact in both
            assert got == want == 1.0, (row, got, want)
