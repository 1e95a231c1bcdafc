"""The port's PQ family (ops/pq.py, ops/ivf.py's IVF-PQ half, the factory's
PQ, IVF-PQ and OPQ builds, the manifold loader) against the JAX package's.

The same NumPy inputs, made from a seed, go through both packages on the
CPU. Codecs: codes >= 99.9 % equal and equal on every row whose nearest
sub-centroid wins by a clear margin; decodes, norms and rotations within
rtol 1e-6. Searches run on JAX-built artifacts (the k-means inits draw from
``jax.random`` in one package and ``torch.Generator`` in the other, so the
builds differ by construction): sorted distances within rtol 1e-5, ids
equal as sets per query (tie-free random data), in every IVF-PQ regime,
each forced in both packages as ``tests/test_torch_ivf.py`` forces them.
Builds are held by quantisation error (port <= 1.05 x JAX's) and recall
(within 0.03 of JAX's).
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vectordb_retrieval_tpu.bench.runner import BenchmarkRunner as JaxRunner
from vectordb_retrieval_tpu.data import datasets as jdata
from vectordb_retrieval_tpu.models import persist as jpersist
from vectordb_retrieval_tpu.models.factory import (
    ANNSearcher as JaxSearcher,
    FactoryIndexer as JaxIndexer,
)
from vectordb_retrieval_tpu.ops import ivf as jivf
from vectordb_retrieval_tpu.ops import pq as jpq
from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner
from vectordb_retrieval_tpu_torch.data import datasets as tdata
from vectordb_retrieval_tpu_torch.models import persist as tpersist
from vectordb_retrieval_tpu_torch.models.base import leaf_to_tensor
from vectordb_retrieval_tpu_torch.models.factory import (
    ANNSearcher,
    FactoryIndexer,
    parse_index_key,
)
from vectordb_retrieval_tpu_torch.ops import ivf as tivf
from vectordb_retrieval_tpu_torch.ops import pq as tpq

torch.set_num_threads(2)
CPU = torch.device("cpu")
K = 10
N, D = 4000, 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    """A numpy (or JAX) array as a CPU tensor, bf16 kept bit for bit."""
    return leaf_to_tensor("a", np.asarray(a), CPU)[1]


@pytest.fixture(scope="module")
def data():
    """Clustered rows (64 gaussian blobs), so coarse lists mean something,
    and queries drawn near them."""
    rng = np.random.default_rng(17)
    centers = rng.standard_normal((64, D)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, 64, N)] + rng.standard_normal((N, D)).astype(np.float32)
    q = centers[rng.integers(0, 64, 24)] + rng.standard_normal((24, D)).astype(np.float32)
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def books(data):
    """JAX-trained codebooks by m (8 Lloyd iterations)."""
    x, _ = data
    return {m: np.asarray(jpq.pq_train(jnp.asarray(x), m, iters=8)) for m in (4, 8)}


# JAX-built artifacts: (index_key, indexer knobs, metric)
CASES = {
    "ivf_pq": ("IVF16,PQ8", {}, "l2"),
    "ivf_pq_cosine": ("IVF16,PQ8", {}, "cosine"),
    "ivf_pq_rot": ("IVF16,PQ8", {"pq_rotations": 16}, "l2"),
    "ivf_pq_auto": ("IVF16,PQ8", {"pq_rotations": "auto"}, "l2"),
    "pq": ("PQ8", {}, "l2"),
    "pq_cosine": ("PQ8", {}, "cosine"),
    "opq": ("OPQ8,PQ8", {}, "l2"),
    "opq_ivf_cosine": ("OPQ8,IVF16,PQ8", {}, "cosine"),
}


@pytest.fixture(scope="module")
def jax_arts(data):
    """Each JAX-built artifact once per module, on first use."""
    x, _ = data
    cache = {}

    def get(case):
        if case not in cache:
            key, opts, metric = CASES[case]
            cache[case] = JaxIndexer(metric=metric, index_key=key, nprobe=4,
                                     train_iters=8, **opts).build(x, D)
        return cache[case]

    return get


def _near_tie_rows(x, cb, margin=1e-4):
    """Rows whose winning sub-centroid beats the runner-up by less than
    ``margin`` (relative) in some subspace, in float64."""
    m, ksub, dsub = cb.shape
    xs = x.astype(np.float64).reshape(len(x), m, dsub)
    dist = ((xs[:, :, None, :] - cb[None].astype(np.float64)) ** 2).sum(-1)
    part = np.sort(dist, axis=-1)
    gap = (part[..., 1] - part[..., 0]) / np.maximum(part[..., 1], 1e-30)
    return (gap < margin).any(axis=1)


def _qerr(x, cb, codes):
    r = tpq.pq_reconstruct(_t(codes), _t(cb)).numpy()
    return float(((x - r) ** 2).sum(1).mean())


# ---- codecs ----------------------------------------------------------------


@pytest.mark.parametrize("d,m", [(32, 4), (32, 8), (30, 4), (48, 6)])
def test_split_dim_matches_jax(d, m):
    if d % m:
        for fn in (jpq.split_dim, tpq.split_dim):
            with pytest.raises(ValueError, match="not divisible"):
                fn(d, m)
    else:
        assert tpq.split_dim(d, m) == jpq.split_dim(d, m) == d // m


@pytest.mark.parametrize("m", [4, 8])
def test_pq_codes_match_jax(data, books, m):
    x, _ = data
    cb = books[m]
    want = np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(cb)))
    got = tpq.pq_encode(_t(x), _t(cb)).numpy()
    assert got.dtype == np.uint8 and got.shape == (N, m)
    assert (got == want).mean() >= 0.999
    clear = ~_near_tie_rows(x, cb)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])
    # the chunking is invisible
    np.testing.assert_array_equal(tpq.pq_encode(_t(x), _t(cb), chunk=333).numpy(), got)


@pytest.mark.parametrize("m", [4, 8])
def test_pq_reconstruct_and_sqnorms_match_jax(data, books, m):
    x, _ = data
    cb = books[m]
    codes = np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(cb)))
    want = np.asarray(jpq.pq_reconstruct(jnp.asarray(codes), jnp.asarray(cb)))
    got = tpq.pq_reconstruct(_t(codes), _t(cb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        got, np.asarray(jpq.pq_reconstruct_gather(jnp.asarray(codes), jnp.asarray(cb))))
    want_n = np.asarray(jpq.pq_code_sqnorms(jnp.asarray(codes), jnp.asarray(cb)))
    np.testing.assert_allclose(tpq.pq_code_sqnorms(_t(codes), _t(cb)).numpy(), want_n,
                               rtol=1e-6)


@pytest.mark.parametrize("m", [4, 8])
def test_pq_train_quantisation_error_matches_jax(data, books, m):
    """The port's codebooks (its own k-means inits) code the rows at most
    5 % worse than the JAX package's, with the same iterations; each
    codebook has ksub distinct rows."""
    x, _ = data
    cb = tpq.pq_train(_t(x), m, iters=8)
    assert cb.shape == (m, tpq.KSUB, D // m) and cb.dtype == torch.float32
    assert all(torch.unique(cb[j], dim=0).shape[0] == tpq.KSUB for j in range(m))
    jcb = books[m]
    err_t = _qerr(x, cb.numpy(), tpq.pq_encode(_t(x), cb).numpy())
    err_j = _qerr(x, jcb, np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(jcb))))
    assert err_t <= 1.05 * err_j, (err_t, err_j)


def test_pq_train_needs_ksub_rows():
    with pytest.raises(ValueError, match="at least ksub"):
        tpq.pq_train(torch.zeros((100, 8)), 2)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pq_search_matches_jax(data, books, metric):
    x, q = data
    cb = books[8]
    codes = jpq.pq_encode(jnp.asarray(x), jnp.asarray(cb))
    sqn = jpq.pq_code_sqnorms(codes, jnp.asarray(cb))
    # chunk 1024 (clamped to 512 multiples): four chunks and a ragged end
    want = jpq.pq_search(jnp.asarray(q), codes, jnp.asarray(cb), sqn, K, chunk=1024,
                         metric=metric)
    got = tpq.pq_search(_t(q), _t(codes), _t(cb), _t(sqn), K, chunk=1024, metric=metric)
    _assert_same(got, want)


# ---- rotations -----------------------------------------------------------


def _orthogonal(rng, shape):
    q_, _ = np.linalg.qr(rng.standard_normal(shape))
    return q_.astype(np.float32)


def test_rotate_and_unrotate_blocks_match_jax(data):
    x, _ = data
    rng = np.random.default_rng(3)
    rots = _orthogonal(rng, (N, 4, 8, 8))
    want = np.asarray(jpq.rotate_blocks(jnp.asarray(x), jnp.asarray(rots)))
    got = tpq.rotate_blocks(_t(x), _t(rots)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    back_j = np.asarray(jpq.unrotate_blocks(jnp.asarray(want), jnp.asarray(rots)))
    back = tpq.unrotate_blocks(_t(want), _t(rots)).numpy()
    np.testing.assert_allclose(back, back_j, rtol=1e-6, atol=1e-6 * np.abs(x).max())
    np.testing.assert_allclose(back, x, atol=1e-5 * np.abs(x).max())
    with pytest.raises(ValueError, match="rotation block"):
        tpq.rotate_blocks(_t(x[:, :30]), _t(rots))


@pytest.mark.parametrize("rank", ["full", "deficient", "zero"])
def test_polar_orthogonalize_matches_jax(rank):
    """Full rank: the polar factor is unique, so entries agree. Rank-
    deficient: U V^T is not unique, so both must be orthogonal and reach
    the same Procrustes objective tr(R^T C) (the nuclear norm of C). Zero
    input: the identity."""
    rng = np.random.default_rng(5)
    c = rng.standard_normal((6, 2, 8, 8)).astype(np.float32)
    if rank == "deficient":
        c = (c[..., :3] @ rng.standard_normal((3, 8))).astype(np.float32)
    if rank == "zero":
        c[1, 0] = 0.0
    got = tpq.polar_orthogonalize(_t(c)).numpy()
    want = np.asarray(jpq.polar_orthogonalize(jnp.asarray(c)))
    eye = np.eye(8, dtype=np.float32)
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2), np.broadcast_to(eye, got.shape),
                               atol=1e-5)
    if rank == "full":
        np.testing.assert_allclose(got, want, atol=2e-5)
    elif rank == "deficient":
        obj_t = np.einsum("...ij,...ij->...", got, c)
        obj_j = np.einsum("...ij,...ij->...", want, c)
        np.testing.assert_allclose(obj_t, obj_j, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got[1, 0], eye)
        np.testing.assert_allclose(got[0], want[0], atol=2e-5)


@pytest.fixture(scope="module")
def residuals(data):
    """The IVF16 residuals of the rows and their lists (JAX k-means), a
    17th list left empty and one list cut below the block size."""
    from vectordb_retrieval_tpu.ops.kmeans import kmeans_assign, kmeans_fit

    x, _ = data
    cents, _ = kmeans_fit(jnp.asarray(x), 16, seed=0, iters=6)
    a = np.asarray(kmeans_assign(jnp.asarray(x), cents)).astype(np.int32)
    r = x - np.asarray(cents)[a]
    keep = (a != 3) | (np.cumsum(a == 3) <= 10)  # list 3 keeps 10 rows
    return r[keep].astype(np.float32), a[keep], 17


def test_pca_init_matches_jax(residuals):
    """With no alternation the rotations are the PCA + eigenvalue-
    allocation init: entry for entry the JAX package's (the largest-|entry|
    sign convention, the allocation order), identity where a list has fewer
    than bs rows (list 3) or none (list 16)."""
    r, a, nlist = residuals
    bs, m = 16, 8  # dsub 4: four subquantizers a block
    want, _ = jpq.train_per_list_rotations(jnp.asarray(r), jnp.asarray(a), nlist, m, bs,
                                           iters=2, alt_iters=0)
    got, _ = tpq.train_per_list_rotations(_t(r), _t(a), nlist, m, bs, iters=2,
                                          alt_iters=0)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    np.testing.assert_array_equal(got[3].numpy(), np.broadcast_to(np.eye(bs), (2, bs, bs)))
    np.testing.assert_array_equal(got[16].numpy(), np.broadcast_to(np.eye(bs), (2, bs, bs)))


def _rotated_error(r, a, rots, cb):
    y = tpq.rotate_blocks(_t(r), _t(rots)[_t(a).long()])
    codes = tpq.pq_encode(y, _t(cb))
    back = tpq.unrotate_blocks(tpq.pq_reconstruct(codes, _t(cb)), _t(rots)[_t(a).long()])
    return float(((r - back.numpy()) ** 2).sum(1).mean())


def test_train_per_list_rotations_against_jax(residuals):
    """Trained rotations are orthogonal; they code the residuals at most 5 %
    worse than the JAX package's (compared by reconstruction error, since
    U V^T of a rank-deficient block is not unique), and better than the
    shared codebook alone."""
    r, a, nlist = residuals
    m, bs = 8, 16
    rots, cb = tpq.train_per_list_rotations(_t(r), _t(a), nlist, m, bs, iters=6)
    jrots, jcb = jpq.train_per_list_rotations(jnp.asarray(r), jnp.asarray(a), nlist, m, bs,
                                              iters=6)
    assert rots.shape == (nlist, D // bs, bs, bs) and cb.shape == (m, tpq.KSUB, D // m)
    rr = rots.numpy()
    np.testing.assert_allclose(rr @ np.swapaxes(rr, -1, -2),
                               np.broadcast_to(np.eye(bs), rr.shape), atol=1e-5)
    err_t = _rotated_error(r, a, rr, cb.numpy())
    err_j = _rotated_error(r, a, np.asarray(jrots), np.asarray(jcb))
    plain = tpq.pq_train(_t(r), m, iters=6)
    err_plain = _qerr(r, plain.numpy(), tpq.pq_encode(_t(r), plain).numpy())
    assert err_t <= 1.05 * err_j, (err_t, err_j)
    assert err_t < err_plain


def test_pq_encode_rotated_matches_jax(residuals):
    r, a, nlist = residuals
    rng = np.random.default_rng(9)
    rots = _orthogonal(rng, (nlist, 2, 16, 16))
    cb = np.asarray(jpq.pq_train(jnp.asarray(r), 8, iters=4))
    want = np.asarray(jpq.pq_encode_rotated(jnp.asarray(r), jnp.asarray(a), jnp.asarray(rots),
                                            jnp.asarray(cb)))
    got = tpq.pq_encode_rotated(_t(r), _t(a), _t(rots), _t(cb)).numpy()
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("d", [384, 128, 96, 50, 48, 24, 12])
def test_auto_rotation_block_matches_jax(d):
    assert tpq.auto_rotation_block(d) == jpq.auto_rotation_block(d)


def _manifold_rows(n=2000, d=32, seed=29):
    opts = {"dim": d, "train_limit": n, "test_size": 4, "ground_truth_k": 1,
            "n_patches": 16, "intrinsic_dim": 4, "point_scale": 0.5, "seed": seed,
            "use_cache": False}
    return tdata.Dataset("manifold", "unused", opts, device="cpu").load().train_vectors


@pytest.mark.parametrize("corpus", ["manifold", "gaussian"])
def test_rotation_gain_separates_manifold_from_shared_frame(corpus):
    """The 'auto' decision's A/B: per-list frames (the manifold corpus's
    k-means residuals) gain >= 0.05; residuals of one shared isotropic
    gaussian frame under structure-free list assignments (the JAX
    package's own zero-gain control) stay below it, in both packages."""
    from vectordb_retrieval_tpu.ops.kmeans import kmeans_assign, kmeans_fit

    if corpus == "manifold":
        x = _manifold_rows()
        cents, _ = kmeans_fit(jnp.asarray(x), 16, seed=0, iters=6)
        a = np.asarray(kmeans_assign(jnp.asarray(x), cents)).astype(np.int32)
        r = (x - np.asarray(cents)[a]).astype(np.float32)
    else:
        rng = np.random.default_rng(31)
        r = rng.standard_normal((3000, 32)).astype(np.float32)
        a = rng.integers(0, 16, 3000).astype(np.int32)
    gain_t, ep, er, rots, _ = tpq.rotation_gain(_t(r), _t(a), 16, 8, 32, iters=6)
    gain_j = jpq.rotation_gain(jnp.asarray(r), jnp.asarray(a), 16, 8, 32, iters=6)[0]
    assert gain_t == pytest.approx(1.0 - er / ep)
    assert rots.shape == (16, 1, 32, 32)
    if corpus == "manifold":
        assert gain_t >= 0.05 and gain_j >= 0.05, (gain_t, gain_j)
    else:
        assert gain_t < 0.05 and gain_j < 0.05, (gain_t, gain_j)


def test_opq_train_against_jax(data):
    """An orthogonal rotation whose PQ codes the rows at most 5 % worse
    than the JAX package's OPQ (and no worse than plain PQ's 5 % margin)."""
    x, _ = data
    r, cb = tpq.opq_train(_t(x), 8, iters=4, opq_iters=3)
    jr, jcb = jpq.opq_train(jnp.asarray(x), 8, iters=4, opq_iters=3)
    rr = r.numpy()
    np.testing.assert_allclose(rr @ rr.T, np.eye(D), atol=1e-5)

    def err(rot, books):
        y = x @ rot
        return _qerr(y, books, tpq.pq_encode(_t(y), _t(books)).numpy())

    assert err(rr, cb.numpy()) <= 1.05 * err(np.asarray(jr), np.asarray(jcb))


# ---- IVF-PQ search ---------------------------------------------------------


def _assert_same(got, want):
    gd, gi = (v.numpy() for v in got)
    wd, wi = (np.asarray(v) for v in want)
    assert gi.dtype == np.int64 and gi.shape == wi.shape
    np.testing.assert_array_equal(np.sort(gi, 1), np.sort(wi, 1))
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    scale = np.abs(wd[fin]).max()
    np.testing.assert_allclose(np.sort(gd, 1)[fin], np.sort(wd, 1)[fin],
                               rtol=1e-5, atol=1e-5 * scale)


@contextlib.contextmanager
def regime(name, taken):
    """Force one IVF-PQ regime in both packages (``streaming`` by a zero
    resident budget, passed by the caller); record which port stage ran."""
    saved = (jivf._use_stream, jivf.FORCE_FUSED_INTERPRET, tivf._use_stream,
             tivf._use_fused, tivf._probe_scan, tivf._masked_stream,
             tivf._fused_stream, tivf._decode_lists)

    def spy(fn, label):
        def wrapped(*a, **kw):
            taken.append(label)
            return fn(*a, **kw)
        return wrapped

    try:
        stream = name != "probe"
        jivf._use_stream = tivf._use_stream = lambda *a: stream
        jivf.FORCE_FUSED_INTERPRET = name == "fused"
        if name == "masked":
            tivf._use_fused = lambda *a: 0
        tivf._probe_scan = spy(saved[4], "probe")
        tivf._masked_stream = spy(saved[5], "masked")
        tivf._fused_stream = spy(saved[6], "fused")
        if name == "streaming":
            tivf._decode_lists = spy(saved[7], "streaming")
        jax.clear_caches()
        yield
    finally:
        (jivf._use_stream, jivf.FORCE_FUSED_INTERPRET, tivf._use_stream,
         tivf._use_fused, tivf._probe_scan, tivf._masked_stream,
         tivf._fused_stream, tivf._decode_lists) = saved
        jax.clear_caches()


@contextlib.contextmanager
def jax_decode():
    """The port's searches over the JAX package's reconstructions. Rotated
    lists decode one bf16 step apart here and there (the port sums the
    rotation product in float64, the JAX package in f32: see
    test_decode_matches_a_float64_oracle_and_jax); on the same rows the
    searches must agree to f32 rounding."""
    orig = tivf._decode_lists

    def decode(codes, cents, codebooks, rot=None):
        c, L, _ = codes.shape
        x_hat, sqn = jivf._decode_lists(
            jnp.asarray(codes.numpy()), jnp.asarray(cents.numpy()),
            jnp.asarray(codebooks.numpy()), c, L, cents.shape[1],
            rot_p=None if rot is None else jnp.asarray(rot.numpy()))
        return _t(x_hat), _t(sqn)

    tivf._decode_lists = decode
    try:
        yield
    finally:
        tivf._decode_lists = orig


@pytest.mark.parametrize("rot", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("name", ["probe", "masked", "fused", "streaming"])
def test_ivf_pq_search_matches_jax_in_each_regime(data, jax_arts, name, metric, rot):
    """``ivf_pq_search`` on a JAX-built IVF16,PQ8 artifact (with per-list
    rotations at bs 16, or none), the reference's 'probe nprobe LISTS'
    semantics, every regime: the resident one's three searches over the
    bf16 reconstructions and the streaming one (a zero resident budget,
    chunks of 7 buckets). Rotated lists are searched over the JAX
    package's reconstructions (:func:`jax_decode`)."""
    _, q = data
    art = jax_arts("ivf_pq_rot" if rot else "ivf_pq")
    d = {k: np.asarray(v) for k, v in art.data.items()}
    meta = art.metadata
    nprobe = int(meta["probe_cum"][3])
    budget = {} if name != "streaming" else {
        "resident_budget": 0, "chunk_budget": 7 * meta["max_list_len"] * D * 2}
    names = ["centroids", "slot_ids", "list_codes", "list_sqnorms", "codebooks"]
    kw_names = {"bucket_lists": "bucket_lists", "list_centroids": "list_centroids"}
    if rot:
        kw_names.update({"list_rotations": "list_rotations", "rot_bucket_lists": "bucket_lists"})
    jkw = {k: jnp.asarray(d[v]) for k, v in kw_names.items()}
    tkw = {k: _t(d[v]) for k, v in kw_names.items()}
    taken = []
    with jax_decode() if rot else contextlib.nullcontext(), regime(name, taken):
        want = jivf.ivf_pq_search(jnp.asarray(q), *(jnp.asarray(d[n]) for n in names), K,
                                  nprobe, metric=metric, nlist=16, nprobe_lists=4,
                                  **budget, **jkw)
        got = tivf.ivf_pq_search(_t(q), *(_t(d[n]) for n in names), K, nprobe,
                                 metric=metric, nlist=16, nprobe_lists=4, **budget, **tkw)
    if name == "streaming":
        assert taken and set(taken) == {"streaming"}
    else:
        assert taken == [name]
    _assert_same(got, want)


@pytest.mark.parametrize("rot", [False, True])
def test_decode_matches_a_float64_oracle_and_jax(jax_arts, rot):
    """The resident reconstruction. Without rotations: bit for bit the JAX
    package's (the same gather and f32 add). With them, the port sums the
    rotation product in float64 and rounds it once to f32, so its bf16 rows
    equal a NumPy float64 oracle's bit for bit (and the card's the host's);
    the JAX package sums it in f32, so a few values sit one bf16 step away
    from the port's (>= 99.9 % equal). Norms are f32 sums of the f32 rows,
    taken before the bf16 cast."""
    art = jax_arts("ivf_pq_rot" if rot else "ivf_pq")
    d = {k: np.asarray(v) for k, v in art.data.items()}
    n_bkt, L, m = d["list_codes"].shape
    rots = d["list_rotations"][np.clip(d["bucket_lists"], 0, None)] if rot else None
    recon, sqn = tivf.decode_resident(
        _t(d["list_codes"]), _t(d["centroids"]), _t(d["codebooks"]),
        *((_t(d["list_rotations"]), _t(d["bucket_lists"])) if rot else ()))
    assert recon.dtype == torch.bfloat16 and sqn.dtype == torch.float32
    got = recon.float().numpy()
    y_hat = d["codebooks"][np.arange(m), d["list_codes"].astype(np.int64)]  # [n, L, m, dsub]
    y_hat = y_hat.reshape(n_bkt, L, D)
    if rot:
        y_hat = np.einsum("clbe,cbef->clbf", y_hat.reshape(n_bkt, L, -1, 16).astype(np.float64),
                          rots.astype(np.float64)).astype(np.float32).reshape(n_bkt, L, D)
    x_hat = y_hat + d["centroids"][:, None, :]
    np.testing.assert_array_equal(got, _t(x_hat).to(torch.bfloat16).float().numpy())
    np.testing.assert_allclose(sqn.numpy(), (x_hat * x_hat).sum(-1), rtol=1e-6)
    assert not np.allclose(sqn.numpy(), (got * got).sum(-1), rtol=1e-6)
    want_r, want_n = jivf._decode_lists(
        jnp.asarray(d["list_codes"]), jnp.asarray(d["centroids"]), jnp.asarray(d["codebooks"]),
        n_bkt, L, D, rot_p=None if rots is None else jnp.asarray(rots))
    want_r = np.asarray(want_r.astype(jnp.float32))
    if rot:
        assert (got == want_r).mean() >= 0.999
        ulp = np.abs(want_r) * 2.0 ** -7 + 1e-30  # one bf16 step
        assert (np.abs(got - want_r) <= ulp).all()
    else:
        np.testing.assert_array_equal(got, want_r)
    np.testing.assert_allclose(sqn.numpy(), np.asarray(want_n), rtol=1e-5)


# ---- the factory and persistence ------------------------------------------


@pytest.mark.parametrize("key", ["PQ8", "IVF16,PQ8", "OPQ8,PQ8", "OPQ4,IVF16,PQ8"])
def test_parse_index_key_accepts_pq_keys_like_jax(key):
    from vectordb_retrieval_tpu.models.factory import parse_index_key as jparse

    assert parse_index_key(key) == jparse(key)


@pytest.mark.parametrize("case", list(CASES))
def test_jax_built_pq_artifact_searches_alike_in_the_port(tmp_path, data, jax_arts, case):
    """Saved by the JAX package, loaded through models/persist.py: the same
    arrays (uint8 codes, f32 codebooks, rotations, the OPQ rotation) and
    metadata (the nested ``pq_rot_auto`` record too); the port's
    ANNSearcher returns the JAX searcher's ids and distances (over the
    JAX package's reconstructions where the lists are rotated)."""
    _, q = data
    jart = jax_arts(case)
    metric = CASES[case][2]
    path = str(tmp_path / "jax_art")
    jpersist.save_artifact(jart, path, {"config_hash": "h"})
    art = tpersist.load_artifact(path, {"config_hash": "h"}, device="cpu")
    assert art.kind == jart.kind and art.metadata == jart.metadata
    assert set(art.data) == set(jart.data)
    for k_, v in jart.data.items():
        want = np.asarray(v)
        assert art.data[k_].numpy().dtype == want.dtype, k_
        np.testing.assert_array_equal(art.data[k_].numpy(), want)
    if "codes" in art.data or "list_codes" in art.data:
        codes = art.data.get("codes", art.data.get("list_codes"))
        assert codes.dtype == torch.uint8 and art.data["codebooks"].dtype == torch.float32
    if case == "ivf_pq_auto":
        assert art.metadata["pq_rot_auto"]["bs"] == 32
        assert ("list_rotations" in art.data) == art.metadata["pq_rot_auto"]["enabled"]
    js = JaxSearcher(metric=metric, nprobe=4)
    js.attach(jart)
    ts = ANNSearcher(metric=metric, nprobe=4, device="cpu")
    ts.attach(art)
    with jax_decode() if "list_rotations" in art.data else contextlib.nullcontext():
        got = ts.batch_search(q, K)
    _assert_same(tuple(torch.from_numpy(v) for v in got), js.batch_search(q, K))


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1] for a, b in zip(ids, gt)]))


@pytest.mark.parametrize("case", ["ivf_pq", "ivf_pq_rot", "pq_cosine", "opq"])
def test_port_builds_match_jax_recall_and_round_trip(tmp_path, data, jax_arts, case):
    """The port's own build of each case reaches the JAX build's recall@10
    within 0.03; saved by the port, it loads into the JAX package and
    searches there to the port's ids (rotated lists: over the JAX
    package's reconstructions); loaded back, no bit changed."""
    x, q = data
    key, opts, metric = CASES[case]
    art = FactoryIndexer(metric=metric, index_key=key, nprobe=4, train_iters=8,
                         device="cpu", **opts).build(x, D)
    assert art.kind == jax_arts(case).kind
    assert set(art.data) == set(jax_arts(case).data)
    ts = ANNSearcher(metric=metric, nprobe=4, device="cpu")
    ts.attach(art)
    with jax_decode() if "list_rotations" in art.data else contextlib.nullcontext():
        got_d, got_i = ts.batch_search(q, K)
    js = JaxSearcher(metric=metric, nprobe=4)
    js.attach(jax_arts(case))
    _, want_i = js.batch_search(q, K)
    xx, qq = (x, q) if metric == "l2" else (
        x / np.linalg.norm(x, axis=1, keepdims=True), q / np.linalg.norm(q, axis=1, keepdims=True))
    gt = np.argsort(((qq[:, None, :] - xx[None]) ** 2).sum(-1), axis=1)[:, :K]
    assert abs(_recall(got_i, gt) - _recall(want_i, gt)) <= 0.03
    assert _recall(got_i, gt) > 0.3

    path = str(tmp_path / "torch_art")
    tpersist.save_artifact(art, path)
    jart = jpersist.load_artifact(path)
    assert jart.kind == art.kind and jart.metadata == art.metadata
    js2 = JaxSearcher(metric=metric, nprobe=4)
    js2.attach(jart)
    _assert_same((torch.from_numpy(got_d), torch.from_numpy(got_i)), js2.batch_search(q, K))
    again = tpersist.load_artifact(path, device="cpu")
    for k_, v in art.data.items():
        assert again.data[k_].dtype == v.dtype and torch.equal(again.data[k_], v)


def test_rotation_auto_records_its_decision(data):
    """``pq_rotations='auto'`` writes the A/B into the metadata and keeps
    the rotations only above the threshold; the build reports its parts."""
    x, _ = data
    ix = FactoryIndexer(index_key="IVF16,PQ8", pq_rotations="auto", train_iters=4,
                        device="cpu")
    art = ix.build(x, D)
    rec = art.metadata["pq_rot_auto"]
    assert set(rec) == {"bs", "gain", "err_plain", "err_rot", "threshold", "enabled"}
    assert rec["threshold"] == FactoryIndexer.PQ_ROT_AUTO_GAIN == JaxIndexer.PQ_ROT_AUTO_GAIN
    assert rec["enabled"] == (rec["gain"] >= rec["threshold"])
    assert ("list_rotations" in art.data) == rec["enabled"]
    assert {"coarse_kmeans", "rotations", "encode"} <= set(ix.build_seconds)
    with pytest.raises(ValueError):
        FactoryIndexer(pq_rotations="sometimes", device="cpu")


# ---- data and the runner ---------------------------------------------------


def test_manifold_loader_is_bit_identical_to_jax(tmp_path):
    opts = {"dim": 24, "train_limit": 600, "test_size": 12, "ground_truth_k": 5,
            "n_patches": 8, "intrinsic_dim": 4, "use_cache": False}
    dj = jdata.Dataset("manifold", str(tmp_path), dict(opts)).load()
    dt = tdata.Dataset("manifold", str(tmp_path), dict(opts), device="cpu").load()
    for a, b in ((dt.train_vectors, dj.train_vectors), (dt.test_vectors, dj.test_vectors)):
        assert a.dtype == np.float32 and a.tobytes() == np.asarray(b).tobytes()
    np.testing.assert_array_equal(dt.ground_truth, np.asarray(dj.ground_truth))
    assert dt.metric == "l2" and dt.metadata["surrogate"] is True
    assert dt.metadata["surrogate_for"] == dj.metadata["surrogate_for"]


def _runner_config(tmp_path, out_name):
    """The smoke config's ivf_pq (IVF16,PQ16) and pq (PQ16) rows, trained
    with 8 Lloyd iterations."""
    with open(os.path.join(REPO, "configs", "benchmark_config_smoke.yaml")) as f:
        cfg = yaml.safe_load(f)
    picked = {name: cfg["algorithms"][name] for name in ("ivf_pq", "pq")}
    cfg["indexers"] = {r["indexer_ref"]: dict(cfg["indexers"][r["indexer_ref"]], train_iters=8)
                       for r in picked.values()}
    cfg["algorithms"] = picked
    cfg["searchers"] = {"ann_l2": cfg["searchers"]["ann_l2"]}
    cfg["output_dir"] = str(tmp_path / out_name)
    cfg["data_dir"] = str(tmp_path / "data")
    path = tmp_path / f"{out_name}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path), list(picked)


def test_benchmark_runner_runs_the_pq_rows_like_jax(tmp_path):
    """The rows through both runners on the smoke dataset (random 2000 x
    32, top-10): no row error, the same keys, recall@10 within 0.03 of the
    JAX package's row (builds differ in their draws)."""
    path_j, rows = _runner_config(tmp_path, "jax")
    path_t, _ = _runner_config(tmp_path, "torch")
    res_j = JaxRunner(path_j).run()["random"]
    runner = BenchmarkRunner(path_t, device="cpu")
    res_t = runner.run()["random"]
    roofline = {"kernel_flops_per_batch", "achieved_tflops", "kernel_bytes_per_batch",
                "achieved_gbps"}
    for name in rows:
        row_j, row_t = res_j[name], res_t[name]
        assert "error" not in row_t, row_t
        assert set(row_t) == set(row_j) and roofline <= set(row_t)
        assert abs(row_t["recall@10"] - row_j["recall@10"]) <= 0.03, (name, row_t, row_j)
        assert row_t["index_memory_mb"] > 0 and row_t["qps"] > 0
    with open(os.path.join(runner.output_dir, "all_results.json")) as f:
        assert set(json.load(f)["random"]) == set(rows)
