"""The port's ops/distances against the JAX package's, on the same inputs.

Both run on the CPU. Sorted distances must agree to rtol 1e-5 (f32 sums
taken in another order); ids are compared only where the distance is not
tied with a neighbour in the ranking, since the two top-k implementations
order ties differently.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectordb_retrieval_tpu.ops import distances as jops
from vectordb_retrieval_tpu_torch.ops import distances as tops

torch.set_num_threads(2)

RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_same_topk(got_d, got_i, want_d, want_i, rtol=RTOL):
    got_d, got_i = np.asarray(got_d), np.asarray(got_i)
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    assert got_d.shape == want_d.shape and got_i.shape == want_i.shape
    np.testing.assert_allclose(np.sort(got_d, 1), np.sort(want_d, 1), rtol=rtol)
    for r in range(want_d.shape[0]):
        order = np.argsort(want_d[r], kind="stable")
        d = want_d[r][order]
        gap = np.abs(np.diff(d)) > 1e-4 * np.maximum(np.abs(d[1:]), 1.0)
        untied = np.ones(d.shape, bool)
        untied[1:] &= gap
        untied[:-1] &= gap
        got_by_id = dict(zip(got_i[r].tolist(), got_d[r].tolist()))
        for pos in np.nonzero(untied)[0]:
            assert int(want_i[r][order][pos]) in got_by_id, (r, pos)


def _data(rng, n, d, b, metric):
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("n,d,k", [(257, 17, 5), (1000, 64, 20)])
def test_exact_search_dense_route_matches_jax(rng, metric, n, d, k, refine):
    x, q = _data(rng, n, d, 9, metric)
    wd, wi = jops.exact_search(jnp.asarray(q), jnp.asarray(x), k, metric=metric,
                               refine=refine)
    gd, gi = tops.exact_search(q, x, k, metric=metric, refine=refine, device="cpu")
    assert gi.dtype == torch.int64
    assert_same_topk(gd, gi, wd, wi)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_dense_and_streamed_match_jax(rng, metric):
    x, q = _data(rng, 1000, 32, 8, metric)
    for refine_to in (None, 10):
        jd = jops._exact_search_dense(jnp.asarray(q), jnp.asarray(x), None, 10,
                                      metric, refine_to)
        td = tops._exact_search_dense(_t(q), _t(x), None, 10, metric, refine_to)
        assert_same_topk(td[0], td[1], *jd)
        js = jops._exact_search_streamed(jnp.asarray(q), jnp.asarray(x), None, 10,
                                         metric, 128, refine_to)
        ts = tops._exact_search_streamed(_t(q), _t(x), None, 10, metric, 128,
                                         refine_to)
        assert_same_topk(ts[0], ts[1], *js)
        assert_same_topk(ts[0], ts[1], td[0], td[1])


def test_streamed_ragged_last_chunk(rng):
    x, q = _data(rng, 130, 16, 4, "l2")
    d, i = tops._exact_search_streamed(_t(q), _t(x), None, 130, "l2", 128)
    i = i.numpy()
    assert np.isfinite(d.numpy()).all()
    for row in i:
        assert sorted(row.tolist()) == list(range(130))


@pytest.mark.parametrize("stage1", ["xla_scan", "pallas_interpret"])
@pytest.mark.parametrize("w", [8, 16, 32])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_blockmin_matches_jax(rng, metric, w, stage1):
    """Ragged N (not a multiple of w or 8*w); the JAX stage 1 runs both
    through its XLA scan and through the Pallas kernel in interpret mode."""
    x, q = _data(rng, 3003, 24, 8, metric)
    k = 25
    orig = jops.FORCE_PALLAS_STAGE1_INTERPRET
    try:
        jops.FORCE_PALLAS_STAGE1_INTERPRET = stage1 == "pallas_interpret"
        wd, wi = jops._exact_search_blockmin(
            jnp.asarray(q), jnp.asarray(x), None, k, metric, 512, w=w
        )
    finally:
        jops.FORCE_PALLAS_STAGE1_INTERPRET = orig
    gd, gi = tops._exact_search_blockmin(_t(q), _t(x), None, k, metric, 512, w=w)
    assert_same_topk(gd, gi, wd, wi)
    gi = gi.numpy()
    assert (gi >= 0).all() and (gi < 3003).all()


def test_blockmin_sqnorms_argument(rng):
    x, q = _data(rng, 2000, 24, 16, "l2")
    sqn = (x * x).sum(1)
    wd, wi = jops._exact_search_blockmin(jnp.asarray(q), jnp.asarray(x),
                                         jnp.asarray(sqn), 15, "l2", 512)
    gd, gi = tops._exact_search_blockmin(_t(q), _t(x), _t(sqn), 15, "l2", 512)
    assert_same_topk(gd, gi, wd, wi)


def test_blockmin_pathological_ties(rng):
    """Massive exact ties: both return the true k smallest distances and no
    duplicate ids (which of the equal ids is unspecified)."""
    base = rng.standard_normal((8, 16)).astype(np.float32)
    x = np.repeat(base, 200, axis=0)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    wd, _ = jops._exact_search_blockmin(jnp.asarray(q), jnp.asarray(x), None,
                                        250, "l2", 512)
    gd, gi = tops._exact_search_blockmin(_t(q), _t(x), None, 250, "l2", 512)
    np.testing.assert_allclose(np.sort(gd.numpy(), 1), np.sort(np.asarray(wd), 1),
                               rtol=RTOL)
    for row in gi.numpy():
        assert len(set(row.tolist())) == 250


def test_select_blocks_hierarchical_matches_jax(rng):
    g = tops._SEL_FLAT_MAX * 2 + 36  # hierarchical branch + padding
    assert g == jops._SEL_FLAT_MAX * 2 + 36
    bm = rng.standard_normal((8, g)).astype(np.float32)
    want = np.asarray(jops._select_blocks(jnp.asarray(bm), 64))
    got = tops._select_blocks(_t(bm), 64).numpy()
    for r in range(8):
        np.testing.assert_array_equal(np.sort(bm[r][got[r]]), np.sort(bm[r][want[r]]))
        assert len(set(got[r].tolist())) == 64


def test_select_blocks_flat_branch(rng):
    bm = rng.standard_normal((4, 300)).astype(np.float32)
    got = tops._select_blocks(_t(bm), 20).numpy()
    np.testing.assert_array_equal(np.sort(got, 1), np.sort(np.argsort(bm, 1)[:, :20], 1))


@pytest.mark.parametrize(
    "n,w",
    [(100_000, 8), (262_144, 8), (524_288, 16), (600_000, 32), (1_000_000, 32),
     (100_000_000, 32)],
)
def test_blockmin_width_rule(n, w):
    assert tops.blockmin_width(n) == jops.blockmin_width(n) == w


def test_constants_match_jax():
    assert tops._DENSE_PATH_MAX_ROWS == jops._DENSE_PATH_MAX_ROWS == 32_768
    assert tops.REFINE_OVERFETCH == jops.REFINE_OVERFETCH == 16
    assert tops._BLOCKMIN_SLACK == jops._BLOCKMIN_SLACK == 16
    assert tops._SEL_FLAT_MAX == jops._SEL_FLAT_MAX
    assert tops._SEL_SF == jops._SEL_SF
    assert tops.DEFAULT_CHUNK_ROWS == jops.DEFAULT_CHUNK_ROWS
    assert tops.METRICS == jops.METRICS


def test_helpers_match_jax(rng):
    x, q = _data(rng, 300, 12, 6, "l2")
    np.testing.assert_allclose(tops.normalize(_t(x)).numpy(),
                               np.asarray(jops.normalize(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(tops.sq_norms(_t(x)).numpy(),
                               np.asarray(jops.sq_norms(jnp.asarray(x))), rtol=1e-6)
    for metric in ("l2", "ip"):
        np.testing.assert_allclose(
            tops.pairwise_distances(_t(q), _t(x), metric).numpy(),
            np.asarray(jops.pairwise_distances(jnp.asarray(q), jnp.asarray(x), metric)),
            rtol=1e-5, atol=1e-4,
        )
    ids = rng.integers(-1, 300, (6, 7))
    for metric in ("l2", "ip"):
        want = np.asarray(jops.rescore(jnp.asarray(q), jnp.asarray(x),
                                       jnp.asarray(ids, jnp.int32), metric))
        got = tops.rescore(_t(q), _t(x), _t(ids), metric).numpy()
        np.testing.assert_array_equal(np.isinf(got), ids < 0)
        np.testing.assert_allclose(got[ids >= 0], want[ids >= 0], rtol=1e-6, atol=1e-6)


def test_k_larger_than_n_raises(rng):
    x, q = _data(rng, 5, 4, 2, "l2")
    with pytest.raises(ValueError):
        tops.exact_search(q, x, 10, device="cpu")
    with pytest.raises(ValueError):
        tops.exact_search(q, x, 2, metric="hamming", device="cpu")


def test_exact_search_blockmin_route_ignores_refine(rng):
    """Above the dense cut exact_search takes the blockmin path, returns k
    (not k + overfetch) columns and marks nothing -1 on a full database."""
    x, q = _data(rng, tops._DENSE_PATH_MAX_ROWS + 5, 4, 3, "l2")
    d, i = tops.exact_search(q, x, 7, refine=True, device="cpu")
    assert d.shape == i.shape == (3, 7)
    full = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d.numpy(), np.sort(full, 1)[:, :7], rtol=RTOL)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("n", [tops._DENSE_PATH_MAX_ROWS + 13, 262_144 + 77])
def test_exact_search_above_the_dense_cut_matches_jax(rng, metric, n):
    """Above _DENSE_PATH_MAX_ROWS both packages take the blockmin path; the
    port's stage 3 is kernels.block_rescore (its plain version here). n is
    ragged at the width rule's w (8, then 16), and the first query is the
    last database row, so the ragged last block, padding rows and all, is
    among its selected blocks: ids and distances agree with the JAX
    package's exact search and no padding row is returned."""
    x, q = _data(rng, n, 8, 6, metric)
    q[0] = x[-1]
    assert tops.blockmin_width(n) == (8 if n < 262_144 else 16)
    wd, wi = jops.exact_search(jnp.asarray(q), jnp.asarray(x), 10, metric=metric)
    gd, gi = tops.exact_search(q, x, 10, metric=metric, device="cpu")
    assert_same_topk(gd, gi, wd, wi)
    gi = gi.numpy()
    assert (gi >= 0).all() and (gi < n).all()
    assert n - 1 in gi[0].tolist()
