"""The port's cover tree (ops/covertree.py, models/covertree.py) against the
JAX package's, on the CPU.

Trees are built at a build batch of 64 rows (the default 4,096 makes every
point of a small corpus a child of the root), so the descents have depths
to prune. Layout helpers and the build must give bit-identical arrays on
the same input. Searches run on JAX-built artifacts handed to both packages
as the same arrays; the JAX block walk runs its Pallas stage 1 in interpret
mode, as its own tests do. Tolerances: sorted distances within 1e-5
relative (both rescore exactly in f32 difference form, summing in another
order); ids equal where the distances are tie-free; overflow flags equal;
``ndis`` within 1 % (a prune decision may sit on f32 rounding of a product).
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from vectordb_retrieval_tpu.models import covertree as jmc
from vectordb_retrieval_tpu.models import get_algorithm_instance as jget
from vectordb_retrieval_tpu.ops import covertree as jops
from vectordb_retrieval_tpu_torch.models import ALGORITHM_REGISTRY, get_algorithm_instance
from vectordb_retrieval_tpu_torch.models import covertree as tmc
from vectordb_retrieval_tpu_torch.models.base import artifact_from_numpy
from vectordb_retrieval_tpu_torch.ops import covertree as tops
from vectordb_retrieval_tpu_torch.ops import kernels

torch.set_num_threads(2)
SMALL_BATCH = 64
KEYS = ("slab", "point_ids", "is_real", "radii", "parent_rel", "row_pos")


def _data(seed, n=600, d=8, nq=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    return x, q


def _oracle(x, q, k, metric="l2"):
    if metric == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        return np.sort(-(q.astype(np.float64) @ x.T.astype(np.float64)), 1)[:, :k]
    full = np.sqrt(((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1))
    return np.sort(full, axis=1)[:, :k]


def _port(d, **kw):
    return get_algorithm_instance("covertree", d, device="cpu", **kw)


def _small_batch_builds():
    """Both packages' CoverTree.build_index at a build batch of 64."""
    return (
        mock.patch.object(jmc, "build_cover_tree",
                          functools.partial(jmc.build_cover_tree, batch=SMALL_BATCH)),
        mock.patch.object(tmc, "build_cover_tree",
                          functools.partial(tmc.build_cover_tree, batch=SMALL_BATCH)),
    )


def _jax_tree(x, metric="l2", **kw):
    p_jax, _ = _small_batch_builds()
    with p_jax:
        algo = jget("covertree", x.shape[1], metric=metric, **kw)
        algo.build_index(x)
    return algo


def _to_port(jalgo, **kw):
    art = jalgo.artifact
    algo = _port(jalgo.dimension, metric=jalgo.metric, **kw)
    algo.artifact = artifact_from_numpy(
        art.kind, {k: np.asarray(v) for k, v in art.data.items()}, art.metadata, "cpu")
    algo.is_built = True
    return algo


@pytest.fixture(scope="module")
def jax_trees():
    """JAX-built trees, one per metric, with their queries."""
    out = {}
    for metric in ("l2", "cosine"):
        x, q = _data(3, n=700, d=12, nq=16)
        out[metric] = (x, q, _jax_tree(x, metric))
    return out


# ---- build and layout ------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_build_cover_tree_matches_jax(seed):
    """Same (levels, children, root) at two seeds. A containment decision
    compares an f32 distance of a matrix product with 2^level, and the
    deepest cover is an argmin of level * 1e6 + distance, so either could in
    principle sit on the rounding of the product; at these inputs none does,
    and the invariants are checked as well: every child lies within
    2^level of its parent (to the product's rounding) at a lower level."""
    x, _ = _data(seed)
    jl, jc, jr = jmc.build_cover_tree(x, seed=seed, batch=SMALL_BATCH)
    tl, tc, tr = tmc.build_cover_tree(x, seed=seed, batch=SMALL_BATCH, device="cpu")
    assert tr == jr
    np.testing.assert_array_equal(tl, jl)
    assert tc == jc
    assert tl.dtype == np.int32
    for p, kids in enumerate(tc):
        if kids:
            d = np.linalg.norm(x[kids].astype(np.float64) - x[p], axis=1)
            assert np.all(d <= np.exp2(tl[p]) * (1 + 1e-5))
            assert np.all(tl[kids] < tl[p])
    assert sum(len(c) for c in tc) == len(x) - 1


@pytest.mark.parametrize("cap", [64, 8])
@pytest.mark.parametrize("helper", ["cap_fanout", "node_depths", "exact_subtree_radii",
                                    "depth_slab_layout"])
def test_layout_helpers_bit_identical(helper, cap):
    x, _ = _data(5, n=500)
    levels, children, root = jmc.build_cover_tree(x, seed=5, batch=SMALL_BATCH)
    j_cap = jmc.cap_fanout(x, levels, children, cap=cap)
    t_cap = tmc.cap_fanout(x, levels, children, cap=cap)
    if helper == "cap_fanout":
        for a, b in zip(t_cap[:3], j_cap[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert t_cap[3] == j_cap[3]
        assert (~t_cap[2]).sum() > 0  # virtual nodes were made
        return
    pid, radii, real, kids = j_cap
    if helper == "node_depths":
        np.testing.assert_array_equal(tmc.node_depths(kids, root), jmc.node_depths(kids, root))
        return
    t_rad = tmc.exact_subtree_radii(x, pid, kids, root)
    j_rad = jmc.exact_subtree_radii(x, pid, kids, root)
    if helper == "exact_subtree_radii":
        assert t_rad.dtype == j_rad.dtype == np.float32
        np.testing.assert_array_equal(t_rad, j_rad)
        return
    t_lay = tmc.depth_slab_layout(x, pid, j_rad, real, kids, root)
    j_lay = jmc.depth_slab_layout(x, pid, j_rad, real, kids, root)
    for a, b in zip(t_lay[:6], j_lay[:6]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t_lay[6] == j_lay[6]
    assert all(s % tops.SLAB_ALIGN == 0 for s in t_lay[6])


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_build_index_artifact_equals_jax(metric):
    x, _ = _data(4, n=500, d=10)
    j = _jax_tree(x, metric)
    _, p_port = _small_batch_builds()
    with p_port:
        t = _port(10, metric=metric)
        t.build_index(x)
    assert t.artifact.kind == "covertree"
    assert t.artifact.metadata == j.artifact.metadata
    assert t.artifact.metadata["schema"] == "covertree_v4"
    for key in KEYS:
        want = np.asarray(j.artifact.data[key])
        got = t.artifact.data[key].numpy()
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert set(t.build_seconds) == {"insert_scans", "cap_fanout",
                                    "exact_subtree_radii", "layout"}


# ---- search parity on JAX-built artifacts -----------------------------------


def _assert_same_results(t_res, j_res, k):
    td, jd = t_res.dists.numpy(), np.asarray(j_res.dists)
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-5, atol=1e-6)
    ti, ji = t_res.ids.numpy(), np.asarray(j_res.ids)
    for row in range(td.shape[0]):
        gaps = np.diff(np.sort(jd[row]))
        if np.all(gaps > 1e-5 * np.abs(jd[row]).max()):  # tie-free row
            assert set(ti[row]) == set(ji[row]), row
    np.testing.assert_array_equal(t_res.overflow.numpy(), np.asarray(j_res.overflow))
    tn, jn = t_res.ndis.numpy().sum(), np.asarray(j_res.ndis).sum()
    assert abs(int(tn) - int(jn)) <= 0.01 * int(jn)
    assert t_res.iters == int(j_res.iters)


@pytest.mark.parametrize("err_c", [jops.DEFAULT_ERR_C, 0.05])
@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("descent", ["stream", "blockwalk"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_search_matches_jax_on_jax_artifact(jax_trees, metric, descent, k, err_c):
    x, q, j = jax_trees[metric]
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    art = j.artifact
    meta = art.metadata
    kp = j._kprime(k, meta["n_vectors"])
    jfn = jops.covertree_stream_search if descent == "stream" else jops.covertree_blockwalk_search
    tfn = tops.covertree_stream_search if descent == "stream" else tops.covertree_blockwalk_search
    kw = dict(depth_sizes=tuple(meta["depth_sizes"]), k=k, kprime=kp, err_c=err_c)
    j_res = jfn(jnp.asarray(q), *(art.data[key] for key in KEYS[:5]), **kw)
    t = _to_port(j)
    t_res = tfn(torch.from_numpy(q), *(t.artifact.data[key] for key in KEYS[:5]), **kw)
    _assert_same_results(t_res, j_res, k)
    if err_c == jops.DEFAULT_ERR_C:  # certified: exact L2 distances
        assert not t_res.overflow.any()
        np.testing.assert_allclose(np.sort(t_res.dists.numpy(), 1),
                                   _oracle(_unit(x, metric), q, k), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_blockwalk_stage1_is_one_pair_equal_to_jax_k1(jax_trees, metric, monkeypatch):
    """The block walk's stage 1 is one dist_blockmin_pair call and no
    single-pen K1, and its two outputs equal the JAX package's two K1 bf16
    streams over the same slab (dist_blockmin_pallas in interpret mode, as
    covertree_blockwalk_search pads and calls it): 1e-5 x max, +inf alike."""
    from vectordb_retrieval_tpu.ops import pallas_kernels as plk
    from vectordb_retrieval_tpu.ops.distances import blockmin_width as jax_width

    x, q, j = jax_trees[metric]
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    t = _to_port(j)
    d, meta = t.artifact.data, t.artifact.metadata
    prep = tops.blockwalk_prep(d["slab"], d["is_real"], d["radii"], d["parent_rel"],
                               tuple(meta["depth_sizes"]))
    calls = []
    pair = kernels.dist_blockmin_pair
    monkeypatch.setattr(kernels, "dist_blockmin_pair",
                        lambda *a, **k: calls.append(a[1].dtype) or pair(*a, **k))
    monkeypatch.setattr(kernels, "dist_blockmin",
                        lambda *a, **k: pytest.fail("a single-pen K1 launch in stage 1"))
    got = tops.blockwalk_stage1(torch.from_numpy(q), prep)
    assert calls == [torch.bfloat16]

    jd = {k: jnp.asarray(v) for k, v in j.artifact.data.items()}
    slab = jd["slab"]
    m, w = slab.shape[0], jax_width(slab.shape[0])
    assert w == prep.w
    xn = jnp.sum(slab * slab, axis=-1)
    noninert = jd["is_real"] | (jd["radii"] >= 0.0)
    s_pad = plk.dist_blockmin_pad_rows(m, w)
    slab_bf = jnp.pad(slab, ((0, s_pad - m), (0, 0))).astype(jnp.bfloat16)
    for pen, bm in ((jnp.where(noninert, xn, jnp.inf), got[0]),
                    (jnp.where(jd["is_real"], xn, jnp.inf), got[1])):
        pen = jnp.pad(pen, (0, s_pad - m), constant_values=jnp.inf).reshape(-1, w)
        want = np.asarray(plk.dist_blockmin_pallas(
            jnp.asarray(q), slab_bf, pen, w=w, interpret=True))[:, : m // w]
        bm = bm.numpy()
        assert bm.shape == want.shape
        np.testing.assert_array_equal(np.isinf(bm), np.isinf(want))
        fin = np.isfinite(want)
        assert np.abs(bm[fin] - want[fin]).max() <= 1e-5 * np.abs(want[fin]).max()


def _unit(x, metric):
    return x / np.linalg.norm(x, axis=1, keepdims=True) if metric == "cosine" else x


@pytest.mark.parametrize("descent", ["stream", "blockwalk"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_model_search_matches_jax(jax_trees, metric, descent):
    x, q, j = jax_trees[metric]
    j.descent = descent
    j.reset_operations()
    jd, ji = j.batch_search(q, 10)
    t = _to_port(j, descent=descent)
    td, ti = t.batch_search(q, 10)
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.sort(ti, 1), np.sort(ji, 1))
    assert abs(t.get_operations()["ndis"] - j.get_operations()["ndis"]) <= 0.01 * j.get_operations()["ndis"]


def test_jax_saved_index_loads_into_the_port(jax_trees, tmp_path):
    x, q, j = jax_trees["l2"]
    ctx = {"dataset_fingerprint": "fp", "config_hash": "ch"}
    j.descent = "stream"
    j.save_index(str(tmp_path / "ct"), ctx)
    jd, ji = j.batch_search(q, 7)
    t = _port(x.shape[1], descent="blockwalk")
    t.load_index(str(tmp_path / "ct"), ctx)
    td, ti = t.batch_search(q, 7)
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.sort(ti, 1), np.sort(ji, 1))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_port_built_index_loads_into_jax(tmp_path, metric):
    x, q = _data(8, n=600, d=12)
    _, p_port = _small_batch_builds()
    with p_port:
        t = _port(12, metric=metric)
        t.build_index(x)
    td, ti = t.batch_search(q, 10)
    ctx = {"dataset_fingerprint": "fp"}
    t.save_index(str(tmp_path / "ct"), ctx)
    j = jget("covertree", 12, metric=metric)
    j.load_index(str(tmp_path / "ct"), ctx)
    jd, ji = j.batch_search(q, 10)
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.sort(ti, 1), np.sort(ji, 1))
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(j.artifact.data[key]),
                                      t.artifact.data[key].numpy())


# ---- the port on its own ---------------------------------------------------


@pytest.mark.parametrize("k", [1, 5, 20])
@pytest.mark.parametrize("descent", ["stream", "blockwalk"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_exact_against_brute_force(metric, descent, k):
    x, q = _data(11, n=500, d=16)
    _, p_port = _small_batch_builds()
    with p_port:
        t = _port(16, metric=metric, descent=descent)
        t.build_index(x)
    d, i = t.batch_search(q, k)
    want = _oracle(x, q, k, metric)
    np.testing.assert_allclose(np.sort(d, 1), want, rtol=1e-4, atol=1e-5)
    # the ids carry those distances
    xs, qs = _unit(x, metric), _unit(q, metric)
    if metric == "cosine":
        got = -(qs[:, None, :] * xs[i]).sum(-1)
    else:
        got = np.sqrt(((qs[:, None, :] - xs[i]) ** 2).sum(-1))
    np.testing.assert_allclose(d, got, rtol=1e-4, atol=1e-5)
    assert t.get_operations()["ndis"] > 0


def test_registry_names_and_auto_descent():
    for name in ("covertree", "CoverTree", "CoverTreeV2_2"):
        assert ALGORITHM_REGISTRY[name] is tmc.CoverTree
    x, q = _data(2, n=200)
    t = get_algorithm_instance("CoverTreeV2_2", 8, device="cpu")
    t.build_index(x)
    assert t.descent == "auto" and not t.uses_blockwalk()  # the CPU walks nodes
    assert _port(8, descent="blockwalk").descent == "blockwalk"
    with pytest.raises(ValueError, match="unknown descent"):
        _port(8, descent="beam")
    d, i = t.batch_search(q, 7)
    assert d.shape == (12, 7) and i.shape == (12, 7) and i.dtype == np.int64
    # k beyond the corpus pads with inf / -1
    d, i = t.batch_search(q[:2], 250)
    assert np.isinf(d[:, 200:]).all() and (i[:, 200:] == -1).all()


def test_duplicate_points():
    x, _ = _data(6, n=50, d=16)
    x = np.concatenate([x, x[:10]], axis=0)
    for descent in ("stream", "blockwalk"):
        t = _port(16, descent=descent)
        t.build_index(x)
        d, i = t.batch_search(x[:5], 1)
        np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-3)
        assert all(i[r, 0] in (r, r + 50) for r in range(5))


@pytest.mark.parametrize("descent", ["stream", "blockwalk"])
def test_certificate_fallback_keeps_exactness(descent):
    """A huge band (err_c = 0.5, a narrow fold) fails the certificate; the
    flagged queries go to exact search, which adds N to ndis per query."""
    x, q = _data(7, n=400, d=16)
    t = _port(16, err_c=0.5, kprime=5, descent=descent)
    t.build_index(x)
    d, i = t.batch_search(q, 5)
    np.testing.assert_allclose(np.sort(d, 1), _oracle(x, q, 5), rtol=1e-4, atol=1e-5)
    assert t.get_operations()["ndis"] >= 12 * 400


def test_blockwalk_overflow_flags_when_band_absurd():
    x, q = _data(9, n=400, d=16)
    _, p_port = _small_batch_builds()
    with p_port:
        t = _port(16, descent="blockwalk")
        t.build_index(x)
    d_ = t.artifact.data
    res = tops.covertree_blockwalk_search(
        torch.from_numpy(q), *(d_[key] for key in KEYS[:5]),
        depth_sizes=tuple(t.artifact.metadata["depth_sizes"]), k=5, kprime=64,
        err_c=10.0)
    assert bool(res.overflow.any())
    t.err_c = 10.0
    d, i = t.batch_search(q, 5)
    np.testing.assert_allclose(np.sort(d, 1), _oracle(x, q, 5), rtol=1e-4, atol=1e-5)
    rows, sqn = t._rows()
    np.testing.assert_array_equal(rows.numpy(), x)  # the fallback's rows, in id order
    dk, ik = t.device_kernel(torch.from_numpy(q), 5)
    np.testing.assert_allclose(np.sort(dk.numpy(), 1), _oracle(x, q, 5), rtol=1e-4, atol=1e-5)
    assert t._rows()[0] is rows and t._rows()[1] is sqn  # made once per artifact


def test_stream_multichunk_and_alignment(monkeypatch):
    """Chunked depth walks (and partial tail chunks) keep exactness and the
    layout contract."""
    monkeypatch.setattr(tops, "_STREAM_CHUNK", 64)
    x, q = _data(12, n=700, d=12, nq=9)
    t = _port(12, descent="stream")
    t.build_index(x)
    sizes = t.artifact.metadata["depth_sizes"]
    assert max(sizes) > 64
    assert all(s % tops.SLAB_ALIGN == 0 for s in sizes)
    assert sum(sizes) == int(t.artifact.data["slab"].shape[0])
    d, i = t.batch_search(q, 8)
    np.testing.assert_allclose(np.sort(d, 1), _oracle(x, q, 8), rtol=1e-4, atol=1e-5)
    assert t.get_operations()["ndis"] <= 9 * sum(sizes)
    # the chunked walk equals the JAX package's chunked walk
    monkeypatch.setattr(jops, "_STREAM_CHUNK", 64)
    art = t.artifact
    kw = dict(depth_sizes=tuple(sizes), k=8, kprime=264)
    j_res = jops.covertree_stream_search(
        jnp.asarray(q), *(jnp.asarray(art.data[key].numpy()) for key in KEYS[:5]), **kw)
    t_res = tops.covertree_stream_search(
        torch.from_numpy(q), *(art.data[key] for key in KEYS[:5]), **kw)
    _assert_same_results(t_res, j_res, 8)


@pytest.mark.parametrize("fn", ["stream", "blockwalk", "prep"])
def test_rejects_unaligned_layout(fn):
    rng = np.random.default_rng(0)
    m, d = 72, 8
    x = torch.as_tensor(rng.standard_normal((m, d)), dtype=torch.float32)
    args = (x, torch.arange(m, dtype=torch.int32), torch.ones(m, dtype=torch.bool),
            torch.zeros(m), torch.zeros(m, dtype=torch.int32))
    with pytest.raises(ValueError, match="not aligned"):
        if fn == "stream":
            tops.covertree_stream_search(x[:4], *args, depth_sizes=(1, 71), k=3, kprime=8)
        elif fn == "blockwalk":
            tops.covertree_blockwalk_search(x[:4], *args, depth_sizes=(1, 71), k=3, kprime=8)
        else:
            tops.blockwalk_prep(x, args[2], args[3], args[4], (1, 71))
    with pytest.raises(ValueError, match="sum 64 != slab rows 72"):
        tops.covertree_stream_search(x[:4], *args, depth_sizes=(32, 32), k=3, kprime=8)


@pytest.mark.parametrize("descent", ["stream", "blockwalk"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_device_kernel_matches_batch_search(metric, descent):
    x, q = _data(13, n=300, d=16)
    t = _port(16, metric=metric, descent=descent)
    t.build_index(x)
    d0, i0 = t.batch_search(q, 5)
    assert t.has_device_kernel
    d1, i1 = t.device_kernel(torch.from_numpy(q), 5)
    assert i1.dtype == torch.int64
    np.testing.assert_allclose(d0, d1.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i0, i1.numpy())
    t.record_stream_ops(10)
    assert t.get_operations()["ndis"] > 0


def test_blockwalk_prep_once_per_artifact(tmp_path):
    x, q = _data(14, n=300, d=8)
    t = _port(8, descent="blockwalk")
    t.build_index(x)
    before = dict(kernels.LAUNCHES)
    t.batch_search(q, 3)
    prep = t.blockwalk_prep()
    t.batch_search(q, 3)
    assert t.blockwalk_prep() is prep  # derived once
    assert prep.slab_bf.dtype == torch.bfloat16
    assert prep.pen_all.shape == (prep.slab_bf.shape[0] // prep.w, prep.w)
    assert set(t.artifact.data) == set(KEYS)  # nothing derived is persisted
    assert kernels.LAUNCHES == before  # CPU tensors take the plain version
    t.save_index(str(tmp_path / "ct"))
    t.load_index(str(tmp_path / "ct"))
    assert t.blockwalk_prep() is not prep  # a loaded artifact derives anew


def test_legacy_knobs_pass_through():
    """The JAX constructor's frontier-descent knobs are not options of the
    port; a config that still sets them loads and reports them."""
    t = _port(8, f_max=4096, expand=64)
    assert not hasattr(t, "f_max") and not hasattr(t, "expand")
    assert t.get_parameters()["f_max"] == 4096


@pytest.mark.parametrize("what", ["metric", "dimension", "schema"])
def test_load_index_validation(tmp_path, what):
    x, _ = _data(15, n=100, d=16)
    t = _port(16)
    t.build_index(x)
    if what == "schema":
        t.artifact.metadata["schema"] = "covertree_v3"
    path = str(tmp_path / "ct")
    t.save_index(path, {"dataset_fingerprint": "A"})
    other = {"metric": _port(16, metric="cosine"), "dimension": _port(8),
             "schema": _port(16)}[what]
    with pytest.raises(ValueError, match=f"{what} mismatch"):
        other.load_index(path, {"dataset_fingerprint": "A"})
    with pytest.raises(ValueError, match="fingerprint"):
        _port(16).load_index(path, {"dataset_fingerprint": "B"})


def test_experiment_runner_row_matches_jax(tmp_path):
    """A CoverTreeV2_2 row through the port's runner on the CPU at the
    configs/covertree_smoke.yaml shape, against the JAX runner."""
    from vectordb_retrieval_tpu.bench.runner import BenchmarkRunner as JaxRunner
    from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner

    cfg = {
        "algorithms": {
            "exact": {"type": "ExactSearch", "metric": "l2"},
            "covertree_v2_2": {"type": "CoverTreeV2_2", "metric": "l2", "repeat": 2},
        },
        "datasets": [{
            "name": "random", "metric": "l2", "n_queries": 64, "topk": 10,
            "dataset_options": {"dimensions": 32, "train_size": 2000, "test_size": 128,
                                "ground_truth_k": 50, "seed": 7, "use_cache": False},
        }],
        "data_dir": str(tmp_path / "data"), "output_prefix": "covertree_smoke",
        "seed": 42,
    }
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    got = BenchmarkRunner(str(path), output_dir=str(tmp_path / "port"), device="cpu").run()
    want = JaxRunner(str(path), output_dir=str(tmp_path / "jax")).run()
    g, w = got["random"]["covertree_v2_2"], want["random"]["covertree_v2_2"]
    assert "error" not in g, g
    assert g["recall@10"] == w["recall@10"] == 1.0
    assert got["random"]["exact"]["recall@10"] == 1.0
    # the JAX runner's roofline keys come from its TPU cost model
    roofline = {"kernel_flops_per_batch", "achieved_tflops", "kernel_bytes_per_batch",
                "achieved_gbps"}
    assert set(g) == set(w) - roofline
    assert g["parameters"]["descent"] == "auto" and g["parameters"]["name"] == "covertree_v2_2"
    assert g["operations_per_query"] > 0
