"""The port's IVF ops (ops/ivf.py, ops/sq.py) against the JAX package's.

Inputs are built once by the JAX package (k-means, bucketed layout,
quantised payloads) and handed to both as the same arrays. Each search
runs in each of the three regimes, forced in both packages the way the
JAX package's own tests force them: ``_use_stream`` swapped, and the fused
stream switched on with ``FORCE_FUSED_INTERPRET`` (JAX, Pallas interpret
mode) or off with ``_use_fused`` (the port, which otherwise takes it on
any device). Ids must be equal as sorted sets per query (tie-free random
data); distances within 1e-5 relative to the largest (f32 sums taken in
another order; bf16-scored candidates are compared after their exact
rescore or on exact bf16 products).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectordb_retrieval_tpu.ops import ivf as jivf
from vectordb_retrieval_tpu.ops import sq as jsq
from vectordb_retrieval_tpu.ops.kmeans import kmeans_assign, kmeans_fit
from vectordb_retrieval_tpu_torch.models.base import leaf_to_tensor
from vectordb_retrieval_tpu_torch.ops import ivf as tivf
from vectordb_retrieval_tpu_torch.ops import sq as tsq

torch.set_num_threads(2)
CPU = torch.device("cpu")
K = 10


def _t(a):
    """A numpy (or JAX) array as a CPU tensor, bf16 kept bit for bit."""
    return leaf_to_tensor("a", np.asarray(a), CPU)[1]


@pytest.fixture(scope="module")
def layout():
    rng = np.random.default_rng(11)
    n, d, nlist = 4000, 32, 24
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((16, d)).astype(np.float32)
    cents, _ = kmeans_fit(jnp.asarray(x), nlist, seed=0, iters=6)
    assign = np.asarray(kmeans_assign(jnp.asarray(x), cents))
    slot_np, bl_np, _ = jivf.build_bucketed_lists(assign, nlist)
    coarse = np.asarray(jivf.coarse_table(cents, bl_np))
    safe = np.where(slot_np >= 0, slot_np, 0)
    vecs = x[safe] * (slot_np >= 0)[:, :, None]
    sqn = (vecs * vecs).sum(-1)
    vmin, step = (np.asarray(v) for v in jsq.sq_train(jnp.asarray(x)))
    codes = np.asarray(jsq.sq_encode(jnp.asarray(vecs.reshape(-1, d)), vmin, step))
    dec = np.asarray(jsq.sq_decode(jnp.asarray(codes), vmin, step))
    pen = np.where(rng.random(slot_np.shape) < 0.15, np.inf, 0.0).astype(np.float32)
    return {
        "x": x, "q": q, "nlist": nlist, "cents": np.asarray(cents),
        "slot": slot_np, "bl": bl_np, "coarse": coarse, "vecs": vecs,
        "vecs16": np.asarray(jnp.asarray(vecs).astype(jnp.bfloat16)),
        "sqn": sqn, "codes": codes.reshape(vecs.shape), "vmin": vmin,
        "step": step, "dsqn": (dec * dec).sum(-1).reshape(slot_np.shape),
        "pen": pen, "cum": jivf.probe_budget_cum(bl_np, nlist),
    }


@contextlib.contextmanager
def regime(name, taken):
    """Force one regime in both packages; record which port stage ran."""
    saved = (jivf._use_stream, jivf.FORCE_FUSED_INTERPRET, tivf._use_stream,
             tivf._use_fused, tivf._probe_scan, tivf._ivf_blockmin,
             tivf._ivf_probed_blockmin)

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
        tivf._ivf_blockmin = spy(saved[5], "masked")
        tivf._ivf_probed_blockmin = spy(saved[6], "fused")
        jax.clear_caches()
        yield
    finally:
        (jivf._use_stream, jivf.FORCE_FUSED_INTERPRET, tivf._use_stream,
         tivf._use_fused, tivf._probe_scan, tivf._ivf_blockmin,
         tivf._ivf_probed_blockmin) = saved
        jax.clear_caches()


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


def _probe_args(L, semantics, nprobe_lists=3):
    """(nprobe budget, jax kwargs, port kwargs) of a probe semantics."""
    if semantics == "coarse":
        return 6, {}, {}
    jkw = {"bucket_lists": jnp.asarray(L["bl"]), "nlist": L["nlist"],
           "nprobe_lists": nprobe_lists, "list_centroids": jnp.asarray(L["cents"])}
    tkw = {"bucket_lists": _t(L["bl"]), "nlist": L["nlist"],
           "nprobe_lists": nprobe_lists, "list_centroids": _t(L["cents"])}
    return int(L["cum"][nprobe_lists - 1]), jkw, tkw


PAYLOADS = ["f32", "bf16_full", "slot_pen", "sq8"]


@pytest.mark.parametrize("semantics", ["coarse", "lists"])
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("name", ["probe", "masked", "fused"])
def test_ivf_search_matches_jax_in_each_regime(layout, name, metric, payload, semantics):
    L = layout
    nprobe, jkw, tkw = _probe_args(L, semantics)
    jq, tq = jnp.asarray(L["q"]), _t(L["q"])
    head_j = (jq, jnp.asarray(L["coarse"]), jnp.asarray(L["slot"]))
    head_t = (tq, _t(L["coarse"]), _t(L["slot"]))
    taken = []
    with regime(name, taken):
        if payload == "sq8":
            want = jivf.ivf_sq_search(
                *head_j, jnp.asarray(L["codes"]), jnp.asarray(L["dsqn"]),
                jnp.asarray(L["vmin"]), jnp.asarray(L["step"]), K, nprobe,
                metric=metric, **jkw)
            got = tivf.ivf_sq_search(
                *head_t, _t(L["codes"]), _t(L["dsqn"]), _t(L["vmin"]),
                _t(L["step"]), K, nprobe, metric=metric, **tkw)
        else:
            vk = "vecs16" if payload == "bf16_full" else "vecs"
            extra_j, extra_t = {}, {}
            if payload == "bf16_full":
                extra_j["full_vectors"] = jnp.asarray(L["x"])
                extra_t["full_vectors"] = _t(L["x"])
            if payload == "slot_pen":
                extra_j["slot_pen"] = jnp.asarray(L["pen"])
                extra_t["slot_pen"] = _t(L["pen"])
            want = jivf.ivf_flat_search(
                *head_j, jnp.asarray(L[vk]), jnp.asarray(L["sqn"]), K, nprobe,
                metric=metric, **jkw, **extra_j)
            got = tivf.ivf_flat_search(
                *head_t, _t(L[vk]), _t(L["sqn"]), K, nprobe, metric=metric,
                **tkw, **extra_t)
    assert taken == [name]
    _assert_same(got, want)
    if payload == "slot_pen":  # filtered slots never come back
        filtered = set(L["slot"][np.isinf(L["pen"]) & (L["slot"] >= 0)].tolist())
        assert not filtered & set(got[1].numpy().ravel().tolist())


def test_bf16_lists_without_full_vectors_match_jax(layout):
    """bf16 scoring with no exact re-rank: the probe scan's distances are
    the bf16-product scores themselves."""
    L = layout
    args_j = (jnp.asarray(L["q"]), jnp.asarray(L["coarse"]), jnp.asarray(L["slot"]),
              jnp.asarray(L["vecs16"]), jnp.asarray(L["sqn"]), K, 6)
    args_t = (_t(L["q"]), _t(L["coarse"]), _t(L["slot"]), _t(L["vecs16"]),
              _t(L["sqn"]), K, 6)
    for name in ("probe", "fused"):
        taken = []
        with regime(name, taken):
            want = jivf.ivf_flat_search(*args_j)
            got = tivf.ivf_flat_search(*args_t)
        assert taken == [name]
        _assert_same(got, want)


@pytest.mark.parametrize("skew", [False, True])
def test_bucketed_layout_and_tables_identical(skew):
    rng = np.random.default_rng(3)
    n, nlist = 5000, 40
    if skew:  # one list holds half the corpus; some lists stay empty
        a = np.concatenate([np.zeros(n // 2, np.int64), rng.integers(5, nlist, n // 2)])
    else:
        a = rng.integers(0, nlist, n)
    for cap in (2048, 256, 64):
        js, jb, jr = jivf.build_bucketed_lists(a, nlist, target_len_cap=cap)
        ts, tb, tr = tivf.build_bucketed_lists(a, nlist, target_len_cap=cap)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tb, jb)
        assert tr == jr and ts.dtype == js.dtype and tb.dtype == jb.dtype
        assert ts.shape[0] % 8 == 0 and ts.shape[1] % 32 == 0
        np.testing.assert_array_equal(
            tivf.probe_budget_cum(tb, nlist), jivf.probe_budget_cum(jb, nlist))
        cents = rng.standard_normal((nlist, 16)).astype(np.float32)
        jc = np.asarray(jivf.coarse_table(jnp.asarray(cents), jb))
        tc = tivf.coarse_table(torch.from_numpy(cents), tb).numpy()
        np.testing.assert_array_equal(tc, jc)
        assert (tc[tb < 0] == tivf.DEAD_COARSE_FILL).all()
    jp, jc_, jr_ = jivf.build_padded_lists(a, nlist)
    tp, tc_, tr_ = tivf.build_padded_lists(a, nlist)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tc_, jc_)
    assert tr_ == jr_


def _probe_sets(probes, valid):
    return [frozenset(p[v].tolist()) for p, v in zip(probes, valid)]


@pytest.mark.parametrize("use_list_table", [True, False])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("nprobe_lists", [1, 3, 8])
def test_exact_probe_mask_identical(nprobe_lists, dup, use_list_table):
    """Same (probe set, valid) per query. With every list centroid
    duplicated, an odd nprobe splits a tied pair at the threshold, so the
    (distance, list id) tie rule decides membership."""
    rng = np.random.default_rng(nprobe_lists)
    nlist, d = 20, 12
    a = np.concatenate([np.zeros(600, np.int64), rng.integers(0, nlist - 2, 1400)])
    slot, bl, _ = jivf.build_bucketed_lists(a, nlist, target_len_cap=64)
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    if dup:
        cents = cents[np.arange(nlist) // 2]
    q = rng.standard_normal((32, d)).astype(np.float32)
    coarse = np.asarray(jivf.coarse_table(jnp.asarray(cents), bl))
    budget = int(jivf.probe_budget_cum(bl, nlist)[nprobe_lists - 1])
    lt_j = jnp.asarray(cents) if use_list_table else None
    lt_t = torch.from_numpy(cents) if use_list_table else None
    jp, jv = (np.asarray(v) for v in jivf.exact_probe_mask(
        jnp.asarray(q), jnp.asarray(coarse), jnp.asarray(bl), nlist,
        nprobe_lists, budget, list_centroids=lt_j))
    tp, tv = tivf.exact_probe_mask(
        torch.from_numpy(q), torch.from_numpy(coarse), torch.from_numpy(bl), nlist,
        nprobe_lists, budget, list_centroids=lt_t)
    assert tp.shape == jp.shape and tv.dtype == torch.bool
    assert _probe_sets(tp.numpy(), tv.numpy()) == _probe_sets(jp, jv)
    # every valid probe is a bucket of an allowed list, never a dead one
    assert (bl[tp.numpy()[tv.numpy()]] >= 0).all()


def test_sq8_codes_bit_identical(rng):
    x = (rng.standard_normal((3000, 40)) * rng.uniform(0.1, 5, 40)).astype(np.float32)
    # values exactly half-way between two codes round to even in both
    jv, js = (np.asarray(v) for v in jsq.sq_train(jnp.asarray(x)))
    tv, ts = tsq.sq_train(torch.from_numpy(x))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ts.numpy(), js)
    half = (jv + (np.arange(40) % 200 + 0.5).astype(np.float32) * js)[None, :]
    xx = np.concatenate([x, half.astype(np.float32)])
    jc = np.asarray(jsq.sq_encode(jnp.asarray(xx), jv, js))
    tc = tsq.sq_encode(torch.from_numpy(xx), tv, ts).numpy()
    assert tc.dtype == np.uint8
    np.testing.assert_array_equal(tc, jc)
    jd = np.asarray(jsq.sq_decode(jnp.asarray(jc), jv, js))
    td = tsq.sq_decode(torch.from_numpy(tc), tv, ts).numpy()
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_sq_search_matches_jax(rng, metric):
    x = rng.standard_normal((2500, 24)).astype(np.float32)
    q = rng.standard_normal((9, 24)).astype(np.float32)
    vmin, step = jsq.sq_train(jnp.asarray(x))
    codes = jsq.sq_encode(jnp.asarray(x), vmin, step)
    dec = jsq.sq_decode(codes, vmin, step)
    sqn = jnp.sum(dec * dec, -1)
    want = jsq.sq_search(jnp.asarray(q), codes, vmin, step, sqn, K, chunk=1024,
                         metric=metric)
    got = tsq.sq_search(_t(q), _t(codes), _t(vmin), _t(step), _t(sqn), K,
                        chunk=1024, metric=metric)
    _assert_same(got, want)


def test_block_selection_breaks_ties_by_block_id(rng):
    """The streams keep their top blocks by one tie-free top-k: the same
    minima as a plain top-k, equal minima (-0.0 and +0.0 among them) in
    ascending global block id, whatever the column order, so the card and
    the host keep the same blocks where quantised rows repeat."""
    vals = torch.from_numpy(rng.standard_normal((16, 300)).astype(np.float32))
    vals[:, 40:120] = vals[:, 40:41]  # 80 equal minima a row
    vals[:, 7], vals[:, 8] = -0.0, 0.0
    vals[:, 250:] = float("inf")
    blk = torch.stack([torch.randperm(300) for _ in range(16)])
    got, pos = tivf._smallest_blocks(vals, blk, 64)
    want, _ = torch.topk(vals, 64, dim=1, largest=False)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    perm = torch.randperm(300)
    got2, pos2 = tivf._smallest_blocks(vals[:, perm], blk[:, perm], 64)
    np.testing.assert_array_equal(torch.gather(blk, 1, pos).numpy(),
                                  torch.gather(blk[:, perm], 1, pos2).numpy())
    chosen = torch.gather(blk, 1, pos).numpy()
    for row, ids in enumerate(chosen):
        tied = np.sort(blk[row].numpy()[vals[row].numpy() == vals[row, 40].item()])
        kept = [i for i in ids if i in set(tied.tolist())]
        assert kept == sorted(kept) and kept == tied[: len(kept)].tolist()


ROUTES = {"bf16": 1, "bf16_full": 1, "bf16_slot_pen": 0, "f32": 0, "sq8": 0}


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("payload", list(ROUTES))
@pytest.mark.parametrize("name", ["masked", "fused"])
def test_ivf_stage_three_takes_the_kernel_on_unfiltered_bf16_lists(
        layout, monkeypatch, name, payload, metric):
    """Both streams hand stage 3 of an unfiltered IVF-Flat search over bf16
    lists to ``kernels.ivf_block_rescore``, once a search (its plain version
    on the host), and answer as the gathered chain does, bit for bit; a
    search with ``slot_pen``, over f32 lists or over IVF-SQ8 codes never
    calls it."""
    from vectordb_retrieval_tpu_torch.ops import kernels

    L = layout
    calls = []
    orig = kernels.ivf_block_rescore

    def spy(*a):
        calls.append(a[3].shape)
        return orig(*a)

    monkeypatch.setattr(kernels, "ivf_block_rescore", spy)
    head = (_t(L["q"]), _t(L["coarse"]), _t(L["slot"]))

    def search():
        if payload == "sq8":
            return tivf.ivf_sq_search(*head, _t(L["codes"]), _t(L["dsqn"]), _t(L["vmin"]),
                                      _t(L["step"]), K, 6, metric=metric)
        kw = {}
        if payload == "bf16_full":
            kw["full_vectors"] = _t(L["x"])
        if payload == "bf16_slot_pen":
            kw["slot_pen"] = _t(L["pen"])
        vecs = _t(L["vecs"] if payload == "f32" else L["vecs16"])
        return tivf.ivf_flat_search(*head, vecs, _t(L["sqn"]), K, 6, metric=metric, **kw)

    taken = []
    with regime(name, taken):
        got = search()
        assert len(calls) == ROUTES[payload]
        monkeypatch.setattr(tivf, "_use_kernel_rescore", lambda *a: False)
        want = search()
    assert taken == [name, name] and len(calls) == ROUTES[payload]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if calls:  # k + slack blocks of w slots, one row a query
        assert calls[0][0] == L["q"].shape[0]
