"""The port's IVF ops (ops/ivf.py, ops/sq.py) against the JAX package's.

Inputs are built once by the JAX package (k-means, bucketed layout,
quantised payloads, IVF-PQ codebooks and codes) and handed to both as the
same arrays. Each list coding (f32 or bf16 IVF-Flat lists, with or
without ``slot_pen`` or ``full_vectors``, IVF-PQ's resident
reconstructions, IVF-SQ8 codes) runs in each of the three regimes, forced
in both packages the way the JAX package's own tests force them:
``_use_stream`` swapped, and the fused stream switched on with
``FORCE_FUSED_INTERPRET`` (JAX, Pallas interpret mode) or off with
``_use_fused`` (the port, which otherwise takes it on any device); the
port's one regime choice (``ivf_route``) reads both, so one swap forces
every coding. Ids must be equal as sorted sets per query (tie-free random
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
from vectordb_retrieval_tpu.ops import pq as jpq
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
    # IVF-PQ: m 8 over the live slots' residuals to their bucket's centroid
    live = (slot_np >= 0)[:, :, None]
    resid = np.where(live, vecs - coarse[:, None, :], 0.0).astype(np.float32).reshape(-1, d)
    books = jpq.pq_train(jnp.asarray(resid[live.reshape(-1)]), 8, iters=6)
    pq_codes = jpq.pq_encode(jnp.asarray(resid), books)
    pq_sqn = np.asarray(jpq.pq_code_sqnorms(pq_codes, books)).reshape(slot_np.shape)
    return {
        "x": x, "q": q, "nlist": nlist, "cents": np.asarray(cents),
        "slot": slot_np, "bl": bl_np, "coarse": coarse, "vecs": vecs,
        "vecs16": np.asarray(jnp.asarray(vecs).astype(jnp.bfloat16)),
        "sqn": sqn, "codes": codes.reshape(vecs.shape), "vmin": vmin,
        "step": step, "dsqn": (dec * dec).sum(-1).reshape(slot_np.shape),
        "pen": pen, "cum": jivf.probe_budget_cum(bl_np, nlist),
        "books": np.asarray(books), "pq_codes": np.asarray(pq_codes).reshape(slot_np.shape + (8,)),
        "pq_sqn": pq_sqn,
    }


@contextlib.contextmanager
def regime(name, taken):
    """Force one regime in both packages; record which port stage ran.
    ``probe_g1``: the port's probe scan one bucket a step."""
    saved = (jivf._use_stream, jivf.FORCE_FUSED_INTERPRET, tivf._use_stream,
             tivf._use_fused, tivf._probe_scan, tivf._masked_stream,
             tivf._fused_stream, tivf._PROBE_GROUP_BYTES)

    def spy(fn, label):
        def wrapped(*a, **kw):
            taken.append(label)
            return fn(*a, **kw)
        return wrapped

    try:
        stream = not name.startswith("probe")
        jivf._use_stream = tivf._use_stream = lambda *a: stream
        jivf.FORCE_FUSED_INTERPRET = name == "fused"
        if name == "masked":
            tivf._use_fused = lambda *a: 0
        if name == "probe_g1":
            tivf._PROBE_GROUP_BYTES = 1
        tivf._probe_scan = spy(saved[4], "probe")
        tivf._masked_stream = spy(saved[5], "masked")
        tivf._fused_stream = spy(saved[6], "fused")
        jax.clear_caches()
        yield
    finally:
        (jivf._use_stream, jivf.FORCE_FUSED_INTERPRET, tivf._use_stream,
         tivf._use_fused, tivf._probe_scan, tivf._masked_stream,
         tivf._fused_stream, tivf._PROBE_GROUP_BYTES) = saved
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


# the list codings: IVF-Flat's f32 lists ("f32", "slot_pen") and bf16 ones
# ("bf16", "bf16_slot_pen", "bf16_full": rescored against the f32 rows),
# IVF-SQ8's codes, IVF-PQ's resident reconstructions
PAYLOADS = ["f32", "bf16_full", "slot_pen", "sq8", "bf16", "bf16_slot_pen", "pq"]


def _search(L, payload, nprobe, metric, kw, to, package, slots=None):
    """One IVF search of ``payload``'s coding in ``package`` (``jivf`` or
    ``tivf``), arrays through ``to``; ``slots`` replaces the slot ids."""
    head = (to(L["q"]), to(L["coarse"]), to(L["slot"]) if slots is None else slots)
    if payload == "sq8":
        return package.ivf_sq_search(
            *head, to(L["codes"]), to(L["dsqn"]), to(L["vmin"]), to(L["step"]), K, nprobe,
            metric=metric, **kw)
    if payload == "pq":
        return package.ivf_pq_search(
            *head, to(L["pq_codes"]), to(L["pq_sqn"]), to(L["books"]), K, nprobe,
            metric=metric, **kw)
    extra = {}
    if payload == "bf16_full":
        extra["full_vectors"] = to(L["x"])
    if payload.endswith("slot_pen"):
        extra["slot_pen"] = to(L["pen"])
    vecs = L["vecs"] if payload in ("f32", "slot_pen") else L["vecs16"]
    return package.ivf_flat_search(*head, to(vecs), to(L["sqn"]), K, nprobe, metric=metric,
                                   **kw, **extra)


@pytest.mark.parametrize("semantics", ["coarse", "lists"])
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("name", ["probe", "probe_g1", "masked", "fused"])
def test_ivf_search_matches_jax_in_each_regime(layout, name, metric, payload, semantics):
    """Every list coding in every regime against the JAX package's search
    on the same arrays; bf16 lists without ``full_vectors`` are compared
    on their bf16-product scores (the probe scan) or their exact rescore
    against the bf16 rows (the streams)."""
    L = layout
    nprobe, jkw, tkw = _probe_args(L, semantics)
    taken = []
    with regime(name, taken):
        want = _search(L, payload, nprobe, metric, jkw, jnp.asarray, jivf)
        got = _search(L, payload, nprobe, metric, tkw, _t, tivf)
    assert taken == [name.split("_")[0]]
    _assert_same(got, want)
    if payload.endswith("slot_pen"):  # filtered slots never come back
        filtered = set(L["slot"][np.isinf(L["pen"]) & (L["slot"] >= 0)].tolist())
        assert not filtered & set(got[1].numpy().ravel().tolist())


def test_ivf_route_reads_the_batch_and_the_layout():
    """The one regime choice: the probe scan below one probe a bucket,
    else the fused stream on the bucketed layout, else the masked one."""
    assert tivf.ivf_route(4, 2, 16, 64) == "probe_scan"
    assert tivf.ivf_route(8, 2, 16, 64) == "fused_k1"
    assert tivf.ivf_route(8, 2, 16, 36) == "masked_stream"  # no w divides L
    assert tivf.ivf_route(8, 2, 12, 64) == "masked_stream"  # n_buckets % 8
    assert tivf.ivf_route(1, 64, 16, 64) == "fused_k1"  # nprobe capped at n_buckets


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


ROUTES = {"bf16": 1, "bf16_full": 1, "bf16_slot_pen": 0, "f32": 0, "sq8": 0, "pq": 1}


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("payload", list(ROUTES))
@pytest.mark.parametrize("name", ["masked", "fused"])
def test_ivf_stage_three_takes_the_kernel_on_unfiltered_bf16_lists(
        layout, monkeypatch, name, payload, metric):
    """Both streams hand stage 3 of an unfiltered search over bf16 rows
    (IVF-Flat's bf16 lists, IVF-PQ's resident reconstructions) to
    ``kernels.ivf_block_rescore``, once a search (its plain version on the
    host), and answer as the gathered chain does, bit for bit (the chain
    taken by int64 slot ids); a search with ``slot_pen``, over f32 lists
    or over IVF-SQ8 codes never calls it."""
    from vectordb_retrieval_tpu_torch.ops import kernels

    L = layout
    calls = []
    orig = kernels.ivf_block_rescore

    def spy(*a):
        calls.append(a[3].shape)
        return orig(*a)

    monkeypatch.setattr(kernels, "ivf_block_rescore", spy)
    taken = []
    with regime(name, taken):
        got = _search(L, payload, 6, metric, {}, _t, tivf)
        assert len(calls) == ROUTES[payload]
        want = _search(L, payload, 6, metric, {}, _t, tivf, slots=_t(L["slot"]).long())
    assert taken == [name, name] and len(calls) == ROUTES[payload]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if calls:  # k + slack blocks of w slots, one row a query
        assert calls[0][0] == L["q"].shape[0]
