"""The port's serving layer (serving.py) against the JAX package's.

Each test of tests/test_serving.py has a counterpart here, at a small size
on the CPU. Flat indexes are deterministic, so both packages take the same
seeded inputs and must return the same ids and distances (rtol 1e-5: f32
sums taken in another order). A mutable IVF index trains k-means with each
package's own RNG, so a port-built index is held to the oracle (exact
search over the live rows, as the JAX tests hold theirs), and mutation and
search are held against the JAX package on a JAX-built index that the port
loads through ``models/persist.py``: the two then replay the same adds,
deletes and filtered searches and must agree in ids, distances and layout.
"""

import numpy as np
import pytest
import torch

from vectordb_retrieval_tpu import serving as js
from vectordb_retrieval_tpu.bench.metrics import recall_at_k
from vectordb_retrieval_tpu.models.factory import ANNSearcher as JaxANNSearcher
from vectordb_retrieval_tpu_torch import serving as ts
from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher
from vectordb_retrieval_tpu_torch.ops import ivf as tivf

torch.set_num_threads(2)
RTOL = 1e-5


def _flat(d, **kw):
    return ts.MutableFlatIndex(d, device="cpu", **kw)


def _ivf(x, **kw):
    return ts.MutableIVFIndex(x, device="cpu", **kw)


def _oracle(q, x, k, metric="l2"):
    if metric == "l2":
        d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    else:
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        d = -(qn @ xn.T)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _sqd(q, x, ids):
    return ((q[:, None, :] - x[np.where(ids >= 0, ids, 0)]) ** 2).sum(-1)


def _same(port, jax_out):
    """Both packages' ``(dists, ids)``: equal ids, distances to rtol."""
    (pd, pi), (jd, ji) = port, jax_out
    np.testing.assert_array_equal(pi, np.asarray(ji))
    np.testing.assert_allclose(pd, np.asarray(jd), rtol=RTOL, atol=1e-6)


def _pair_ivf(x, tmp_path, name="j", **kw):
    """A JAX-built mutable IVF index and the port's load of its save."""
    j = js.MutableIVFIndex(x, **kw)
    path = str(tmp_path / name)
    j.save(path)
    return j, ts.MutableIVFIndex.load(path, device="cpu")


def _layout(idx):
    """Every piece of host and device state that places a row."""
    nb = idx._nb
    return {
        "nb": nb,
        "physical": int(idx._slot_ids.shape[0]),
        "slots": np.asarray(idx._slot_ids)[:nb].tolist(),
        "bucket_lists": np.asarray(idx._bucket_lists)[:nb].tolist(),
        "fill": np.asarray(idx._fill)[:nb].tolist(),
        "list_buckets": {int(k): [int(b) for b in v] for k, v in idx._list_buckets.items()},
        "free": {int(k): [(int(b), int(s)) for b, s in v] for k, v in idx._list_free.items()},
        "id_loc": {int(k): (int(b), int(s)) for k, (b, s) in idx._id_loc.items()},
        "n_dead": int(idx._n_dead),
        "next_id": int(idx._next_id),
    }


# ---- MutableFlatIndex: counterparts of tests/test_serving.py ----------------


def test_add_search_matches_oracle(rng):
    x = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    idx, j = _flat(16), js.MutableFlatIndex(16)
    np.testing.assert_array_equal(idx.add(x), np.arange(500))
    j.add(x)
    d, got = idx.search(q, 5)
    _same((d, got), j.search(q, 5))
    exp = _oracle(q, x, 5)
    np.testing.assert_allclose(np.sort(_sqd(q, x, got), 1), np.sort(_sqd(q, x, exp), 1), rtol=1e-4)


def test_incremental_adds_grow_capacity(rng):
    idx, j = _flat(8, capacity=16), js.MutableFlatIndex(8, capacity=16)
    rows = []
    for _ in range(10):
        batch = rng.standard_normal((37, 8)).astype(np.float32)
        idx.add(batch)
        j.add(batch)
        rows.append(batch)
    x = np.concatenate(rows)
    assert idx.n_active == 370 and idx.capacity == j.capacity >= 370
    _, ids = idx.search(x[:4], 1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(4))


def test_delete_removes_from_results(rng):
    x = rng.standard_normal((200, 12)).astype(np.float32)
    idx, j = _flat(12), js.MutableFlatIndex(12)
    ids = idx.add(x)
    j.add(x)
    q = x[:5]
    _, before = idx.search(q, 1)
    np.testing.assert_array_equal(before[:, 0], np.arange(5))
    assert idx.delete(ids[:5]) == 5 == j.delete(ids[:5])
    d, after = idx.search(q, 3)
    assert not np.isin(after, np.arange(5)).any()
    _same((d, after), j.search(q, 3))
    exp = _oracle(q, x, 8)
    np.testing.assert_array_equal(after, np.array([[i for i in row if i >= 5][:3] for row in exp]))


def test_delete_twice_and_unknown_ids(rng):
    x = rng.standard_normal((50, 8)).astype(np.float32)
    idx = _flat(8)
    ids = idx.add(x)
    assert idx.delete(ids[:3]) == 3
    assert idx.delete(ids[:3]) == 0  # already gone
    assert idx.delete([10_000]) == 0  # never existed
    assert idx.delete([7, 7]) == 1  # a repeated id counts once
    assert idx.n_active == 46


def test_compaction_preserves_ids(rng):
    x = rng.standard_normal((300, 10)).astype(np.float32)
    idx, j = _flat(10, compact_frac=0.1), js.MutableFlatIndex(10, compact_frac=0.1)
    ids = idx.add(x)
    j.add(x)
    idx.delete(ids[:150])  # exceeds compact_frac -> auto-compact
    j.delete(ids[:150])
    assert idx._n_dead == 0 and idx.n_active == 150
    assert idx.capacity == j.capacity
    np.testing.assert_array_equal(idx._slot_ids, j._slot_ids)
    assert idx._id_to_slot == j._id_to_slot
    _, got = idx.search(x[150:155], 1)
    np.testing.assert_array_equal(got[:, 0], ids[150:155])


def test_filter_ids(rng):
    x = rng.standard_normal((100, 8)).astype(np.float32)
    idx, j = _flat(8), js.MutableFlatIndex(8)
    ids = idx.add(x)
    j.add(x)
    q = x[:3]
    d, got = idx.search(q, 4, filter_ids=ids[50:])
    assert (got >= 50).all()
    np.testing.assert_array_equal(got, _oracle(q, x[50:], 4) + 50)
    _same((d, got), j.search(q, 4, filter_ids=ids[50:]))


def test_cosine_metric(rng):
    x = rng.standard_normal((200, 16)).astype(np.float32)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    idx, j = _flat(16, metric="cosine"), js.MutableFlatIndex(16, metric="cosine")
    idx.add(x)
    j.add(x)
    d, got = idx.search(q, 5)
    assert (got == _oracle(q, x, 5, metric="cosine")).mean() > 0.9
    _same((d, got), j.search(q, 5))


def test_ip_delete_cannot_resurface(rng):
    """Zeroed dead rows must not outrank live negatives under ip."""
    x = -np.abs(rng.standard_normal((50, 8))).astype(np.float32)
    idx = _flat(8, metric="ip")
    ids = idx.add(x)
    idx.delete(ids[:10])
    _, got = idx.search(np.abs(rng.standard_normal((4, 8))).astype(np.float32), 5)
    assert not np.isin(got, ids[:10]).any() and (got >= 10).all()


@pytest.mark.parametrize("chunk_rows", [131_072, 512])
def test_large_streamed_path(rng, monkeypatch, chunk_rows):
    """Capacity above the chunk size takes the streamed scan."""
    monkeypatch.setattr(ts, "FLAT_CHUNK_ROWS", chunk_rows)
    x = rng.standard_normal((2000, 8)).astype(np.float32)
    idx, j = _flat(8, capacity=1024), js.MutableFlatIndex(8, capacity=1024)
    idx.add(x)
    j.add(x)
    d, ids = idx.search(x[:4], 2)
    np.testing.assert_array_equal(ids[:, 0], np.arange(4))
    assert np.allclose(d[:, 0], 0.0, atol=1e-4)
    _same((d, ids), j.search(x[:4], 2))


def test_empty_index_and_empty_add():
    idx = _flat(4)
    d, ids = idx.search(np.zeros((2, 4), np.float32), 3)
    assert (ids == -1).all() and np.isinf(d).all()
    assert idx.add(np.zeros((0, 4), np.float32)).shape == (0,)
    with pytest.raises(ValueError):
        idx.add(np.zeros((3, 5), np.float32))
    with pytest.raises(ValueError, match="unsupported metric"):
        _flat(4, metric="hamming")


# ---- MutableIVFIndex: counterparts of TestMutableIVF ------------------------


class TestMutableIVF:
    def test_build_and_search(self, rng):
        x = rng.standard_normal((1000, 16)).astype(np.float32)
        q = rng.standard_normal((8, 16)).astype(np.float32)
        idx = _ivf(x, nlist=8, nprobe=8)
        assert idx.n_active == 1000
        _, ids = idx.search(q, 10)  # all-probe == exact
        assert recall_at_k(_oracle(q, x, 10), ids, 10) == 1.0

    def test_add_then_find(self, rng):
        x = rng.standard_normal((500, 12)).astype(np.float32)
        idx = _ivf(x, nlist=4, nprobe=4)
        extra = rng.standard_normal((63, 12)).astype(np.float32)
        new_ids = idx.add(extra)
        assert idx.n_active == 563
        _, got = idx.search(extra[:10], 1)
        np.testing.assert_array_equal(got[:, 0], new_ids[:10])

    def test_add_overflows_into_new_buckets(self, rng, tmp_path):
        x = rng.standard_normal((64, 8)).astype(np.float32)
        j, idx = _pair_ivf(x, tmp_path, nlist=2, nprobe=2, bucket_len=8)
        nb0 = int(idx._slot_ids.shape[0])
        extra = rng.standard_normal((200, 8)).astype(np.float32)
        np.testing.assert_array_equal(idx.add(extra), j.add(extra))
        assert int(idx._slot_ids.shape[0]) > nb0  # grew buckets
        assert _layout(idx) == _layout(j)
        assert idx.n_active == 264
        _, got = idx.search(extra[:5], 1)
        assert (got[:, 0] >= 64).all()

    def test_delete(self, rng):
        x = rng.standard_normal((300, 8)).astype(np.float32)
        idx = _ivf(x, nlist=4, nprobe=4)
        q = x[:5]
        _, before = idx.search(q, 1)
        np.testing.assert_array_equal(before[:, 0], np.arange(5))
        assert idx.delete(np.arange(5)) == 5
        assert idx.delete(np.arange(5)) == 0
        _, after = idx.search(q, 5)
        assert not np.isin(after, np.arange(5)).any()

    def test_partial_probe_recall(self, rng):
        x = rng.standard_normal((2000, 16)).astype(np.float32)
        q = rng.standard_normal((16, 16)).astype(np.float32)
        idx = _ivf(x, nlist=16, nprobe=4)
        gt = _oracle(q, x, 10)
        r4 = recall_at_k(gt, idx.search(q, 10)[1], 10)
        r16 = recall_at_k(gt, idx.search(q, 10, nprobe=16)[1], 10)
        assert r16 == 1.0 and 0.4 < r4 <= r16


def test_ivf_growth_with_default_bucket_len(rng):
    """The default bucket_len rounds up to the pad multiple (250 -> 256):
    growth rows must use the PHYSICAL width."""
    x = rng.standard_normal((1000, 8)).astype(np.float32)
    idx = _ivf(x, nlist=8, nprobe=8)
    assert idx._L % 8 == 0
    extra = rng.standard_normal((600, 8)).astype(np.float32)
    new_ids = idx.add(extra)
    assert idx.n_active == 1600
    _, got = idx.search(extra[:5], 1)
    np.testing.assert_array_equal(got[:, 0], new_ids[:5])


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_mutable_flat_randomized_interleaving(rng, metric):
    """Fuzzed adds, deletes, compactions and searches: the port equals the
    JAX package step by step, and both equal the host oracle."""
    d = 12
    idx = _flat(d, metric=metric, capacity=16, compact_frac=0.3)
    j = js.MutableFlatIndex(d, metric=metric, capacity=16, compact_frac=0.3)
    oracle = {}
    for _ in range(30):
        op = rng.choice(["add", "add", "delete", "search"])
        if op == "add":
            batch = rng.standard_normal((int(rng.integers(1, 40)), d)).astype(np.float32)
            ids = idx.add(batch)
            np.testing.assert_array_equal(ids, j.add(batch))
            oracle.update({int(s): batch[i] for i, s in enumerate(ids)})
        elif op == "delete" and oracle:
            sids = rng.choice(list(oracle), size=min(len(oracle), 5), replace=False)
            assert idx.delete(sids) == len(sids) == j.delete(sids)
            for sid in sids:
                oracle.pop(int(sid))
        elif oracle:
            q = rng.standard_normal((3, d)).astype(np.float32)
            k = min(4, len(oracle))
            dist, got = idx.search(q, k)
            _same((dist, got), j.search(q, k))
            keys = np.array(sorted(oracle))
            exp = keys[_oracle(q, np.stack([oracle[int(s)] for s in keys]), k, metric)]
            np.testing.assert_array_equal(np.sort(got, 1), np.sort(exp, 1))
        assert idx.n_active == len(oracle) == j.n_active
        assert idx.capacity == j.capacity


def test_mutable_ivf_randomized_interleaving(rng, tmp_path):
    """Fuzzed IVF adds and deletes on a JAX-built index the port loaded:
    the same layout and the same answers as the JAX package after every
    step, all-probe searches equal to the oracle."""
    d = 10
    x0 = rng.standard_normal((300, d)).astype(np.float32)
    j, idx = _pair_ivf(x0, tmp_path, nlist=4, nprobe=4, bucket_len=32)
    oracle = {i: x0[i] for i in range(300)}
    for _ in range(9):
        op = rng.choice(["add", "delete", "search"])
        if op == "add":
            batch = rng.standard_normal((int(rng.integers(1, 60)), d)).astype(np.float32)
            ids = idx.add(batch)
            np.testing.assert_array_equal(ids, j.add(batch))
            oracle.update({int(s): batch[i] for i, s in enumerate(ids)})
        elif op == "delete" and oracle:
            sids = rng.choice(list(oracle), size=min(len(oracle), 8), replace=False)
            assert idx.delete(sids) == len(sids) == j.delete(sids)
            for sid in sids:
                oracle.pop(int(sid))
        elif oracle:
            q = rng.standard_normal((3, d)).astype(np.float32)
            k = min(5, len(oracle))
            dist, got = idx.search(q, k, nprobe=idx.nlist)
            _same((dist, got), j.search(q, k, nprobe=j.nlist))
            keys = np.array(sorted(oracle))
            exp = keys[_oracle(q, np.stack([oracle[int(s)] for s in keys]), k)]
            np.testing.assert_array_equal(np.sort(got, 1), np.sort(exp, 1))
        assert _layout(idx) == _layout(j)
        assert idx.n_active == len(oracle)


# ---- slot reuse, bulk add, compaction, persistence, snapshot ----------------


def test_ivf_slot_reuse_and_compaction(rng):
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    idx = _ivf(x, nlist=16, nprobe=16)
    nb0 = idx._nb
    ids = np.arange(2000)
    # churn: delete, then re-add as many; free slots are reused, so the
    # bucket count must not grow
    for _ in range(4):
        dead = rng.choice(ids, 800, replace=False)
        idx.delete(dead)
        ids = np.setdiff1d(ids, dead)
        ids = np.concatenate([ids, idx.add(rng.standard_normal((800, 16)).astype(np.float32))])
    assert idx.n_active == 2000
    assert idx._nb <= nb0 + 16  # slack for per-list rounding only
    q = rng.standard_normal((8, 16)).astype(np.float32)
    d0, _ = idx.search(q, 5)
    idx.compact()
    d1, _ = idx.search(q, 5)
    np.testing.assert_allclose(np.sort(d0, 1), np.sort(d1, 1), rtol=1e-4)
    assert idx._n_dead == 0


def test_ivf_bulk_add_matches_oracle(rng):
    x0 = rng.standard_normal((1000, 12)).astype(np.float32)
    idx = _ivf(x0, nlist=8, nprobe=8)
    bulk = rng.standard_normal((5000, 12)).astype(np.float32)
    new_ids = idx.add(bulk)
    assert idx.n_active == 6000
    full = np.concatenate([x0, bulk])
    q = rng.standard_normal((16, 12)).astype(np.float32)
    _, got = idx.search(q, 10)
    np.testing.assert_allclose(
        np.sort(_sqd(q, full, got), 1), np.sort(_sqd(q, full, _oracle(q, full, 10)), 1), rtol=1e-4)
    np.testing.assert_array_equal(new_ids, np.arange(1000, 6000))


def test_mutable_flat_persistence_roundtrip(tmp_path, rng):
    """The port's save loads in the port and in the JAX package; the JAX
    package's save loads in the port; all four answer alike and keep
    handing out fresh ids."""
    x = rng.standard_normal((300, 10)).astype(np.float32)
    idx, j = _flat(10), js.MutableFlatIndex(10)
    ids = idx.add(x)
    j.add(x)
    idx.delete(ids[:20])
    j.delete(ids[:20])
    ctx = {"dataset_fingerprint": "f"}
    idx.save(str(tmp_path / "port"), ctx)
    j.save(str(tmp_path / "jax"), ctx)
    loaded = [
        ts.MutableFlatIndex.load(str(tmp_path / "port"), ctx, device="cpu"),
        ts.MutableFlatIndex.load(str(tmp_path / "jax"), ctx, device="cpu"),
    ]
    j2 = js.MutableFlatIndex.load(str(tmp_path / "port"), ctx)
    q = rng.standard_normal((6, 10)).astype(np.float32)
    d0, i0 = idx.search(q, 5)
    for other in loaded:
        d1, i1 = other.search(q, 5)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_allclose(d0, d1, rtol=1e-6)
        assert other._n_dead == 20 and other._slot_ids.dtype == np.int64
    _same((d0, i0), j2.search(q, 5))
    new = rng.standard_normal((3, 10)).astype(np.float32)
    assert loaded[0].add(new).min() >= 300
    np.testing.assert_array_equal(loaded[1].add(new), j2.add(new))
    with pytest.raises(ValueError, match="dataset_fingerprint"):
        ts.MutableFlatIndex.load(str(tmp_path / "port"), {"dataset_fingerprint": "g"}, device="cpu")


def test_mutable_ivf_persistence_roundtrip(tmp_path, rng):
    x = rng.standard_normal((800, 12)).astype(np.float32)
    idx = _ivf(x, nlist=8, nprobe=8)
    idx.delete(np.arange(50))
    idx.add(rng.standard_normal((100, 12)).astype(np.float32))
    idx.save(str(tmp_path / "mi"))
    idx2 = ts.MutableIVFIndex.load(str(tmp_path / "mi"), device="cpu")
    # the JAX package loads the port's save, layout and all
    j2 = js.MutableIVFIndex.load(str(tmp_path / "mi"))
    q = rng.standard_normal((6, 12)).astype(np.float32)
    d0, i0 = idx.search(q, 5)
    d1, i1 = idx2.search(q, 5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(d0, d1, rtol=1e-6)
    _same((d1, i1), j2.search(q, 5))
    assert _layout(idx2) == _layout(j2)


def test_jax_saved_indexes_replay_alike_in_the_port(tmp_path, rng):
    """JAX-saved mutable_flat and mutable_ivf directories load in the port
    and replay the same adds, deletes and filtered searches with equal ids
    and distances."""
    x = rng.standard_normal((600, 12)).astype(np.float32)
    jf = js.MutableFlatIndex(12)
    jf.add(x)
    jf.delete(np.arange(0, 600, 7))
    jf.save(str(tmp_path / "flat"))
    tf = ts.MutableFlatIndex.load(str(tmp_path / "flat"), device="cpu")
    ji, ti = _pair_ivf(x, tmp_path, nlist=6, nprobe=3)
    q = rng.standard_normal((5, 12)).astype(np.float32)
    allow = rng.choice(800, 200, replace=False)
    for step in range(2):
        batch = rng.standard_normal((40, 12)).astype(np.float32)
        dead = rng.choice(600 + 40 * step, 30, replace=False)
        for jx, tx in ((jf, tf), (ji, ti)):
            np.testing.assert_array_equal(tx.add(batch), jx.add(batch))
            assert tx.delete(dead) == jx.delete(dead)
            _same(tx.search(q, 6), jx.search(q, 6))
            _same(tx.search(q, 6, filter_ids=allow), jx.search(q, 6, filter_ids=allow))
        assert _layout(ti) == _layout(ji)


def test_snapshot_handoff_to_annsearcher(rng):
    x = rng.standard_normal((1200, 16)).astype(np.float32)
    idx = _ivf(x, nlist=8, nprobe=8)
    idx.delete(np.arange(100))
    added = idx.add(rng.standard_normal((50, 16)).astype(np.float32))
    art = idx.to_artifact()
    assert art.kind == "ivf_flat" and art.metadata["mutable_snapshot"]
    s = ANNSearcher(nprobe=8, device="cpu")
    s.attach(art)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    d_live, i_live = idx.search(q, 5)
    d_art, i_art = s.batch_search(q, 5)
    np.testing.assert_array_equal(i_live, i_art)  # stable ids preserved
    np.testing.assert_allclose(d_live, d_art, rtol=RTOL)
    assert int(i_art.max()) >= int(added.min())
    # the snapshot is a copy: later mutations do not reach it
    idx.delete(i_live[:, 0])
    np.testing.assert_array_equal(s.batch_search(q, 5)[1], i_art)

    flat = _flat(16)
    fid = flat.add(x[:500])
    flat.delete(fid[:100])
    fart = flat.to_artifact()
    s2 = ANNSearcher(device="cpu")
    s2.attach(fart)
    d_l, i_l = flat.search(q, 5)
    d_a, i_a = s2.batch_search(q, 5)
    np.testing.assert_array_equal(i_l, i_a)
    np.testing.assert_allclose(d_l, d_a, rtol=RTOL)


def test_snapshot_matches_jax_snapshot(rng, tmp_path):
    """The port's snapshot of a JAX-built index equals the JAX package's
    snapshot, array for array, and both packages' ANNSearchers return the
    same ids."""
    x = rng.standard_normal((900, 12)).astype(np.float32)
    j, idx = _pair_ivf(x, tmp_path, nlist=6, nprobe=6)
    for o in (j, idx):
        o.delete(np.arange(0, 900, 5))
        o.add(x[:30] + 0.5)
    jart, tart = j.to_artifact(), idx.to_artifact()
    assert jart.metadata == tart.metadata
    for key, val in jart.data.items():
        np.testing.assert_allclose(tart.data[key].numpy(), np.asarray(val), rtol=1e-6, err_msg=key)
    q = rng.standard_normal((7, 12)).astype(np.float32)
    s, sj = ANNSearcher(nprobe=6, device="cpu"), JaxANNSearcher(nprobe=6)
    s.attach(tart)
    sj.attach(jart)
    _same(s.batch_search(q, 5), sj.batch_search(q, 5))


def test_churn_fuzz_large_scale(rng):
    """Interleaved add / delete / compact / search against the oracle (the
    JAX test's 100k rows cut to 20k for the CPU)."""
    d = 16
    x = rng.standard_normal((20_000, d)).astype(np.float32)
    idx = _ivf(x, nlist=32, nprobe=32)  # full probe = exact
    live = {i: x[i] for i in range(20_000)}
    for step in range(6):
        op = step % 3
        if op == 0:
            dead = rng.choice(list(live), 1000, replace=False)
            assert idx.delete(dead) == 1000
            for i in dead:
                live.pop(int(i))
        elif op == 1:
            batch = rng.standard_normal((800, d)).astype(np.float32)
            live.update({int(i): batch[j] for j, i in enumerate(idx.add(batch))})
        else:
            idx.compact()
        q = rng.standard_normal((4, d)).astype(np.float32)
        dists, got = idx.search(q, 10)
        vals = np.stack(list(live.values()))
        exp = np.sort(((q[:, None, :] - vals[None]) ** 2).sum(-1), 1)[:, :10]
        np.testing.assert_allclose(np.sort(dists, 1), exp, rtol=1e-3, atol=1e-3)
        assert all(int(i) in live for row in got for i in row if i >= 0)
    assert idx.n_active == len(live)


def test_mutable_ivf_load_add_preserves_live_rows(tmp_path, rng):
    """load() restores the per-bucket fill as the append WATERMARK, and an
    interior tombstone goes to the free list: the first add after a load
    must not overwrite a live row."""
    d = 8
    x = rng.standard_normal((256, d)).astype(np.float32)
    idx = _ivf(x, nlist=4, nprobe=4)
    assert idx.delete([3]) == 1  # an interior slot: slots fill in id order
    idx.save(str(tmp_path / "mi"))
    idx2 = ts.MutableIVFIndex.load(str(tmp_path / "mi"), device="cpu")
    j2 = js.MutableIVFIndex.load(str(tmp_path / "mi"))
    assert idx2._n_dead == 1
    new_rows = rng.standard_normal((16, d)).astype(np.float32)
    new_ids = idx2.add(new_rows)
    j2.add(new_rows)
    assert _layout(idx2) == _layout(j2)  # the watermark case, layout for layout
    keep = np.array([0, 1, 2, 10, 100, 255])
    _, got = idx2.search(x[keep], 1)
    np.testing.assert_array_equal(got[:, 0], keep)
    _, got_new = idx2.search(new_rows[:4], 1)
    np.testing.assert_array_equal(got_new[:, 0], new_ids[:4])
    assert idx2.n_active == 256 - 1 + 16


def test_mutable_ivf_churn_does_not_inflate_dead_count(rng):
    """add() reusing a freed slot decrements the dead count."""
    x = rng.standard_normal((512, 8)).astype(np.float32)
    idx = _ivf(x, nlist=4, nprobe=4)
    for i in range(64):
        victim = idx.search(x[i : i + 1], 1)[1][0, 0]
        assert idx.delete([int(victim)]) == 1
        idx.add(x[i : i + 1])  # the same list: the freed slot is reused
        assert idx._n_dead == 0, f"step {i}: dead={idx._n_dead}"


def test_ivf_filter_pushdown_matches_oracle(rng):
    x = rng.standard_normal((600, 12)).astype(np.float32)
    q = rng.standard_normal((7, 12)).astype(np.float32)
    idx = _ivf(x, nlist=8, nprobe=8)  # all lists probed
    allow = np.arange(0, 600, 3)
    d, got = idx.search(q, 5, filter_ids=allow)
    assert np.isin(got[got >= 0], allow).all()
    ed = np.sort(_sqd(q, x[allow], _oracle(q, x[allow], 5)), 1)
    np.testing.assert_allclose(np.sort(d, 1), ed, rtol=1e-3, atol=1e-4)


def test_ivf_filter_interacts_with_delete(rng):
    x = rng.standard_normal((300, 10)).astype(np.float32)
    idx = _ivf(x, nlist=4, nprobe=4)
    idx.delete(np.arange(0, 300, 2))
    _, got = idx.search(x[:4], 6, filter_ids=np.arange(0, 300))
    assert (got[got >= 0] % 2 == 1).all(), "deleted rows must not pass the filter"
    # allowed set smaller than k: pad with -1/inf instead of leaking
    d2, got2 = idx.search(x[:4], 6, filter_ids=np.array([1, 3]))
    assert set(got2[got2 >= 0].tolist()) <= {1, 3}
    assert np.isinf(np.sort(d2, 1)[:, -1]).all()


def test_ivf_filter_small_allowlist_exact(rng):
    """A tiny allow-list returns exactly those rows, even from lists the
    unfiltered top-k never reaches."""
    x = rng.standard_normal((400, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    idx = _ivf(x, nlist=5, nprobe=5)
    allow = np.array([17, 230, 391])
    _, got = idx.search(q, 3, filter_ids=allow)
    np.testing.assert_array_equal(np.sort(got, 1), np.sort(allow[_oracle(q, x[allow], 3)], 1))


# ---- the port's own contracts -----------------------------------------------


def test_compact_layout_equals_jax(rng, tmp_path):
    """compact() repacks each list's live rows in bucket then slot order,
    as the JAX package's loop does (vectorised here)."""
    x = rng.standard_normal((700, 8)).astype(np.float32)
    j, idx = _pair_ivf(x, tmp_path, nlist=5, nprobe=5, bucket_len=16)
    for o in (j, idx):
        o.compact_frac = 10.0  # no automatic compaction: compact explicitly
        o.add(rng.standard_normal((90, 8)).astype(np.float32) * 0 + x[:90])
        o.delete(np.arange(3, 790, 4))
    assert _layout(idx) == _layout(j)
    j.compact()
    idx.compact()
    assert _layout(idx) == _layout(j)
    np.testing.assert_allclose(idx._list_vecs.numpy(), np.asarray(j._list_vecs), rtol=1e-6)


def test_streamed_scan_tie_order_bit_for_bit():
    """Integer rows tie exactly; the streamed and the dense scans keep the
    lower slot among equal distances, as jax.lax.top_k does: ids and
    distances equal the JAX package's bit for bit."""
    import jax.numpy as jnp

    g = np.random.default_rng(3)
    x = g.integers(0, 3, (700, 4)).astype(np.float32)  # many exact ties
    q = g.integers(0, 3, (6, 4)).astype(np.float32)
    sq = (x * x).sum(-1)
    pen = np.where(g.random(700) < 0.2, np.inf, 0.0).astype(np.float32)
    for chunk_rows in (64, 100, 1024):
        for metric in ("l2", "ip"):
            jd, ji = js._masked_search(jnp.asarray(q), jnp.asarray(x), jnp.asarray(sq),
                                       jnp.asarray(pen), 25, metric, chunk_rows=chunk_rows)
            td, ti = ts._masked_search(torch.as_tensor(q), torch.as_tensor(x), torch.as_tensor(sq),
                                       torch.as_tensor(pen), 25, metric, chunk_rows=chunk_rows)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    with pytest.raises(ValueError, match="dense path"):
        ts._masked_search(torch.as_tensor(q), torch.as_tensor(x), torch.as_tensor(sq),
                          torch.zeros((6, 700)), 5, "l2", chunk_rows=64)


def test_allow_list_and_penalty_equal_jax(rng):
    import jax.numpy as jnp

    ids = rng.choice(5000, 300, replace=False).tolist() + [-1]
    np.testing.assert_array_equal(ts._pad_allow_list(ids), js._pad_allow_list(ids))
    slot_ids = rng.integers(-1, 5000, (40, 16)).astype(np.int32)
    allow = ts._pad_allow_list(ids[:120])
    np.testing.assert_array_equal(
        ts._allow_penalty(torch.as_tensor(slot_ids), torch.as_tensor(allow)).numpy(),
        np.asarray(js._allow_penalty(jnp.asarray(slot_ids), jnp.asarray(allow))))
    for bad in ([2**31 - 1], [-2]):
        with pytest.raises(ValueError, match="int32"):
            ts._pad_allow_list(bad)


def test_coarse_probes_take_tied_buckets_in_row_order():
    """A list's buckets share its centroid row and tie exactly. A probe
    budget that cuts through them takes the lowest rows, so the card and
    the host probe the same buckets; the JAX package's cut (approx_max_k)
    takes some of the tied rows, at the same distances."""
    import jax.numpy as jnp

    from vectordb_retrieval_tpu.ops import ivf as jivf

    cents = np.array([[0.0, 0.0], [5.0, 5.0], [1.0, 1.0]], np.float32)
    coarse = cents[[1, 2, 0, 2, 0, 0, 2]]  # lists 0 and 2 own several buckets
    q = np.array([[0.2, 0.1], [0.9, 1.2], [3.0, 3.0]], np.float32)
    dist = ((q[:, None, :] - coarse[None]) ** 2).sum(-1)
    for budget in (1, 2, 3, 4, 5):
        got = tivf._coarse_probes(torch.as_tensor(q), torch.as_tensor(coarse), budget).numpy()
        np.testing.assert_array_equal(got, np.argsort(dist, axis=1, kind="stable")[:, :budget])
        want = np.asarray(jivf._coarse_probes(jnp.asarray(q), jnp.asarray(coarse), budget))
        np.testing.assert_allclose(np.take_along_axis(dist, got, 1),
                                   np.take_along_axis(dist, want, 1), rtol=1e-6)


def test_search_routes_and_probe_budget(rng, tmp_path):
    """The probe budget (quantised up to a power of two, capped by the
    physical rows) equals the JAX package's formula, and route() names
    the regime ivf_flat_search takes."""
    x = rng.standard_normal((900, 8)).astype(np.float32)
    j, idx = _pair_ivf(x, tmp_path, nlist=9, nprobe=2, bucket_len=40)
    physical, L = idx._slot_ids.shape
    lens = sorted((len(b) for b in idx._list_buckets.values()), reverse=True)
    for npb in (1, 2, 5, 9):
        eff = min(max(1, sum(lens[:npb])), physical)
        assert idx.probe_budget(npb) == min(1 << (eff - 1).bit_length(), physical)
    assert idx.route(1, 1) == "probe_scan"
    assert idx.route(256) == ("fused" if physical % 8 == 0 and L % 8 == 0 else "masked")


def test_ivf_id_space_overflow_raises(rng):
    x = rng.standard_normal((64, 4)).astype(np.float32)
    idx = _ivf(x, nlist=2, nprobe=2)
    idx._next_id = 2**31 - 2
    with pytest.raises(OverflowError, match="2\\^31"):
        idx.add(x[:4])
    flat = _flat(4)
    flat.add(x[:4])
    flat._next_id = 2**31
    with pytest.raises(OverflowError, match="int32"):
        flat.to_artifact()
