"""The port's sharded serving indexes (parallel/serving.py) against the JAX
package's, on the CPU.

Both packages replay the same mutation sequences (adds, deletes, filtered
searches, growth, compaction) on meshes of the same shape (the JAX side on
the conftest's 8 virtual devices, the port on ``["cpu"] * P``), and after
every step hold the same host layout: per-shard fill, slot tables, id maps,
free-slot stacks, bucket claims and dead counts, and the same search ids
(distances within rtol 1e-5: f32 sums in another order; random float rows,
no ties). The mutable IVF index trains k-means with each package's own RNG,
so the port's replay starts from the JAX index's centroids; port-built
indexes are held to the oracle (exact search over the live rows).
"""

import numpy as np
import pytest
import torch

from vectordb_retrieval_tpu.parallel import make_mesh as jax_mesh
from vectordb_retrieval_tpu.parallel import serving as js
from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher
from vectordb_retrieval_tpu_torch.parallel import make_mesh
from vectordb_retrieval_tpu_torch.parallel import serving as ts

torch.set_num_threads(2)
D = 16
RTOL = 1e-5


def _meshes(shape=None):
    """(JAX mesh, port mesh) of one shape: db 8, or (replica, db)."""
    if shape is None:
        return jax_mesh(8), make_mesh(devices=["cpu"] * 8)
    n = int(np.prod(shape))
    return (jax_mesh(n, ("replica", "db"), shape),
            make_mesh(n, ("replica", "db"), shape, devices=["cpu"] * n))


def _same_search(j, t, q, k, **kw):
    jd, ji = j.search(q, k, **kw)
    td, ti = t.search(q, k, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=1e-5)
    return td, ti


def _oracle_ids(q, rows, ids, k, metric="l2"):
    q, rows = q.astype(np.float64), rows.astype(np.float64)
    if metric == "l2":
        d = ((q[:, None, :] - rows[None]) ** 2).sum(-1)
    else:
        if metric == "cosine":
            q, rows = (a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
                       for a in (q, rows))
        d = -(q @ rows.T)
    return ids[np.argsort(d, axis=1, kind="stable")[:, :k]]


# -- ShardedMutableFlat ------------------------------------------------------


def _flat_pair(metric="l2", shape=None, q_axis=None, cap=16):
    jm, tm = _meshes(shape)
    return (js.ShardedMutableFlat(D, jm, metric=metric, capacity_per_shard=cap, q_axis=q_axis),
            ts.ShardedMutableFlat(D, tm, metric=metric, capacity_per_shard=cap, q_axis=q_axis))


def _same_flat_layout(j, t):
    np.testing.assert_array_equal(t.shard_fill(), j.shard_fill())
    np.testing.assert_array_equal(t._slot_ids, j._slot_ids)
    assert t._id_to_slot == j._id_to_slot
    assert (t._dead, t.capacity, t.n_active) == (j._dead, j.capacity, j.n_active)


@pytest.mark.parametrize("metric,shape,q_axis", [
    ("l2", None, None), ("ip", None, None), ("cosine", None, None),
    ("l2", (2, 4), "replica"), ("l2", (2, 4), None),
])
def test_flat_mutation_fuzz_matches_jax(rng, metric, shape, q_axis):
    """Adds (growth), deletes (with the automatic compaction), filtered
    searches: layouts and results equal to the JAX package's after every
    step, on the db ring and on the replica mesh."""
    j, t = _flat_pair(metric, shape, q_axis)
    q = rng.standard_normal((6, D)).astype(np.float32)
    rows = np.zeros((0, D), np.float32)
    for step in range(8):
        x = rng.standard_normal((int(rng.integers(1, 48)), D)).astype(np.float32)
        rows = np.concatenate([rows, x])
        np.testing.assert_array_equal(t.add(x), j.add(x))
        _same_flat_layout(j, t)
        _same_search(j, t, q, 9)
        dead = rng.choice(t._next_id, min(t._next_id, int(rng.integers(0, 30))), replace=False)
        assert t.delete(dead) == j.delete(dead)
        _same_flat_layout(j, t)
        live = np.asarray(sorted(t._id_to_slot))
        allow = rng.choice(live, max(1, live.size // 3), replace=False)
        _, ids = _same_search(j, t, q, 9, filter_ids=allow)
        assert np.isin(ids[ids >= 0], allow).all()
    # the port's results are the oracle's: exact search over the live rows
    _, ids = t.search(q, 9)
    np.testing.assert_array_equal(ids, _oracle_ids(q, rows[live], live, 9, metric))


def test_flat_balance_growth_and_compaction(rng):
    j, t = _flat_pair(cap=8)
    x = rng.standard_normal((200, D)).astype(np.float32)
    t.add(x)
    j.add(x)
    assert t.shard_fill().max() - t.shard_fill().min() <= 1  # emptiest first
    assert t.capacity == j.capacity == 8 * 32
    _same_flat_layout(j, t)
    dead = np.arange(0, 200, 3)
    t.delete(dead)
    j.delete(dead)  # 67 > 64 dead: both compact
    assert t._dead == 0 and t.n_active == 133
    _same_flat_layout(j, t)
    q = rng.standard_normal((5, D)).astype(np.float32)
    _same_search(j, t, q, 7)
    t.compact()
    j.compact()
    _same_flat_layout(j, t)


def test_flat_snapshot_to_annsearcher(rng):
    j, t = _flat_pair()
    x = rng.standard_normal((300, D)).astype(np.float32)
    t.add(x)
    t.delete(np.arange(0, 300, 4))
    q = rng.standard_normal((6, D)).astype(np.float32)
    want = t.search(q, 10)
    art = t.to_artifact()
    assert art.kind == "flat" and art.metadata["n_vectors"] == 225
    s = ANNSearcher(device="cpu")
    s.attach(art)
    got = s.batch_search(q, 10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=1e-5)


def test_flat_empty_index():
    t = ts.ShardedMutableFlat(D, make_mesh(devices=["cpu"] * 4))
    d, i = t.search(np.zeros((2, D), np.float32), 3)
    assert (i == -1).all() and np.isinf(d).all()
    assert t.add(np.zeros((0, D), np.float32)).shape == (0,)
    with pytest.raises(ValueError, match="add expects"):
        t.add(np.zeros((2, D + 1), np.float32))


# -- ShardedMutableIVF -------------------------------------------------------


def _ivf_pair(x, monkeypatch, shape=None, q_axis=None, n_shards=4, **kw):
    """A JAX index and the port's, built from the JAX index's centroids."""
    if shape is None:
        jm, tm = jax_mesh(n_shards), make_mesh(devices=["cpu"] * n_shards)
    else:
        jm, tm = _meshes(shape)
    j = js.ShardedMutableIVF(x, jm, q_axis=q_axis, **kw)
    cent = torch.as_tensor(np.asarray(j.centroids))
    with monkeypatch.context() as m:
        m.setattr(ts, "kmeans_fit", lambda xs, k, seed=0, iters=20: (cent.to(xs.device), None))
        t = ts.ShardedMutableIVF(x, tm, q_axis=q_axis, **kw)
    return j, t


def _same_ivf_layout(j, t):
    np.testing.assert_array_equal(t._bucket_lists, j._bucket_lists)
    np.testing.assert_array_equal(t._slot_host, j._slot_host)
    np.testing.assert_array_equal(t._fill, j._fill)
    np.testing.assert_array_equal(np.asarray(t._slot_ids), np.asarray(j._slot_ids))
    np.testing.assert_array_equal(np.asarray(t._coarse), np.asarray(j._coarse))
    assert t._list_free == j._list_free and t._list_buckets == j._list_buckets
    assert t._id_loc == j._id_loc
    assert (t._n_dead, t._capB_local, t._next_id) == (j._n_dead, j._capB_local, j._next_id)


@pytest.mark.parametrize("shape,q_axis", [(None, None), ((2, 4), "replica")])
def test_ivf_mutation_fuzz_matches_jax(rng, monkeypatch, shape, q_axis):
    """Growth past the first capacity, deletes into the free stacks (which
    must survive growth), filtered and full-probe searches, compaction."""
    x0 = rng.standard_normal((600, D)).astype(np.float32)
    j, t = _ivf_pair(x0, monkeypatch, shape, q_axis, nlist=8, nprobe=3)
    _same_ivf_layout(j, t)
    q = rng.standard_normal((6, D)).astype(np.float32)
    cap0 = t._capB_local
    for step in range(5):
        x = rng.standard_normal((160, D)).astype(np.float32)
        np.testing.assert_array_equal(t.add(x), j.add(x))
        _same_ivf_layout(j, t)
        dead = rng.choice(t._next_id, 40, replace=False)
        assert t.delete(dead) == j.delete(dead)
        _same_ivf_layout(j, t)
        for npb in (0, t._capB_local):
            _same_search(j, t, q, 8, nprobe=npb)
        live = np.asarray(sorted(t._id_loc))
        allow = rng.choice(live, 50, replace=False)
        _, ids = _same_search(j, t, q, 8, filter_ids=allow)
        assert np.isin(ids[ids >= 0], allow).all()
    assert t._capB_local > cap0
    t.compact()
    j.compact()
    _same_ivf_layout(j, t)
    _same_search(j, t, q, 8)


def test_ivf_allprobe_exact_and_partial_recall(rng):
    """A port-built index (its own k-means): probing every bucket equals
    exact search over the live rows, and a partial probe keeps recall."""
    x = rng.standard_normal((1200, D)).astype(np.float32)
    t = ts.ShardedMutableIVF(x, make_mesh(devices=["cpu"] * 4), nlist=8, nprobe=3)
    extra = rng.standard_normal((500, D)).astype(np.float32)
    new = t.add(extra)
    rows = np.concatenate([x, extra])
    t.delete(np.arange(0, 1700, 5))
    live = np.asarray(sorted(t._id_loc))
    q = rng.standard_normal((20, D)).astype(np.float32)
    want = _oracle_ids(q, rows[live], live, 10)
    _, ids = t.search(q, 10, nprobe=t._capB_local)
    np.testing.assert_array_equal(ids, want)
    _, ids = t.search(q, 10, nprobe=4)
    hits = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, want)])
    assert hits > 0.6
    assert new[0] == 1200 and t.route(20) in ("fused_k1", "masked_stream", "probe_scan")
    # self-queries: each live row at distance 0, never a deleted id
    d, ids = t.search(rows[live[:30]], 1, nprobe=t._capB_local)
    np.testing.assert_array_equal(ids[:, 0], live[:30])
    assert (d[:, 0] <= 1e-4).all()


def test_ivf_snapshot_servable(rng):
    x = rng.standard_normal((800, D)).astype(np.float32)
    t = ts.ShardedMutableIVF(x, make_mesh(devices=["cpu"] * 4), nlist=8, nprobe=3)
    t.delete(np.arange(0, 800, 7))
    q = rng.standard_normal((6, D)).astype(np.float32)
    want = t.search(q, 10, nprobe=t._capB_local)
    art = t.to_artifact()
    assert art.metadata["source"] == "ShardedMutableIVF" and art.metadata["n_vectors"] == t.n_active
    s = ANNSearcher(device="cpu")
    s.attach(art)
    got = s.batch_search(q, 10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=1e-5)
