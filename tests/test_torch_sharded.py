"""The port's row-sharded IVF and graph families (parallel/sharded_ivf.py,
parallel/sharded_graph.py, models/sharded.py, the factory's sharded kinds)
against the JAX package's, on the CPU.

Search parity is held on artifacts the JAX package built and saved, loaded
through ``models/persist.py`` and placed over the port's mesh of 8 CPU
devices: the same ``nprobe`` / ``efSearch`` must give the same ids per query
(as sorted sets; the corpus has no exact ties) and distances within
2e-6 of the largest squared norm (the norm expansion's f32 rounding, summed
in another order), under both nprobe semantics. Builds draw
k-means inits from each package's own RNG, so port builds are held to the
JAX builds' recall@10 within 0.02, and port-saved directories must load and
search alike in the JAX package. Sentinel layouts of empty shards are
deterministic and held bit for bit.
"""

import numpy as np
import pytest
import torch

from vectordb_retrieval_tpu import parallel as jpar
from vectordb_retrieval_tpu.bench.metrics import recall_at_k
from vectordb_retrieval_tpu.models.composite import CompositeAlgorithm as JaxComposite
from vectordb_retrieval_tpu_torch import parallel as tpar
from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.parallel.mesh import place_stacks

torch.set_num_threads(2)
CPU8 = ["cpu"] * 8
K = 10

CASES = {
    "ivf_flat": ({"type": "ShardedIVFIndexer", "index_key": "IVF6,Flat"}, {"nprobe": 2}),
    "ivf_sq8": ({"type": "ShardedIVFIndexer", "index_key": "IVF6,SQ8"}, {"nprobe": 2}),
    "ivf_pq": ({"type": "ShardedIVFIndexer", "index_key": "IVF6,PQ12", "train_iters": 6},
               {"nprobe": 2}),
    "ivf_pq_rot": ({"type": "ShardedIVFIndexer", "index_key": "IVF6,PQ12", "pq_rotations": 4,
                    "train_iters": 4}, {"nprobe": 2}),
    "graph_node": ({"type": "ShardedGraphIndexer", "M": 8}, {"efSearch": 48}),
    "graph_block": ({"type": "ShardedGraphIndexer", "M": 8, "mode": "block", "block_size": 32},
                    {"efSearch": 48}),
}


def _skewed(seed=42, d=24, nq=128):
    """The JAX nprobe-semantics oracle's corpus at half its rows: one
    cluster owns 60 % of them, the shape where the two nprobe semantics
    diverge."""
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((6, d)) * 8).astype(np.float32)
    sizes = [1200, 160, 160, 160, 160, 160]
    x = np.concatenate([centers[j] + rng.standard_normal((s, d)) for j, s in enumerate(sizes)])
    x = x[rng.permutation(len(x))].astype(np.float32)
    q = (centers[rng.integers(0, 6, nq)] + rng.standard_normal((nq, d))).astype(np.float32)
    gt = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1)[:, :K]
    return x, q, gt


@pytest.fixture(scope="module")
def corpus():
    return _skewed()


def _cfg(case, **searcher):
    ix, sx = CASES[case]
    return dict(dimension=24, indexer=dict(ix), searcher={"type": "ANNSearcher", **sx, **searcher},
                metric="l2")


@pytest.fixture(scope="module")
def jax_built(corpus, tmp_path_factory):
    """Each case built by the JAX package, saved, with its recall@10."""
    x, q, gt = corpus
    root = tmp_path_factory.mktemp("jax_sharded")
    out = {}
    for case in CASES:
        algo = JaxComposite(**_cfg(case))
        algo.build_index(x)
        algo.save_index(str(root / case), {})
        out[case] = (str(root / case), recall_at_k(gt, algo.batch_search(q, K)[1], K))
    return out


def _same_sets(got, want, scale):
    """Equal ids per query (as sets), distances within 2e-6 of ``scale``,
    the largest squared norm of rows and queries."""
    (gd, gi), (wd, wi) = got, want
    wi = np.asarray(wi)
    assert gi.shape == wi.shape
    np.testing.assert_array_equal(np.sort(gi, 1), np.sort(wi, 1))
    np.testing.assert_allclose(np.sort(gd, 1), np.sort(np.asarray(wd), 1), rtol=0,
                               atol=2e-6 * scale)


def _scale(*arrays):
    return float(max((a.astype(np.float64) ** 2).sum(1).max() for a in arrays))


@pytest.mark.parametrize("case,semantics", [
    (c, s) for c in CASES for s in (("lists", "buckets") if c.startswith("ivf") else ("lists",))
])
def test_jax_built_artifact_searched_alike(corpus, jax_built, case, semantics):
    x, q, _ = corpus
    path = jax_built[case][0]
    jax_algo = JaxComposite(**_cfg(case, nprobe_semantics=semantics))
    jax_algo.load_index(path, {})
    algo = CompositeAlgorithm(device=CPU8, **_cfg(case, nprobe_semantics=semantics))
    algo.load_index(path, {})
    assert algo.artifact.mesh.shape == {"db": 8}
    _same_sets(algo.batch_search(q, K), jax_algo.batch_search(q, K), _scale(x, q))


@pytest.mark.parametrize("case", [c for c in CASES if c != "ivf_pq_rot"])
def test_port_build_recall_and_save_load_in_jax(corpus, jax_built, case, tmp_path):
    x, q, gt = corpus
    algo = CompositeAlgorithm(device=CPU8, **_cfg(case))
    algo.build_index(x)
    got = algo.batch_search(q, K)
    rec = recall_at_k(gt, got[1], K)
    assert abs(rec - jax_built[case][1]) <= 0.02, (rec, jax_built[case][1])
    meta = algo.artifact.metadata
    assert meta["n_shards"] == 8 and algo.artifact.kind.endswith("_sharded")
    algo.save_index(str(tmp_path / "p"), {})
    jax_algo = JaxComposite(**_cfg(case))
    jax_algo.load_index(str(tmp_path / "p"), {})
    _same_sets(got, jax_algo.batch_search(q, K), _scale(x, q))


def test_small_corpus_many_shards_sentinels_bit_for_bit(rng):
    """Empty trailing shards, ragged PQ codebook sizes and k > rows per
    shard (the JAX package's regression cases); an empty shard's sentinel
    stacks equal the JAX package's."""
    q = rng.standard_normal((4, 16)).astype(np.float32)
    jmesh, mesh = jpar.make_mesh(8), tpar.make_mesh(devices=CPU8)
    x = rng.standard_normal((41, 16)).astype(np.float32)  # shard 7 is empty
    jd, jm = jpar.build_sharded_ivf_flat(x, jmesh, nlist=4, seed=1)
    td, tm = tpar.build_sharded_ivf_flat(x, mesh, nlist=4, seed=1)
    assert (tm["n_buckets"], tm["max_list_len"]) == (jm["n_buckets"], jm["max_list_len"])
    for key in jd:
        np.testing.assert_array_equal(np.asarray(td[key])[7], np.asarray(jd[key])[7])
    _, i = tpar.sharded_ivf_flat_search(torch.as_tensor(q), td, 3, tm["n_buckets"], mesh)
    assert ((i >= 0) & (i < 41)).all()

    x9 = rng.standard_normal((900, 16)).astype(np.float32)  # < 256 rows a shard
    td, tm = tpar.build_sharded_ivf_coded(x9, mesh, nlist=4, coding="pq", m=4, seed=1)
    assert td["codebooks"].shape == (8, 4, 109, 4)  # ksub: the last shard's 109 rows
    _, i = tpar.sharded_ivf_coded_search(torch.as_tensor(q), td, 3, tm["n_buckets"], mesh,
                                         coding="pq")
    assert ((i >= 0) & (i < 900)).all()

    x49 = rng.standard_normal((49, 16)).astype(np.float32)  # 7 a shard, shard 7 empty
    jg, _ = jpar.build_sharded_graph(x49, jmesh, M=4, seed=1)
    tg, _ = tpar.build_sharded_graph(x49, mesh, M=4, seed=1)
    for key in jg:
        np.testing.assert_array_equal(np.asarray(tg[key])[7], np.asarray(jg[key])[7])
    _, gi = tpar.sharded_graph_search(torch.as_tensor(q), tg, 49, 30, mesh, ef=16)
    assert gi.shape[1] == 30 and ((gi >= -1) & (gi < 49)).all()
    jb, _ = jpar.build_sharded_block_graph(x49, jmesh, M=4, block_size=4, seed=1)
    tb, _ = tpar.build_sharded_block_graph(x49, mesh, M=4, block_size=4, seed=1)
    for key in jb:
        assert tb[key].shape == jb[key].shape, key
        np.testing.assert_array_equal(np.asarray(tb[key])[7], np.asarray(jb[key])[7])


def test_q_axis_matches_jax(rng):
    """A (q 2, db 4) mesh: each query block merges in its own ring; the
    port searches the JAX package's stacks alike."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = rng.standard_normal((1024, 16)).astype(np.float32)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    jmesh = jpar.make_mesh(8, axis_names=("q", "db"), shape=(2, 4))
    mesh = tpar.make_mesh(8, ("q", "db"), (2, 4), devices=CPU8)
    qd = jax.device_put(jnp.asarray(q), NamedSharding(jmesh, P("q", None)))
    jd, jm = jpar.build_sharded_ivf_coded(x, jmesh, nlist=4, coding="sq8", seed=1)
    want = jpar.sharded_ivf_coded_search(qd, jd, 5, 6, jmesh, coding="sq8", q_axis="q")
    td = place_stacks({k: np.asarray(v) for k, v in jd.items()}, mesh)
    got = tpar.sharded_ivf_coded_search(torch.as_tensor(q), td, 5, 6, mesh, coding="sq8",
                                        q_axis="q")
    _same_sets(tuple(t.numpy() for t in got), want, _scale(x, q))
    jg, _ = jpar.build_sharded_graph(x, jmesh, M=4, seed=1)
    want = jpar.sharded_graph_search(qd, jg, 1024, 5, jmesh, ef=64, q_axis="q")
    tg = place_stacks({k: np.asarray(v) for k, v in jg.items()}, mesh)
    got = tpar.sharded_graph_search(torch.as_tensor(q), tg, 1024, 5, mesh, ef=64, q_axis="q")
    _same_sets(tuple(t.numpy() for t in got), want, _scale(x, q))
