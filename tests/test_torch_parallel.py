"""The port's mesh, sharded exact search and multi-process path
(vectordb_retrieval_tpu_torch/parallel/{mesh,sharded}.py, the flat_sharded
model layer) against the JAX package's, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices, the port on
``devices=["cpu"] * P`` (a mesh may repeat a device). Distances must agree
to f32 rounding (rtol 1e-5, atol 1e-5: the same products summed in another
order) and ids exactly, on random float rows (no ties). Integer rows tie:
there the port's merge takes equal distances in ascending global id, the
same for every P, which the tie test holds against a float64 lexsort.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectordb_retrieval_tpu.models.composite import CompositeAlgorithm as JaxComposite
from vectordb_retrieval_tpu.parallel import make_mesh as jax_mesh
from vectordb_retrieval_tpu.parallel import shard_database as jax_shard
from vectordb_retrieval_tpu.parallel import sharded_exact_search as jax_search
from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.ops import distances as tdops
from vectordb_retrieval_tpu_torch.parallel import mesh as tmesh
from vectordb_retrieval_tpu_torch.parallel import shard_database, sharded_exact_search
from vectordb_retrieval_tpu_torch.parallel.sharded_ivf import gather_merge

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = ATOL = 1e-5


def _cpu(p):
    return ["cpu"] * p


def _unit(a):
    return a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)


def _port(q, x, k, metric, mesh, **kw):
    xs, n = shard_database(x, mesh)
    d, i = sharded_exact_search(torch.as_tensor(q), xs, n, k, mesh, metric=metric, **kw)
    return d.numpy(), i.numpy()


def _jax(q, x, k, metric, mesh, q_axis=None):
    xs, n = jax_shard(x, mesh)
    if q_axis is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        import jax

        qd = jax.device_put(jnp.asarray(q), NamedSharding(mesh, P(q_axis, None)))
    else:
        qd = jnp.asarray(q)
    d, i = jax_search(qd, xs, n, k, mesh, metric=metric, q_axis=q_axis)
    return np.asarray(d), np.asarray(i)


def _same(port, want):
    np.testing.assert_array_equal(port[1], want[1])
    np.testing.assert_allclose(port[0], want[0], rtol=RTOL, atol=ATOL)


def test_make_mesh_shapes_and_errors():
    m = tmesh.make_mesh(8, ("q", "db"), (2, 4), devices=_cpu(8))
    assert m.shape == {"q": 2, "db": 4} and m.devices.shape == (2, 4)
    assert m.size("db") == 4 and m.size(("q", "db")) == 8
    assert [len(r) for r in m.rings("db", "q")] == [4, 4]
    assert tmesh.make_mesh(devices=_cpu(3)).shape == {"db": 3}
    with pytest.raises(ValueError, match="requested 9 devices, only 8 available"):
        tmesh.make_mesh(9, devices=_cpu(8))
    with pytest.raises(ValueError, match="shape required for multi-axis meshes"):
        tmesh.make_mesh(8, ("q", "db"), devices=_cpu(8))
    with pytest.raises(ValueError, match=r"shape \(2, 3\) != 8 devices"):
        tmesh.make_mesh(8, ("q", "db"), (2, 3), devices=_cpu(8))
    # the JAX package raises the same errors
    with pytest.raises(ValueError, match="requested 9 devices, only 8 available"):
        jax_mesh(9)
    assert tmesh.host_local_rows(10) == (0, 10)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_sharded_exact_matches_jax(rng, metric):
    x = rng.standard_normal((1000, 32)).astype(np.float32)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    if metric == "cosine":  # both packages take unit rows for cosine
        x, q = _unit(x), _unit(q)
    got = _port(q, x, 10, metric, tmesh.make_mesh(devices=_cpu(8)))
    _same(got, _jax(q, x, 10, metric, jax_mesh(8)))


def test_ragged_rows_match_jax(rng):
    x = rng.standard_normal((1003, 16)).astype(np.float32)  # not divisible by 8
    q = rng.standard_normal((4, 16)).astype(np.float32)
    mesh = tmesh.make_mesh(devices=_cpu(8))
    xs, n = shard_database(x, mesh)
    assert xs.shape == (1008, 16) and n == 1003
    got = _port(q, x, 1003, "l2", mesh)
    for row in got[1]:  # every real row found exactly once at k == n
        assert sorted(row.tolist()) == list(range(1003))
    _same(got, _jax(q, x, 1003, "l2", jax_mesh(8)))


def test_q2_db4_matches_jax_and_shares_tensors(rng):
    x = rng.standard_normal((512, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    mesh = tmesh.make_mesh(8, ("q", "db"), (2, 4), devices=_cpu(8))
    got = _port(q, x, 5, "l2", mesh, q_axis="q")
    _same(got, _jax(q, x, 5, "l2", jax_mesh(8, ("q", "db"), (2, 4)), q_axis="q"))
    # the two q rings name the same device: one tensor per shard, and the
    # results of the db4 mesh alone
    xs, _ = shard_database(x, mesh)
    assert len({id(t) for t in xs.tensors.values()}) == 4
    assert xs.device_nbytes() == x.nbytes
    _same(got, _port(q, x, 5, "l2", tmesh.make_mesh(devices=_cpu(4))))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_p1_equals_unsharded_search(rng, metric):
    x = rng.standard_normal((700, 24)).astype(np.float32)
    q = rng.standard_normal((12, 24)).astype(np.float32)
    got = _port(q, x, 10, metric, tmesh.make_mesh(devices=_cpu(1)))
    want = tdops.exact_search(q, x, 10, metric=metric, device="cpu")
    _same(got, (want[0].numpy(), want[1].numpy()))


def test_merge_is_tie_free_in_global_id():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (600, 8)).astype(np.float32)  # many exact ties
    q = rng.integers(0, 4, (10, 8)).astype(np.float32)
    full = ((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    rows = np.arange(x.shape[0])
    want = np.stack([np.lexsort((rows, f))[:20] for f in full])
    for p in (1, 3, 8):
        d, i = _port(q, x, 20, "l2", tmesh.make_mesh(devices=_cpu(p)))
        np.testing.assert_array_equal(i, want)
        np.testing.assert_array_equal(d, np.take_along_axis(full, want, 1).astype(np.float32))


def test_process_merge_on_a_world_of_one(rng):
    """The process axis through gloo as a world of one: the same merge."""
    import torch.distributed as dist

    x = rng.standard_normal((300, 8)).astype(np.float32)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    want = _port(q, x, 7, "l2", tmesh.make_mesh(devices=_cpu(4)))
    assert not tmesh.init_distributed(device="cpu")
    try:
        assert not tmesh.init_distributed(device="cpu")  # idempotent
        mesh = tmesh.make_multihost_mesh(devices=_cpu(4))
        assert mesh.shape == {"dcn": 1, "db": 4} and mesh.group is not None
        xs, n = shard_database(x, mesh, axis=("dcn", "db"))
        d, i = sharded_exact_search(torch.as_tensor(q), xs, n, 7, mesh, db_axis=("dcn", "db"))
        _same((d.numpy(), i.numpy()), want)
        # a merge padded to a wider k keeps -1 / +inf past the real entries
        parts = [(torch.as_tensor(want[0][:, :3]), torch.as_tensor(want[1][:, :3]))]
        md, mi = gather_merge(parts, 5, group=mesh.group)
        assert (mi[:, 3:] == -1).all() and torch.isinf(md[:, 3:]).all()
        np.testing.assert_array_equal(mi[:, :3].numpy(), want[1][:, :3])
    finally:
        dist.destroy_process_group()


def test_two_process_dcn_mesh_exact_search():
    """The counterpart of tests/test_multihost.py: two processes, four CPU
    devices each, gloo."""
    proc = subprocess.run(
        [sys.executable, "-m", "vectordb_retrieval_tpu_torch.parallel.dryrun_multihost",
         "--procs", "2", "--local-devices", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=180, cwd=REPO,
        env={k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-2000:]
    assert "dryrun_multihost ok" in out, out[-2000:]
    assert out.count("ok=True") == 2 and "backend=gloo" in out, out[-2000:]


def _flat_algos(metric, devices):
    cfg = dict(dimension=16, indexer={"type": "ShardedFlatIndexer"},
               searcher={"type": "LinearSearcher"}, metric=metric)
    return JaxComposite(**cfg), CompositeAlgorithm(device=devices, **cfg)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_flat_sharded_model_layer_matches_jax(rng, metric):
    x = rng.standard_normal((640, 16)).astype(np.float32)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    jax_algo, algo = _flat_algos(metric, _cpu(8))
    jax_algo.build_index(x)
    algo.build_index(x)
    assert algo.artifact.kind == "flat_sharded" and algo.artifact.metadata["n_devices"] == 8
    _same(algo.batch_search(q, 5), jax_algo.batch_search(q, 5))


def test_flat_sharded_persistence_both_ways(tmp_path, rng):
    """Saved by either package, loaded and resharded by the other (the
    port over its own 4 devices): the same ids."""
    x = rng.standard_normal((512, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    jax_algo, algo = _flat_algos("l2", _cpu(8))
    jax_algo.build_index(x)
    algo.build_index(x)
    want = jax_algo.batch_search(q, 5)
    jax_algo.save_index(str(tmp_path / "j"), {})
    algo.save_index(str(tmp_path / "t"), {})
    loaded = _flat_algos("l2", _cpu(8))[1]
    loaded.load_index(str(tmp_path / "j"), {})
    assert loaded.artifact.mesh.shape == {"db": 8}
    _same(loaded.batch_search(q, 5), want)
    jax_loaded = _flat_algos("l2", _cpu(8))[0]
    jax_loaded.load_index(str(tmp_path / "t"), {})
    _same(algo.batch_search(q, 5), jax_loaded.batch_search(q, 5))


def test_flat_sharded_through_experiment_runner(tmp_path):
    from vectordb_retrieval_tpu_torch.bench.config import ExperimentConfig
    from vectordb_retrieval_tpu_torch.bench.experiment import ExperimentRunner

    cfg = ExperimentConfig(
        dataset="random", data_dir=str(tmp_path / "d"),
        dataset_options={"dimensions": 16, "train_size": 256, "test_size": 16,
                         "ground_truth_k": 10, "seed": 2, "use_cache": False},
        n_queries=8, topk=5, repeat=2,
        algorithms={"sharded_exact": {"indexer": {"type": "ShardedFlatIndexer"},
                                      "searcher": {"type": "LinearSearcher"}, "metric": "l2"}},
    )
    runner = ExperimentRunner(cfg, output_dir=str(tmp_path / "o"), device=_cpu(8))
    m = runner.run()["sharded_exact"]
    assert "error" not in m, m
    assert m["recall"] == 1.0 and m["qps"] > 0
    assert runner.algorithms["sharded_exact"].artifact.mesh.shape == {"db": 8}


def test_benchmark_sharded_config_through_both_runners(tmp_path):
    """configs/benchmark_sharded.yaml unchanged: the port's runner on 8 CPU
    devices, every row within 0.02 recall@10 of the JAX runner's."""
    from vectordb_retrieval_tpu.bench.runner import BenchmarkRunner as JaxRunner
    from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner

    cfg = os.path.join(REPO, "configs", "benchmark_sharded.yaml")
    got = BenchmarkRunner(cfg, output_dir=str(tmp_path / "t"), device=_cpu(8)).run()["random"]
    want = JaxRunner(cfg, output_dir=str(tmp_path / "j")).run()["random"]
    rows = ("exact_sharded", "ivf_flat_sharded", "ivf_sq8_sharded", "ivf_pq_sharded",
            "hnsw_sharded")
    for row in rows:
        assert "error" not in got[row], got[row]
        assert abs(got[row]["recall@10"] - want[row]["recall@10"]) <= 0.02, row
    assert got["exact_sharded"]["recall@10"] == 1.0
