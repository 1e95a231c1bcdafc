"""The port stands alone: it imports neither JAX, nor the JAX package, nor
``ml_dtypes`` (bf16 persists through int16 views), and its entry points
never carry on quietly on the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import vectordb_retrieval_tpu_torch as port

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(port.__file__)
FORBIDDEN = ("jax", "vectordb_retrieval_tpu", "ml_dtypes")


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages([PKG_DIR], prefix=port.__name__ + "."):
        names.append(info.name)
    return names


def test_port_modules_do_not_load_jax_or_the_jax_package():
    mods = _port_modules()
    assert len(mods) >= 70, mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN!r})]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|vectordb_retrieval_tpu|ml_dtypes)(?:[\s.,]|$)", re.M
)


def test_port_sources_name_no_forbidden_import():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as f:
            src = f.read()
        hits += [(path, m.group(0).strip()) for m in _IMPORT.finditer(src)]
    assert not hits, hits
    assert _IMPORT.search("import jax.numpy as jnp")
    assert _IMPORT.search("from vectordb_retrieval_tpu.ops import x")
    assert not _IMPORT.search("from vectordb_retrieval_tpu_torch.ops import x")
    assert _IMPORT.search("    import ml_dtypes")


def test_port_sources_leave_sys_path_alone():
    """The port's entry points are modules run with ``python -m``; none
    edits ``sys.path``."""
    hits = []
    for root, _, names in os.walk(PKG_DIR):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(root, n)) as f:
                    if "sys.path" in f.read():
                        hits.append(os.path.join(root, n))
    assert not hits, hits


def test_bf16_artifacts_persist_without_ml_dtypes(tmp_path):
    """A bf16 artifact saves and loads with ``ml_dtypes`` made unimportable."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from vectordb_retrieval_tpu_torch.models import persist\n"
        "from vectordb_retrieval_tpu_torch.models.base import IndexArtifact\n"
        "v = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16)\n"
        f"path = {str(tmp_path / 'a')!r}\n"
        "persist.save_artifact(IndexArtifact('ivf_flat', {'list_vecs': v}, {}), path)\n"
        "back = persist.load_artifact(path, device='cpu').data['list_vecs']\n"
        "assert back.dtype == torch.bfloat16 and torch.equal(back, v)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _prep_config(tmp_path):
    cfg = tmp_path / "prep.yaml"
    cfg.write_text(
        f"subsample: {{corpus_tsv: {tmp_path / 'c.tsv'}, queries_tsv: {tmp_path / 'q.tsv'}}}\n"
        "embed: {synthetic: true}\n")
    return ["--config", str(cfg)]


# this slice's tools that take --device, each with arguments that would
# build a small corpus
CALIBRATION_TOOLS = {
    "calibrate_glove_surrogate": lambda tmp_path: [],
    "calibrate_msmarco_surrogate": lambda tmp_path: ["--n", "300", "--quick"],
    "calibrate_manifold": lambda tmp_path: ["--n", "300", "--data-dir", str(tmp_path)],
    "exp_manifold_rotations": lambda tmp_path: ["--n", "300", "--data-dir", str(tmp_path)],
    "exp_binary_lsh_tune": lambda tmp_path: ["--data-dir", str(tmp_path)],
    "prepare_msmarco": _prep_config,
}
# the research probes, each with arguments that would build a small corpus
PROBES = {
    "exp_lsh_frontier": lambda tmp_path: ["--limit", "300", "--data-dir", str(tmp_path)],
    "exp_covertree_hard": lambda tmp_path: ["--n", "300", "--data-dir", str(tmp_path)],
    "exp_glove_ceiling": lambda tmp_path: ["--data-dir", str(tmp_path)],
    "exp_glove_geometry": lambda tmp_path: ["--data-dir", str(tmp_path)],
    "exp_block_geometry": lambda tmp_path: ["--data-dir", str(tmp_path)],
    "exp_manifold_structure": lambda tmp_path: ["--n", "300"],
}
# every module the calibration and probe slices added to scripts/ (the
# SIFT1M surrogate writer makes host files only and takes no device)
SLICE_SCRIPTS = (*CALIBRATION_TOOLS, "make_sift1m_surrogate", "calibration", *PROBES, "probes")


def _entry_point(name, tmp_path):
    import numpy as np

    q = np.zeros((2, 4), np.float32)
    x = np.zeros((8, 4), np.float32)
    if name == "exact_search":
        from vectordb_retrieval_tpu_torch.ops.distances import exact_search

        exact_search(q, x, 1)
    elif name == "compute_ground_truth":
        from vectordb_retrieval_tpu_torch.data.datasets import compute_ground_truth

        compute_ground_truth(x, q, 1)
    elif name == "BruteForceIndexer":
        from vectordb_retrieval_tpu_torch.models.flat import BruteForceIndexer

        BruteForceIndexer()
    elif name == "LinearSearcher":
        from vectordb_retrieval_tpu_torch.models.flat import LinearSearcher

        LinearSearcher()
    elif name == "ExactSearch":
        from vectordb_retrieval_tpu_torch.models import get_algorithm_instance

        get_algorithm_instance("exact", 4)
    elif name == "artifact_from_numpy":
        from vectordb_retrieval_tpu_torch.models.base import artifact_from_numpy

        artifact_from_numpy("flat", {"vectors": x}, {})
    elif name == "ExperimentRunner":
        from vectordb_retrieval_tpu_torch.bench.config import ExperimentConfig
        from vectordb_retrieval_tpu_torch.bench.experiment import ExperimentRunner

        ExperimentRunner(ExperimentConfig(), output_dir=str(tmp_path))
    elif name == "FactoryIndexer":
        from vectordb_retrieval_tpu_torch.models.factory import FactoryIndexer

        FactoryIndexer(index_key="IVF4,Flat")
    elif name == "ANNSearcher":
        from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher

        ANNSearcher()
    elif name == "ApproximateSearch":
        from vectordb_retrieval_tpu_torch.models import get_algorithm_instance

        get_algorithm_instance("approx", 4)
    elif name == "load_artifact":
        from vectordb_retrieval_tpu_torch.models.persist import load_artifact

        load_artifact(str(tmp_path))
    elif name == "GraphIndexer":
        from vectordb_retrieval_tpu_torch.models.graph import GraphIndexer

        GraphIndexer()
    elif name == "HNSW":
        from vectordb_retrieval_tpu_torch.models import get_algorithm_instance

        get_algorithm_instance("hnsw", 4)
    elif name == "CoverTree":
        from vectordb_retrieval_tpu_torch.models import get_algorithm_instance

        get_algorithm_instance("covertree", 4)
    elif name == "msmarco_surrogate":
        from vectordb_retrieval_tpu_torch.data.datasets import Dataset

        Dataset("msmarco_surrogate", str(tmp_path),
                {"train_limit": 32, "test_size": 2, "ground_truth_k": 1}).load()
    elif name == "manifold":
        from vectordb_retrieval_tpu_torch.data.datasets import Dataset

        Dataset("manifold", str(tmp_path),
                {"train_limit": 32, "test_size": 2, "ground_truth_k": 1,
                 "n_patches": 4, "dim": 8, "intrinsic_dim": 2}).load()
    elif name == "FactoryIndexer_pq":
        from vectordb_retrieval_tpu_torch.models.factory import FactoryIndexer

        FactoryIndexer(index_key="OPQ4,IVF4,PQ4", pq_rotations="auto")
    elif name == "LSHIndexer":
        from vectordb_retrieval_tpu_torch.models.lsh import LSHIndexer

        LSHIndexer()
    elif name == "LSHSearcher":
        from vectordb_retrieval_tpu_torch.models.lsh import LSHSearcher

        LSHSearcher()
    elif name == "BinaryLSHIndexer":
        from vectordb_retrieval_tpu_torch.models.lsh import BinaryLSHIndexer

        BinaryLSHIndexer()
    elif name == "LSH":
        from vectordb_retrieval_tpu_torch.models import get_algorithm_instance

        get_algorithm_instance("lsh", 4)
    elif name == "glove50_surrogate":
        from vectordb_retrieval_tpu_torch.data.datasets import Dataset

        Dataset("glove50_surrogate", str(tmp_path),
                {"train_limit": 32, "test_size": 2, "ground_truth_k": 1}).load()
    elif name == "MutableFlatIndex":
        from vectordb_retrieval_tpu_torch.serving import MutableFlatIndex

        MutableFlatIndex(4)
    elif name == "MutableIVFIndex":
        from vectordb_retrieval_tpu_torch.serving import MutableIVFIndex

        MutableIVFIndex(x, nlist=2)
    elif name == "corpus_to_device":
        from vectordb_retrieval_tpu_torch.data.storage import corpus_to_device

        corpus_to_device(x)
    elif name == "streamed_exact_search":
        from vectordb_retrieval_tpu_torch.data.storage import streamed_exact_search

        streamed_exact_search(q, x, 1)
    elif name == "validate_bigcorpus":
        from vectordb_retrieval_tpu_torch.bench import validate_bigcorpus

        validate_bigcorpus.main(["--rows", "64", "--data-dir", str(tmp_path / "bc")])
    elif name in CALIBRATION_TOOLS or name in PROBES:
        import importlib

        args = {**CALIBRATION_TOOLS, **PROBES}[name](tmp_path)
        importlib.import_module(f"vectordb_retrieval_tpu_torch.scripts.{name}").main(args)
    elif name in ("main", "flagship", "scripts.run_experiment",
                  "scripts.run_full_benchmark", "scripts.parameter_sweep",
                  "scripts.compare_algorithms", "scripts.matched_conditions",
                  "data.dataprep.embed_msmarco"):
        import importlib

        cfg = tmp_path / "c.yaml"
        cfg.write_text("datasets: [random]\nalgorithms: {}\nsweep: {}\nalgorithm: {}\n")
        args = {"main": ["--config", str(cfg)], "flagship": [],
                "scripts.matched_conditions": ["--out", str(tmp_path / "m.json")],
                "data.dataprep.embed_msmarco": ["--input-dir", str(tmp_path),
                                                "--output-dir", str(tmp_path / "e"),
                                                "--synthetic"]}.get(
            name, ["--config", str(cfg), "--output-dir", str(tmp_path / "o")])
        importlib.import_module(f"vectordb_retrieval_tpu_torch.{name}").main(args)
    elif name == "BenchmarkRunner":
        from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner

        cfg = tmp_path / "c.yaml"
        cfg.write_text("datasets: [random]\n")
        BenchmarkRunner(str(cfg), output_dir=str(tmp_path))


@pytest.mark.parametrize(
    "name",
    ["exact_search", "compute_ground_truth", "BruteForceIndexer", "LinearSearcher",
     "ExactSearch", "artifact_from_numpy", "ExperimentRunner", "BenchmarkRunner",
     "FactoryIndexer", "ANNSearcher", "ApproximateSearch", "load_artifact",
     "GraphIndexer", "HNSW", "CoverTree", "msmarco_surrogate", "manifold",
     "FactoryIndexer_pq", "LSHIndexer", "LSHSearcher", "BinaryLSHIndexer", "LSH",
     "glove50_surrogate", "MutableFlatIndex", "MutableIVFIndex", "corpus_to_device",
     "streamed_exact_search", "validate_bigcorpus", "main", "flagship",
     "scripts.run_experiment", "scripts.run_full_benchmark", "scripts.parameter_sweep",
     "scripts.compare_algorithms", "scripts.matched_conditions",
     "data.dataprep.embed_msmarco", *CALIBRATION_TOOLS, *PROBES],
)
def test_entry_points_without_device_raise_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_point(name, tmp_path)


def test_slice_scripts_parse_nothing_and_write_nothing_at_import(tmp_path):
    """Each new ``scripts`` module imported in a fresh process, from an
    empty directory, with an ``argv`` no parser accepts: no parser ran and
    no file was written."""
    mods = [f"vectordb_retrieval_tpu_torch.scripts.{m}" for m in SLICE_SCRIPTS]
    code = (
        "import argparse, importlib, sys\n"
        "sys.argv = ['x', '--no-such-flag']\n"
        "parsed = []\n"
        "orig = argparse.ArgumentParser.parse_args\n"
        "def spy(self, *a, **k):\n"
        "    parsed.append(self.prog)\n"
        "    return orig(self, *a, **k)\n"
        "argparse.ArgumentParser.parse_args = spy\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(parsed)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    assert os.listdir(tmp_path) == []
    assert {m.rsplit(".", 1)[1] for m in mods} <= {
        m.rsplit(".", 1)[1] for m in _port_modules() if ".scripts." in m}
