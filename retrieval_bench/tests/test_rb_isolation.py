"""Nothing the benchmark runs on the card imports JAX or the JAX package,
and the reference and the generators import nothing of the program.
Module names are compared by their whole top-level name: the port's,
``vectordb_retrieval_tpu_torch``, begins with the JAX package's."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from retrieval_bench import harness

JAX = {"jax", "jaxlib", "flax", "vectordb_retrieval_tpu"}
PROGRAM = "vectordb_retrieval_tpu_torch"
BENCH = harness.BENCH_DIR


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(*parts):
    return sorted(glob.glob(os.path.join(BENCH, *parts)))


INDEPENDENT = sources("reference.py") + sources("trace.py") + sources("generators", "*.py") \
    + sources("guarantees", "*.py") + sources("layer_metrics", "*.py")
RUNNER = sources("run.py") + sources("harness.py") + sources("control.py")


@pytest.mark.parametrize("path", INDEPENDENT, ids=os.path.basename)
def test_reference_and_generators_import_neither_jax_nor_the_program(path):
    assert not top_level_imports(path) & (JAX | {PROGRAM})


@pytest.mark.parametrize("path", RUNNER, ids=os.path.basename)
def test_the_runner_imports_no_jax(path):
    assert not top_level_imports(path) & JAX


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "vectordb_retrieval_tpu_torch_fake", sys)
    assert "vectordb_retrieval_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vectordb_retrieval_tpu.ops", sys)
    assert "vectordb_retrieval_tpu" in harness.forbidden_modules()


def test_a_run_of_the_port_loads_no_jax():
    """A small run on the host, in a fresh process, leaves no JAX module
    loaded (what the result line's check reads)."""
    code = (
        "from retrieval_bench import harness\n"
        "from retrieval_bench.tests.conftest import small_cell\n"
        "harness.run('sift1m.ivf_flat', 3, 0.2, True, device='cpu', cell=small_cell('sift1m.ivf_flat'))\n"
        "print(harness.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "retrieval_bench.run", "--workload", "msmarco100k.exact",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
