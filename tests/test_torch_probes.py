"""The port's research probes against the JAX package's scripts, on the CPU:
the LSH guarantee frontier, the cover-tree hard A/B, the GloVe-50
reachability and geometry sweeps, the block-graph geometry sweep and the
manifold-structure probe. Each case gives both the same seed and options.
The scripts that take size options or do their work at import run as JAX
subprocesses (``JAX_PLATFORMS=cpu``, ``--platform cpu``) from a temporary
directory, beside the port's side; the others are loaded from ``scripts/``
by path, with both packages' ``Dataset`` capped to 2,000 train rows and 64 queries
(a ``monkeypatch``, undone after; no cache written). The port runs with
``--device cpu``.

Draws: the port's k-means draws its rows, and its LSH tables their
projections, from a ``torch.Generator``; the JAX package from
``jax.random``. At these sizes the draws alone move a recall by more than
the tolerance (LSH at 20k rows: up to 0.06), so the cases give the port the
JAX package's draws (``jax_draws``: k-means rows; ``jax_lsh_draws``:
projections and offsets) and compare the two runs of the same rows.

Tolerances: corpora (the manifold generator's too) bit for bit; the
collision guarantees, the median kth-NN angle and distance within 1e-6
relative; graph recalls and the quantisation rows within 0.03, in-degree-0
counts equal; LSH recalls within 0.02; printed rows with the same keys;
chip_smoke.py's NumPy draws: uniforms bit for bit, normals within 1e-6."""

import argparse
import concurrent.futures
import functools
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from vectordb_retrieval_tpu.data.datasets import Dataset as JDataset
from vectordb_retrieval_tpu.ops import distances as jdops
from vectordb_retrieval_tpu_torch.data.datasets import Dataset as TDataset
from vectordb_retrieval_tpu_torch.data.datasets import read_fvecs
from vectordb_retrieval_tpu_torch.ops import distances as tdops
from vectordb_retrieval_tpu_torch.ops import kmeans
from vectordb_retrieval_tpu_torch.ops import lsh as lshops
from vectordb_retrieval_tpu_torch.scripts import (
    exp_block_geometry,
    exp_covertree_hard,
    exp_glove_ceiling,
    exp_glove_geometry,
    exp_lsh_frontier,
    exp_manifold_structure,
    make_sift1m_surrogate,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
TOL = 0.03
LSH_TOL = 0.02

# Runs a JAX script as __main__ with two hooks: .fvecs parsed by NumPy (the
# native reader is a build product this checkout may lack), and the inputs
# of the first exact search saved to exact_inputs.npz in the working
# directory (the corpus the script made).
_JAX_MAIN = r"""
import os, runpy, sys
import numpy as np
from vectordb_retrieval_tpu.data import native_io
from vectordb_retrieval_tpu.ops import distances

def read_fvecs(path, limit=None):
    raw = np.fromfile(path, dtype=np.int32)
    rows = raw.reshape(-1, int(raw[0]) + 1)[:limit]
    return rows[:, 1:].view(np.float32).copy()

native_io.read_fvecs = read_fvecs
exact_search = distances.exact_search

def keep_inputs(q, x, *args, **kwargs):
    if not os.path.exists("exact_inputs.npz"):
        np.savez("exact_inputs.npz", q=np.asarray(q), x=np.asarray(x))
    return exact_search(q, x, *args, **kwargs)

distances.exact_search = keep_inputs
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _start_jax(name, args, cwd):
    """``scripts/<name>.py`` as a JAX subprocess on the CPU, from ``cwd``,
    its output in cwd/jax.out and jax.err; ``_finish`` waits for it."""
    with open(cwd / "jax.out", "w") as out, open(cwd / "jax.err", "w") as err:
        return subprocess.Popen(
            [sys.executable, "-c", _JAX_MAIN, os.path.join(REPO, "scripts", f"{name}.py"),
             "--platform", "cpu", *args],
            cwd=str(cwd), env=CPU_ENV, stdout=out, stderr=err, text=True,
        )


def _finish(cwd, proc):
    """The JAX side's stdout, once it exited 0."""
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, (cwd / "jax.err").read_text()[-3000:]
    return (cwd / "jax.out").read_text()


LSH_ARGS = ["--limit", "6000", "--queries", "48", "--repeats", "2"]
COVERTREE_ARGS = ["--n", "2000", "--b", "32", "--iters", "2"]
MANIFOLD_ARGS = ["--n", "3000", "--d", "128", "--clusters", "32", "--queries", "64"]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX sides of the subprocess cases, all started by the first case
    that asks (the in-process cases run meanwhile): name -> (working
    directory, process). The LSH frontier's ``data/sift1m_synth`` comes
    from the port's writer."""
    root = tmp_path_factory.mktemp("jax_runs")
    cwd = {name: root / name for name in ("lsh", "covertree", "manifold")}
    for path in cwd.values():
        path.mkdir()
    make_sift1m_surrogate.main(["--n", "6000", "--queries", "48",
                                "--out", str(cwd["lsh"] / "data" / "sift1m_synth")])
    procs = {
        "lsh": _start_jax("exp_lsh_frontier", LSH_ARGS, cwd["lsh"]),
        "covertree": _start_jax("exp_covertree_hard", [*COVERTREE_ARGS, "--out", "ab.json"],
                                cwd["covertree"]),
        "manifold": _start_jax("exp_manifold_structure", MANIFOLD_ARGS, cwd["manifold"]),
    }
    yield {name: (cwd[name], proc) for name, proc in procs.items()}
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's k-means draws the JAX package's rows."""
    monkeypatch.setattr(kmeans, "_permutation", lambda n, seed: torch.from_numpy(
        np.asarray(jax.random.permutation(jax.random.PRNGKey(int(seed)), n)).astype(np.int64)))


@pytest.fixture
def jax_lsh_draws(monkeypatch):
    """The port's LSH tables hash with the JAX package's projections and
    E2LSH offsets (``ops/lsh.py``'s draws in both packages)."""

    def projections(seed, t, h, d, device=None):
        return torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.PRNGKey(seed), (t, d, h), dtype=jnp.float32))).to(device)

    def offsets(seed, t, h, width, device=None):
        return torch.from_numpy(np.asarray(jax.random.uniform(
            jax.random.PRNGKey(seed ^ 0xE2), (t, h), minval=0.0, maxval=width,
            dtype=jnp.float32))).to(device)

    monkeypatch.setattr(lshops, "make_projections", projections)
    monkeypatch.setattr(lshops, "make_offsets", offsets)


@pytest.fixture
def small_corpora(monkeypatch, tmp_path):
    """Both packages' ``Dataset`` load at most 2,000 train rows and 64
    queries and write no cache; the JAX scripts' relative ``data`` lies
    under ``tmp_path``."""
    for cls in (JDataset, TDataset):
        init = cls.__init__

        def capped(self, *args, _init=init, **kwargs):
            _init(self, *args, **kwargs)
            self.options.update(train_limit=min(int(self.options.get("train_limit", 2000)), 2000),
                                test_size=min(int(self.options.get("test_size", 64)), 64),
                                use_cache=False)

        monkeypatch.setattr(cls, "__init__", capped)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["x", "--platform", "cpu"])


def _beside(jmod, port_main, argv):
    """``jmod.main()`` (a JAX script loaded by path) in a thread, its lines
    printed into a buffer, beside ``port_main(argv)``; ``(the JAX script's
    output, the port's exit code)``."""
    buf = io.StringIO()
    jmod.print = functools.partial(print, file=buf)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        done = pool.submit(jmod.main)
        rc = port_main(argv)
        done.result(timeout=600)
    return buf.getvalue(), rc


def _assert_near(got, want, tol, what):
    assert abs(got - want) <= tol, (what, got, want)


# ---- LSH guarantees and difficulty --------------------------------------------------


@pytest.mark.parametrize("theta", [10.0, 38.4, 51.2, 80.0])
def test_lsh_guarantees_match_jax(theta):
    jmod = _jax_script("exp_lsh_frontier")
    for s in exp_lsh_frontier.SETTINGS:
        t, h = s["num_tables"], s["hash_size"]
        want = jmod.sign_guarantee(t, h, theta)
        assert exp_lsh_frontier.sign_guarantee(t, h, theta) == pytest.approx(want, rel=1e-6)
        for r in (1.0, 337.9):
            width = s.get("width_r", 1.0) * r
            want = jmod.e2lsh_guarantee(t, h, width, r * theta / 38.4)
            got = exp_lsh_frontier.e2lsh_guarantee(t, h, width, r * theta / 38.4)
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_lsh_kth_nn_difficulty_matches_jax(jax_runs):
    """The median kth-NN angle and l2 distance of the port's ground truth
    against the JAX script's formula on the JAX package's, on the LSH
    case's SIFT surrogate (this case starts the JAX subprocesses)."""
    sift = jax_runs["lsh"][0] / "data" / "sift1m_synth"
    x = read_fvecs(str(sift / "sift_base.fvecs"))
    q = read_fvecs(str(sift / "sift_query.fvecs"))
    k = 100
    jl2, _ = jdops.exact_search(jnp.asarray(q), jnp.asarray(x), k)
    jcos, _ = jdops.exact_search(jdops.normalize(jnp.asarray(q)), jdops.normalize(jnp.asarray(x)),
                                 k, metric="ip")
    jl2, jcos = np.asarray(jl2), np.asarray(jcos)
    want_theta = float(np.degrees(np.arccos(np.median(np.clip(-jcos[:, -1], -1.0, 1.0)))))
    want_r = float(np.sqrt(np.median(jl2[:, -1])))
    tl2, _ = tdops.exact_search(q, x, k, device="cpu")
    tcos, _ = tdops.exact_search(tdops.normalize(torch.from_numpy(q)),
                                 tdops.normalize(torch.from_numpy(x)), k, metric="ip", device="cpu")
    theta, r = exp_lsh_frontier.kth_nn_difficulty(tl2.numpy(), tcos.numpy())
    assert theta == pytest.approx(want_theta, rel=1e-6)
    assert r == pytest.approx(want_r, rel=1e-6)
    assert 20.0 < theta < 80.0


# ---- GloVe-50 reachability and geometry ---------------------------------------------


_CEILING = re.compile(r"^(.{24}) deg=\s*(\d+) in-deg-0=\s*(\d+)  recall\(ef125,it3\)=([0-9.]+)"
                      r"  recall\(ef512,it12\)=([0-9.]+)$")


def test_glove_ceiling_matches_jax(small_corpora, capsys, jax_draws):
    jax_out, rc = _beside(_jax_script("exp_glove_ceiling"), exp_glove_ceiling.main,
                          ["--data-dir", "pd", "--device", "cpu"])
    assert rc == 0
    port = capsys.readouterr().out
    rows = []
    for out in (jax_out, port):
        lines = out.splitlines()
        assert len(lines) == 3
        assert lines[2] == "rev=M forced-backlink: (not implemented yet — skipped)"
        rows.append([_CEILING.match(ln).groups() for ln in lines[:2]])
    jrows, prows = rows
    for (jl, jdeg, jin, jcomm, jsat), (pl, pdeg, pin, pcomm, psat) in zip(jrows, prows):
        assert (pl, pdeg, pin) == (jl, jdeg, jin)
        _assert_near(float(pcomm), float(jcomm), TOL, pl)
        _assert_near(float(psat), float(jsat), TOL, pl)
    assert [r[1] for r in prows] == ["48", "64"]


_GEOMETRY = re.compile(r"^rev=(\d+) ef=(\d+) it=(\d)  recall=([0-9.]+)  rows/q~\s*(\d+)"
                       r"  wall=\s*[0-9.]+s$")


def test_glove_geometry_matches_jax(small_corpora, capsys, jax_draws):
    jax_out, rc = _beside(_jax_script("exp_glove_geometry"), exp_glove_geometry.main,
                          ["--data-dir", "pd", "--device", "cpu"])
    assert rc == 0
    port = capsys.readouterr().out
    jrows = [_GEOMETRY.match(ln).groups() for ln in jax_out.splitlines()]
    prows = [_GEOMETRY.match(ln).groups() for ln in port.splitlines()]
    assert len(prows) == len(jrows) == 18
    for j, p in zip(jrows, prows):
        assert (p[:3], p[4]) == (j[:3], j[4])
        _assert_near(float(p[3]), float(j[3]), TOL, p[:3])


# ---- block-graph geometry -------------------------------------------------------------


_BLOCK = re.compile(r"^block=(\d+) spill=(\S+) slab=(\w+) efb=(\d+) expand=(\d+) iters=(\d+) "
                    r"probes=(\d+) recall=([0-9.]+) qps=(\d+)$")


def test_block_geometry_matches_jax(small_corpora, capsys, monkeypatch, jax_draws):
    """Both sweeps under the JAX script's knobs: two spills, both slab
    dtypes, a ragged block size and two geometries (a third probes every
    block and is skipped)."""
    for var, value in (("SPILLS", "0,0.2"), ("BLOCKS", "100"), ("SLABS", "f32,bf16"),
                       ("DEGREE", "8"), ("GEOMS", "8:2:3,8:4:4,8:5:5")):
        monkeypatch.setenv(var, value)
    jmod = _jax_script("exp_block_geometry")
    monkeypatch.setattr(jmod, "enable_compilation_cache", lambda: None)
    jax_out, rc = _beside(jmod, exp_block_geometry.main, ["--data-dir", "pd", "--device", "cpu"])
    assert rc == 0
    port = capsys.readouterr().out
    pl, jl = port.splitlines(), jax_out.splitlines()
    assert len(pl) == len(jl) == 4 * 3
    for p, j in zip(pl, jl):
        if j.startswith("built "):
            assert p == j
            continue
        pm, jm = _BLOCK.match(p).groups(), _BLOCK.match(j).groups()
        assert pm[:7] == jm[:7]
        _assert_near(float(pm[7]), float(jm[7]), TOL, pm[:7])
    assert pl[0] == "built block=100 spill=0.0 slab=f32 n_blocks=20 degree=8"


# ---- cheap cases, while the JAX subprocesses run ---------------------------------------------


@pytest.mark.parametrize("seed,shape", [(42, (32, 128, 8)), (42, (2, 128, 18)),
                                        (42 ^ 0xE2, (12, 8)), (7, (5,))])
def test_chip_smoke_lsh_draws_are_jax_draws(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=jnp.float32))
    got = chip_smoke.jax_normal(seed, shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=0.0,
                                         maxval=337.9, dtype=jnp.float32))
    np.testing.assert_array_equal(chip_smoke.jax_uniform(seed, shape, 0.0, 337.9), want)


def test_covertree_hard_reports_a_failed_descent_and_goes_on(tmp_path, capsys, monkeypatch):
    """A descent that raises prints its FAILED line; the next one runs."""
    from vectordb_retrieval_tpu_torch.ops import covertree as ctops

    def broken(*args, **kwargs):
        raise RuntimeError("no walk")

    monkeypatch.setattr(ctops, "covertree_blockwalk_search", broken)
    assert exp_covertree_hard.main(["--n", "600", "--b", "8", "--iters", "1", "--out",
                                    str(tmp_path / "ab.json"), "--data-dir", str(tmp_path),
                                    "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "blockwalk: FAILED RuntimeError: no walk"
    assert lines[2].startswith("stream: ")
    with open(tmp_path / "ab.json") as f:
        assert list(json.load(f)["rows"]) == ["stream"]


def _manifold_args(**overrides):
    args = dict(n=3000, d=128, rank=16, orient=1.0, global_rank=48, clusters=32, queries=64,
                center_scale=2.0, point_scale=0.55)
    return argparse.Namespace(**{**args, **overrides})


def test_manifold_corpus_follows_its_options():
    """orient 0 puts every cluster in one tangent frame: the corpus spans
    the centres' global rank plus that frame's; the generator repeats."""
    ns = _manifold_args(n=400, d=32, rank=4, orient=0.0, global_rank=8, clusters=8, queries=16)
    x, q = exp_manifold_structure.make_corpus(ns)
    assert x.shape == (400, 32) and q.shape == (16, 32)
    assert x.dtype == q.dtype == np.float32 and x.flags.c_contiguous
    np.testing.assert_array_equal(x, exp_manifold_structure.make_corpus(ns)[0])
    assert np.linalg.matrix_rank(x.astype(np.float64), tol=1e-3) <= 8 + 4


def test_manifold_rotation_row_builds_with_pq_rotations(monkeypatch, capsys):
    """--rot-bs adds a fifth row, IVF256,PQ64 nprobe 48 with per-list
    rotations of that block size (the builds stubbed: the row's options)."""
    calls = []

    def stub(x, q, gt, index_key, k, device, nprobe=None, **kw):
        calls.append((index_key, nprobe, kw))
        return 0.5, None, 1.0, 2.0

    monkeypatch.setattr(exp_manifold_structure, "factory_recall", stub)
    assert exp_manifold_structure.main(["--n", "600", "--d", "32", "--global-rank", "8",
                                        "--clusters", "8", "--queries", "8", "--rot-bs", "16",
                                        "--device", "cpu"]) == 0
    assert calls == [("PQ64", None, {}), ("IVF256,PQ64", 48, {}), ("IVF256,SQ8", 48, {}),
                     ("IVF100,Flat", 10, {}), ("IVF256,PQ64", 48, {"pq_rotations": 16})]
    doc = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(doc["rows"]) == ["pq64", "ivf_pq", "ivf_sq8", "ivf_flat", "ivf_pq_rot16"]
    assert doc["rows"]["ivf_pq_rot16"] == {"recall": 0.5, "build_s": 1.0}


# ---- the subprocess cases: the LSH frontier, the cover-tree A/B, the manifold --------------


def test_lsh_frontier_matches_jax(jax_runs, capsys, jax_lsh_draws):
    cwd, proc = jax_runs["lsh"]
    assert exp_lsh_frontier.main([*LSH_ARGS, "--data-dir", str(cwd / "data"),
                                  "--device", "cpu"]) == 0
    port_lines = capsys.readouterr().out.splitlines()
    jax_lines = _finish(cwd, proc).splitlines()
    # the corpus line and the difficulty it quotes (one decimal)
    assert port_lines[0] == jax_lines[0] and port_lines[0].startswith("corpus (6000, 128)")
    prows = [json.loads(ln) for ln in port_lines if ln.startswith("{")]
    jrows = [json.loads(ln) for ln in jax_lines if ln.startswith("{")]
    assert len(prows) == len(jrows) == len(exp_lsh_frontier.SETTINGS) == 13
    for p, j, s in zip(prows, jrows, exp_lsh_frontier.SETTINGS):
        assert list(p) == list(j) and {k: p[k] for k in s} == s == {k: j[k] for k in s}
        _assert_near(p["recall"], j["recall"], LSH_TOL, s)
        _assert_near(p["p_collide_kthNN"], j["p_collide_kthNN"], 1e-4, s)
        assert p["qps"] > 0
    # the table: the same header, one row a setting, the same first five cells
    ptab = [ln for ln in port_lines if ln.startswith("|")]
    jtab = [ln for ln in jax_lines if ln.startswith("|")]
    assert ptab[:2] == jtab[:2] and len(ptab) == len(jtab) == 15
    for p, j in zip(ptab[2:], jtab[2:]):
        assert p.split("|")[1:6] == j.split("|")[1:6]


def test_covertree_hard_matches_jax(jax_runs, tmp_path, capsys):
    cwd, proc = jax_runs["covertree"]
    assert exp_covertree_hard.main([*COVERTREE_ARGS, "--out", str(tmp_path / "p" / "ab.json"),
                                    "--data-dir", str(tmp_path / "pd"), "--device", "cpu"]) == 0
    port, jax_out = capsys.readouterr().out, _finish(cwd, proc)
    with open(cwd / "ab.json") as f:
        jdoc = json.load(f)
    with open(tmp_path / "p" / "ab.json") as f:
        pdoc = json.load(f)
    assert list(pdoc) == list(jdoc)
    assert {k: pdoc[k] for k in ("dataset", "k", "b", "iters")} == \
        {k: jdoc[k] for k in ("dataset", "k", "b", "iters")}
    assert list(pdoc["rows"]) == list(jdoc["rows"]) == ["blockwalk", "stream"]
    for descent, jrow in jdoc["rows"].items():
        assert list(pdoc["rows"][descent]) == list(jrow)
        assert pdoc["rows"][descent]["recall"] == jrow["recall"] == 1.0
    # the printed lines: the build, one a descent, the document written
    shape = re.compile(r"^(blockwalk|stream): [0-9,]+ QPS  recall@20 1\.0000  \([0-9.]+ ms/pass\)$")
    for out in (port, jax_out):
        lines = out.splitlines()
        assert lines[0].startswith("build ") and " nodes=" in lines[0]
        assert [bool(shape.match(ln)) for ln in lines[1:3]] == [True, True]
        assert lines[3].startswith("wrote ")


def test_manifold_structure_matches_jax(jax_runs, capsys, jax_draws):
    cwd, proc = jax_runs["manifold"]
    assert exp_manifold_structure.main([*MANIFOLD_ARGS, "--device", "cpu"]) == 0
    port, jax_out = capsys.readouterr().out, _finish(cwd, proc)
    # the corpus and queries, bit for bit, as the JAX script searched them
    x, q = exp_manifold_structure.make_corpus(_manifold_args())
    with np.load(cwd / "exact_inputs.npz") as z:
        np.testing.assert_array_equal(x, z["x"])
        np.testing.assert_array_equal(q, z["q"])
    pdoc, jdoc = json.loads(port.splitlines()[-1]), json.loads(jax_out.splitlines()[-1])
    names = ["pq64", "ivf_pq", "ivf_sq8", "ivf_flat"]
    assert list(pdoc["rows"]) == list(jdoc["rows"]) == names
    for name in names:
        assert list(pdoc["rows"][name]) == list(jdoc["rows"][name]) == ["recall", "build_s"]
        _assert_near(pdoc["rows"][name]["recall"], jdoc["rows"][name]["recall"], TOL, name)
    assert set(pdoc["args"]) - {"device"} == set(jdoc["args"]) - {"platform"}
    assert [ln.split(" ", 1)[0] for ln in port.splitlines()[:-1]] == names
