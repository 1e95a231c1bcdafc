"""The port's last thirteen tuning probes against the JAX package's scripts,
on the CPU: K1 against its matmul floor (K5) and by width, the exact path's
selections, the IVF rescore by K2, K2's waves, the flagship stream, the node
beam's parts, ablations, settings and neighbour tables, and the selection
primitives' costs.

The JAX sides run in three ``JAX_PLATFORMS=cpu`` subprocesses started by
the first case that needs them (``jax_runs``), each script loaded by path
with its module constants shrunk (the flagship stream's and the wave
probe's shapes, written into the script's code, by text substitution),
its stdout kept in ``<name>.out`` and the NumPy arrays it hands
``jnp.asarray`` in ``<name>.npz``. Every ``pallas_call`` runs in interpret
mode (``dist_blockmin_pallas``, ``slab_dots_manual`` and the floor probe's
``matmul_floor``), as the JAX package's own tests run its kernels off the
TPU, and the compilation cache is stubbed. The port's side runs in this
process with ``--device cpu`` beside them, under the same constants.

Compared: the inputs bit for bit (the same NumPy seeds); the printed
lines' labels (times are not compared; where the JAX script sweeps a TPU
knob the port has not, the labels are compared with the knob taken out);
and each correctness number: distance agreements and recalls equal (the
graph probes with the JAX package's k-means draws, ``jax_draws``), K2's
dots against float64 within 1e-5 of the largest |dot| on both sides, and
the port's own checks (its floor against its plain version, the top-k and
rank merge against sorts, the dedup counts against NumPy)."""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from vectordb_retrieval_tpu_torch.ops import kmeans
from vectordb_retrieval_tpu_torch.scripts import (
    exp_beam_ablate,
    exp_beam_profile,
    exp_beam_table_tune,
    exp_beam_tune,
    exp_dbm_flagship,
    exp_dbm_tune,
    exp_dist_blockmin,
    exp_flagship_unroll,
    exp_graph_neighbor_table,
    exp_slab_rescore,
    exp_slab_ring,
    exp_topk_cost,
    exp_topk_cost2,
    probes,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
SLAB_TOL = 1e-5

RING_SHAPES = (("msmarco", 16, 8, 30, 12, 16), ("sift1m", 8, 8, 40, 12, 8))
UNROLL = {"N": 3000, "D": 16, "K": 5}
UNROLL_CONFIGS = ((8, 3, 8), (8, 3, 16), (8, 5, 8))
BEAM = {"N": 3000, "D": 8, "K": 10, "B": 16, "REPEATS": 2}

# name -> (module constants shared by both sides, options shared by both
# sides, the JAX script's code substitutions, the port's extra constants)
SPECS = {
    "exp_dbm_tune": ({}, ["--n", "3072", "--d", "16", "--b", "384", "--iters", "2"], [], {}),
    "exp_dist_blockmin": ({}, ["--n", "20000", "--d", "8", "--b", "8", "--k", "10",
                               "--iters", "2", "--w", "8"], [], {}),
    "exp_slab_rescore": ({"B": 8, "NB": 6, "W": 8, "D": 16, "G": 200, "K": 10, "ITERS": 2},
                         [], [], {}),
    "exp_dbm_flagship": ({"N": 3000, "D": 16, "B": 8, "ITERS": 2}, [], [], {}),
    "exp_slab_ring": (
        {"REPEATS": 2}, [],
        [("depths = [8, 16, 32, 48, 64]", "depths = [8, 16]"),
         ('run_shape("msmarco", 512, 96, 784, 128, 384,', 'run_shape("msmarco", 16, 8, 30, 12, 16,'),
         ('run_shape("sift1m", 256, 96, 7816, 128, 128,', 'run_shape("sift1m", 8, 8, 40, 12, 8,')],
        {"SHAPES": RING_SHAPES}),
    "exp_flagship_unroll": (
        {}, [],
        [("N, D, K = 100_000, 384, 20", "N, D, K = 3000, 16, 5"),
         ("run_cfg(256, 96, 8)\nrun_cfg(256, 96, 16)\nrun_cfg(256, 96, 32)\nrun_cfg(256, 192, 8)",
          "run_cfg(8, 3, 8)\nrun_cfg(8, 3, 16)\nrun_cfg(8, 5, 8)")],
        {**UNROLL, "CONFIGS": UNROLL_CONFIGS}),
    "exp_beam_profile": ({"N": 2000, "D": 8, "K": 5, "B": 16, "REPEATS": 2, "EF": 20, "W": 6,
                          "ITERS": 3, "R": 8}, [], [], {}),
    "exp_beam_ablate": ({**BEAM, "R": 16, "E": 256, "EF": 32, "W": 6, "KEEP": 24, "ITERS": 3},
                        [], [], {}),
    "exp_beam_tune": (BEAM, [], [], {}),
    "exp_beam_table_tune": ({**BEAM, "N": 5000}, [], [], {}),
    "exp_graph_neighbor_table": (BEAM, [], [], {}),
    "exp_topk_cost": ({"B": 8, "REPEATS": 2, "ITERS": 2}, [], [], {}),
    "exp_topk_cost2": ({"B": 8, "REPEATS": 2, "ITERS": 2}, [], [], {}),
}
# the JAX sides' three subprocesses, each about as long
GROUPS = (
    ("exp_beam_tune", "exp_dbm_tune", "exp_slab_ring", "exp_topk_cost2"),
    ("exp_beam_table_tune", "exp_dist_blockmin", "exp_flagship_unroll", "exp_beam_profile"),
    ("exp_graph_neighbor_table", "exp_beam_ablate", "exp_topk_cost", "exp_slab_rescore",
     "exp_dbm_flagship"),
)
PORT = {
    "exp_dbm_tune": exp_dbm_tune, "exp_dist_blockmin": exp_dist_blockmin,
    "exp_slab_rescore": exp_slab_rescore, "exp_dbm_flagship": exp_dbm_flagship,
    "exp_slab_ring": exp_slab_ring, "exp_flagship_unroll": exp_flagship_unroll,
    "exp_beam_profile": exp_beam_profile, "exp_beam_ablate": exp_beam_ablate,
    "exp_beam_tune": exp_beam_tune, "exp_beam_table_tune": exp_beam_table_tune,
    "exp_graph_neighbor_table": exp_graph_neighbor_table, "exp_topk_cost": exp_topk_cost,
    "exp_topk_cost2": exp_topk_cost2,
}

# Runs each given spec's JAX script in turn (see the module docstring).
_JAX_RUNNER = r"""
import contextlib, json, os, sys, traceback, types
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax.experimental import pallas as pl
from vectordb_retrieval_tpu.utils import compat
compat.enable_compilation_cache = lambda *a, **k: None
from vectordb_retrieval_tpu.ops import graph as gops
from vectordb_retrieval_tpu.ops import kmeans as jkmeans
call = pl.pallas_call
pl.pallas_call = lambda *a, **k: call(*a, **{**k, "interpret": True})
REPO, SPECS = sys.argv[1], json.loads(sys.argv[2])
asarray = jnp.asarray
recorded = []

def keep(a, *args, **kwargs):
    if isinstance(a, np.ndarray):
        recorded.append(np.array(a))
    return asarray(a, *args, **kwargs)

jnp.asarray = keep
for name, consts, argv, subs in SPECS:
    del recorded[:]
    path = os.path.join(REPO, "scripts", name + ".py")
    src = open(path).read()
    for old, new in subs:
        assert src.count(old) == 1, (name, old)
        src = src.replace(old, new)
    mod = types.ModuleType("jax_" + name)
    mod.__file__ = path
    rc = 0
    with open(name + ".out", "w") as out, open(name + ".err", "w") as err:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                sys.argv = [path, *argv]
                code = compile(src, path, "exec")
                if "def main" in src:
                    exec(code, mod.__dict__)
                    for key, value in consts.items():
                        setattr(mod, key, value)
                    mod.main()
                else:  # the script runs as it is imported
                    exec(code, mod.__dict__)
            except BaseException:
                traceback.print_exc()
                rc = 1
    np.savez(name + ".npz", *recorded)
    with open(name + ".rc", "w") as f:
        f.write(str(rc))
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX sides in three subprocesses started once; ``result(name)``
    waits for that script: ``(stdout, [recorded arrays])``."""
    workdir = tmp_path_factory.mktemp("last_probes")
    procs = []
    for i, group in enumerate(GROUPS):
        specs = [(name, *SPECS[name][:3]) for name in group]
        err = open(workdir / f"runner{i}.err", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _JAX_RUNNER, REPO, json.dumps(specs)],
            cwd=str(workdir), env=CPU_ENV, stdout=subprocess.DEVNULL, stderr=err), err, i))
    group_of = {name: p for group, p in zip(GROUPS, procs) for name in group}

    def result(name):
        proc, _, i = group_of[name]
        rc_path = workdir / f"{name}.rc"
        deadline = time.monotonic() + 900
        while not rc_path.exists():
            if proc.poll() is not None and not rc_path.exists():
                raise AssertionError((workdir / f"runner{i}.err").read_text()[-3000:])
            assert time.monotonic() < deadline, f"{name}: no result after 900 s"
            time.sleep(0.2)
        assert rc_path.read_text() == "0", (workdir / f"{name}.out").read_text()[-3000:]
        with np.load(workdir / f"{name}.npz") as z:
            arrays = [z[f"arr_{i}"] for i in range(len(z.files))]
        return (workdir / f"{name}.out").read_text(), arrays

    yield result
    for proc, err, _ in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        err.close()


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's k-means draws the JAX package's rows."""
    monkeypatch.setattr(kmeans, "_permutation", lambda n, seed: torch.from_numpy(
        np.asarray(jax.random.permutation(jax.random.PRNGKey(int(seed)), n)).astype(np.int64)))


def _port(name, monkeypatch, capsys):
    """The port's side of ``name`` under the spec's constants and options:
    ``(its lines but the check line, the check's numbers)``."""
    consts, argv, _, extra = SPECS[name]
    mod = PORT[name]
    for key, value in {**consts, **extra}.items():
        monkeypatch.setattr(mod, key, value)
    capsys.readouterr()
    assert mod.main([*argv, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("check ")
    return lines[:-1], json.loads(lines[-1][len("check "):])


def _fields(lines, pattern):
    """Each line matched whole by ``pattern``: its groups."""
    rows = []
    for ln in lines:
        m = re.fullmatch(pattern, ln)
        assert m, (ln, pattern)
        rows.append(m.groups())
    return rows


def _same_inputs(got, recorded):
    """The port's inputs equal the JAX script's, in its order."""
    assert len(recorded) >= len(got)
    for i, (a, b) in enumerate(zip(got, recorded)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"input {i}")


# ---- K1 and its floor, the exact path ---------------------------------------------------


def test_dbm_tune_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_dbm_tune", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_dbm_tune")
    timed = r"(.+?)\s+[0-9.]+ ms/pass"
    gbs = r"  -> \d+ GB/s effective"
    jl = jax_out.splitlines()
    # the JAX script's floor runs at one tile of S rows here (its tile is
    # the Mosaic knob the port's line leaves out), and only where S / w ==
    # B: its timing chain adds the floor's [S/w] row sums to the [B, d]
    # queries
    assert re.fullmatch(r"matmul floor tile=3072\s+[0-9.]+ ms/pass", jl[2]), jl
    jl[2] = re.sub(r"matmul floor tile=\d+", "matmul floor", jl[2])
    for lines in (port, jl):
        assert [_fields([ln], gbs) for ln in lines[1::2][:2]]
    labels = [_fields([ln], timed)[0][0] for ln in port if "ms/pass" in ln]
    assert labels == [_fields([ln], timed)[0][0] for ln in jl if "ms/pass" in ln] == [
        "full kernel w=8", "matmul floor", "full kernel w=16", "full kernel w=32",
        "full kernel w=64"]
    db, pen, q = exp_dbm_tune.make_inputs(3072, 16, 384, 8)
    assert db.shape == (3072, 16)
    _same_inputs([q, db, pen], arrays)
    assert check["floor_rel_err"] == 0.0 and check["floor_finite"] is True
    assert check["shape"] == [384, 3072, 16, 8]


def test_dist_blockmin_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_dist_blockmin", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_dist_blockmin")
    jl = jax_out.splitlines()
    timed = r"(.+?)\s+[0-9.]+ ms/pass \(\s*[0-9.]+ QPS\)"
    assert _fields(port[:9], timed) == _fields(jl[:9], timed)
    agree = r"(.*?) ?distance agreement[^:]*:\s+([0-9.]+)"
    assert port[9:] == jl[9:]
    assert _fields(jl[9:], agree) == [
        (name, "1.000000") for name in ("", "hier-sel", "split-sel", "sortmerge", "hier4-sort")]
    assert check["agreement"] == {k: 1.0 for k in
                                  ("full", "hier-sel", "split-sel", "sortmerge", "hier4-sort")}
    _same_inputs(exp_dist_blockmin.make_inputs(20000, 8, 8, 8), arrays)


def test_dbm_flagship_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_dbm_flagship", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_dbm_flagship")
    row = r"w=\s*(\d+) {1,2}(?:vmem=\s*\d+MiB  )?f32\s+[0-9.]+ ms \(\s*\d+ GB/s\)   bf16\s+[0-9.]+ ms \(\s*\d+ GB/s\)"
    jrow = _fields(jax_out.splitlines(), row)
    # the JAX script's three VMEM budgets a width are one line here
    assert [r[0] for r in _fields(port, row)] == ["8", "16", "32"]
    assert [r[0] for r in jrow] == [w for w in ("8", "16", "32") for _ in range(3)]
    _same_inputs(list(exp_dbm_flagship.make_inputs()), arrays)
    assert check["finite"] is True and list(check["ms"]) == ["8", "16", "32"]


def test_flagship_unroll_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_flagship_unroll", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_flagship_unroll")
    row = r"B=\s*(\d+) reps=\s*(\d+)(?: unroll=\s*\d+)?  \s*\d+ QPS \(\s*[0-9.]+ ms/batch\)"
    # the unroll knob is XLA's: the port keeps one line a (batch, reps)
    assert _fields(port, row) == [("8", "3"), ("8", "5")]
    assert _fields(jax_out.splitlines(), row) == [("8", "3"), ("8", "3"), ("8", "5")]
    db, draws = exp_flagship_unroll.make_inputs()
    _same_inputs([db, *draws], arrays)
    assert [r["ids_agree"] for r in check["rows"].values()] == [1.0, 1.0]


# ---- K2: the IVF rescore, the beam's waves ------------------------------------------------


def test_slab_rescore_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_slab_rescore", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_slab_rescore")
    jl = jax_out.splitlines()
    err_line = r"slab dots max\|err\| = (\S+) \(abs, \|dot\|~([0-9.]+)\)"
    ((perr, pdot),), ((jerr, jdot),) = _fields(port[:1], err_line), _fields(jl[:1], err_line)
    assert pdot == jdot
    assert float(perr) <= SLAB_TOL * float(pdot) and float(jerr) <= SLAB_TOL * float(jdot)
    row = r"(HLO |SLAB) gather rescore\+tail\s+[0-9.]+ ms/pass(?: \(depth=(\d+)\))?"
    # the manual kernel's ring depths are one K2 line here
    assert _fields(port[1:], row) == [("HLO ", None), ("SLAB", None)]
    assert _fields(jl[1:], row) == [("HLO ", None), ("SLAB", "32"), ("SLAB", "64")]
    assert check["slab_max_abs_err"] <= check["slab_tol"] and check["first_rel_diff"] <= 1e-5
    _same_inputs(list(exp_slab_rescore.make_inputs().values()), arrays)


def test_slab_ring_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_slab_ring", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_slab_ring")
    head = r"== (\w+): B=(\d+) W=(\d+) L=(\d+) d=(\d+) (\w+) \((\d+) MB/wave\) =="
    heads = [ln for ln in port if ln.startswith("==")]
    assert _fields(heads, head) == _fields([ln for ln in jax_out.splitlines()
                                            if ln.startswith("==")], head)
    wave = r"(?:depth=\s*(\d+)  )?\s*[0-9.]+ ms/wave\s+[0-9.]+ GB/s effective"
    assert _fields([ln for ln in port if "ms/wave" in ln], wave) == [(None,)] * 2
    assert _fields([ln for ln in jax_out.splitlines() if "ms/wave" in ln], wave) == [
        ("8",), ("16",)] * 2
    assert "mismatch" not in jax_out and not [ln for ln in port if "mismatch" in ln]
    assert port[0].startswith("devices:") and jax_out.startswith("devices:")
    got = [a for shape in RING_SHAPES for a in exp_slab_ring.make_inputs(*shape[1:])]
    _same_inputs(got, arrays)
    for r in check["shapes"].values():
        assert r["max_abs_err"] <= SLAB_TOL * r["max_abs_plain"]


# ---- the node beam ------------------------------------------------------------------------


def test_beam_profile_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_beam_profile", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_beam_profile")
    row = r"(.+?)\s+[0-9.]+ ms/batch\s+\d+ QPS"
    assert _fields(port, row) == _fields(jax_out.splitlines(), row)
    assert len(port) == 7
    _same_inputs(list(exp_beam_profile.make_inputs().values()), arrays)
    assert check["finite"] is True and check["ids_in_range"] is True
    assert len(check["checksums"]) == 7


def test_beam_ablate_matches_jax(jax_runs, monkeypatch, capsys, jax_draws):
    port, check = _port("exp_beam_ablate", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_beam_ablate")
    row = r"skip=(\S+)\s+[0-9.]+ ms/batch(?:  saves\s+-?[0-9.]+ ms)?(?:  recall=([0-9.]+))?"
    prow, jrow = _fields(port, row), _fields(jax_out.splitlines(), row)
    assert prow == jrow and [r[0] for r in prow] == [
        "(none)", *exp_beam_ablate.SKIPS[1:]]
    assert f"{check['recall']:.4f}" == prow[0][1]
    assert check["ids_equal"] is True and check["dists_equal"] is True
    _same_inputs(list(probes.beam_inputs(3000, 8, 16, 2)), arrays)


def _beam_rows(lines, pattern):
    return {r[0]: r[1] for r in _fields(lines, pattern)}


def test_beam_tune_matches_jax(jax_runs, monkeypatch, capsys, jax_draws):
    port, check = _port("exp_beam_tune", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_beam_tune")
    build = [ln for ln in port if ln.startswith("building")]
    assert build == [ln for ln in jax_out.splitlines() if ln.startswith("building")] == [
        f"building degree-{r} graph..." for r in (32, 48, 64)]
    row = r"(R=.+?):\s+\d+ QPS  recall@10=([0-9.]+)(?: <== PASS)?"
    prow = _beam_rows([ln for ln in port if ln.startswith("R=")], row)
    assert prow == _beam_rows([ln for ln in jax_out.splitlines() if ln.startswith("R=")], row)
    assert len(prow) == 10
    assert {k: f"{v['recall']:.4f}" for k, v in check["rows"].items()} == prow
    _same_inputs(list(probes.beam_inputs(3000, 8, 16, 2)), arrays)


def test_beam_table_tune_matches_jax(jax_runs, monkeypatch, capsys, jax_draws):
    port, check = _port("exp_beam_table_tune", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_beam_table_tune")
    row = r"(R=.+?) table=\s*(\d+)MB:\s+\d+ QPS recall=([0-9.]+)(?: <== PASS)?"
    prow = _fields([ln for ln in port if ln.startswith("R=")], row)
    assert prow == _fields([ln for ln in jax_out.splitlines() if ln.startswith("R=")], row)
    assert len(prow) == 10 and prow[4][0].endswith("float32 ")
    assert {k: f"{v['recall']:.4f}" for k, v in check["rows"].items()} == {
        r[0].rstrip(): r[2] for r in prow}
    _same_inputs(list(probes.beam_inputs(5000, 8, 16, 2)), arrays)


def test_graph_neighbor_table_matches_jax(jax_runs, monkeypatch, capsys, jax_draws):
    port, check = _port("exp_graph_neighbor_table", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_graph_neighbor_table")
    jl = jax_out.splitlines()
    assert port[0] == jl[0] == "building graph..." and port[1].startswith("build ")
    row = r"(.+?):\s+\d+ QPS  recall@10=([0-9.]+)(  table=\d+MB)?"
    assert _fields(port[2:], row) == _fields(jl[2:], row)
    assert [r[0] for r in _fields(port[2:], row)] == [
        "current beam", "nbr-table f32", "nbr-table bf16", "nbr bf16 ef=125 W=16 it=10",
        "nbr bf16 ef=125 W=8 it=18", "nbr bf16 ef=96 W=16 it=9", "nbr bf16 ef=64 W=8 it=12"]
    assert check["best_recall"] == max(r["recall"] for r in check["rows"].values())
    _same_inputs(list(probes.beam_inputs(3000, 8, 16, 2)), arrays)


# ---- the selection primitives -------------------------------------------------------------


def test_topk_cost_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_topk_cost", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_topk_cost")
    row = r"(.+?)\s+[0-9.]+ ms/batch"
    assert _fields(port, row) == _fields(jax_out.splitlines(), row)
    assert len(port) == 38
    _same_inputs(list(probes.selection_inputs(256, 8, 2)), arrays)
    assert all(check["topk_equals_sort"].values()) and len(check["topk_equals_sort"]) == 20
    assert check["rank_merge_equals_sort"] == {"128+32": True, "128+64": True}


def test_topk_cost2_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_topk_cost2", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_topk_cost2")
    row = r"(.+?)\s+[0-9.]+ ms/batch"
    assert _fields(port, row) == _fields(jax_out.splitlines(), row)
    assert len(port) == 16
    _same_inputs(list(probes.selection_inputs(256, 8, 2)), arrays)
    assert check["finite"] is True
    for c in check["dedup_counts"].values():
        assert c["counted"] == c["numpy"]
