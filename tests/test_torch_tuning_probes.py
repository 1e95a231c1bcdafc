"""The port's tuning probes against the JAX package's scripts, on the CPU:
the exact path's block width, slack, selection and batch, its stage split,
the IVF fused stream's stages, tail and rescore formulations, and both
cover-tree walks with their stage and iteration costs.

The JAX sides run one after another in one ``JAX_PLATFORMS=cpu`` subprocess
started by the first case that needs them (``jax_runs``), from a temporary
directory holding a 6,000-row SIFT surrogate from the port's writer: each
script is loaded by path with its module constants shrunk (or its options
small), its stdout kept in ``<name>.out`` and the NumPy arrays it hands
``jnp.asarray`` in ``<name>.npz``. The runner gives the scripts what the
JAX package's own tests give them off the TPU: ``dist_blockmin_pallas`` in
interpret mode, ``.fvecs`` parsed by NumPy, no compilation cache, and
``Dataset`` capped to 2,000 train rows and 64 queries with no cache (the
cover-tree profile's msmarco_surrogate only). The port's side runs in this
process with ``--device cpu`` beside it, under the same constants and caps.

Compared: the synthetic inputs bit for bit (the same NumPy seed); the
printed lines' labels and keys (times are not compared); and each
correctness number. Tolerances: distance errors and the cover tree's
exactness within 1e-5 of the largest distance (f32 rounding of the
expansion; 1e-3 for the walk's band); agreements and recalls equal (1.0
at these sizes) but for the bf16 stage 1's recall (within 0.01); the
rescore formulations' relative errors within 1e-6 of the JAX script's;
the stream profile's checksums within 1e-3 relative (the JAX script
perturbs each chained pass by 1e-12 of the last sum); tree shapes, layouts
and the cover tree's scored-node counts equal."""

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

from vectordb_retrieval_tpu_torch.data.datasets import Dataset as TDataset
from vectordb_retrieval_tpu_torch.ops import kmeans
from vectordb_retrieval_tpu_torch.scripts import (
    exp_block_rescore,
    exp_blockmin_stages,
    exp_blockmin_width,
    exp_covertree_blockwalk,
    exp_covertree_iter_cost,
    exp_covertree_profile,
    exp_covertree_stream_profile,
    exp_flagship_batch,
    exp_flagship_profile,
    exp_flagship_sweep,
    exp_flagship_w,
    exp_ivf_fused_profile,
    exp_ivf_tail,
    exp_topk_twolevel,
    make_sift1m_surrogate,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
DIST_TOL = 1e-5
TREE_TOL = 1e-3
RESCORE_TOL = 1e-6
CAP = {"train_limit": 2000, "test_size": 64}

# (name, module constants shared by both sides, options shared by both sides)
SPECS = (
    ("exp_blockmin_width", {},
     ["--shapes", "3000x16x8x5,40000x8x4x10", "--iters", "2", "--widths", "8,16,32"]),
    ("exp_flagship_w", {"N": 3000, "D": 16, "K": 5, "B": 8, "REPEATS": 3}, []),
    ("exp_flagship_sweep", {"N": 3000, "D": 16, "K": 5, "B": 8}, []),
    ("exp_flagship_batch", {"N": 3000, "D": 16, "K": 5, "TOTAL": 1024}, []),
    ("exp_flagship_profile", {"N": 3000, "D": 16, "K": 5, "B": 8, "REPEATS": 3}, []),
    ("exp_blockmin_stages", {},
     ["--n", "40000", "--d", "8", "--b", "8", "--k", "10", "--iters", "2"]),
    ("exp_topk_twolevel", {}, ["--nb", "3000", "--b", "8", "--s", "20", "--iters", "2"]),
    ("exp_ivf_tail", {"B": 4, "NB": 6, "W": 8, "D": 8, "G": 100, "K": 10, "ITERS": 2}, []),
    ("exp_block_rescore", {"B": 4, "NB": 6, "W": 8, "D": 8, "G": 100, "ITERS": 2}, []),
    ("exp_covertree_stream_profile", {},
     ["--m", "20000", "--d", "8", "--b", "8", "--k", "10", "--iters", "2"]),
    ("exp_covertree_iter_cost",
     {"B": 4, "E": 4, "C": 8, "F": 64, "M": 2000, "D": 8, "K": 5, "ITERS": 2}, []),
    ("exp_ivf_fused_profile", {}, ["--k", "10", "--nprobe", "8", "--iters", "2", "--b", "16"]),
    ("exp_covertree_blockwalk", {}, ["--k", "10", "--iters", "2", "--b", "16"]),
    ("exp_covertree_profile", {}, ["--n", "2000", "--k", "10"]),
)
PORT = {
    "exp_blockmin_width": exp_blockmin_width, "exp_flagship_w": exp_flagship_w,
    "exp_flagship_sweep": exp_flagship_sweep, "exp_flagship_batch": exp_flagship_batch,
    "exp_flagship_profile": exp_flagship_profile, "exp_blockmin_stages": exp_blockmin_stages,
    "exp_topk_twolevel": exp_topk_twolevel, "exp_ivf_tail": exp_ivf_tail,
    "exp_block_rescore": exp_block_rescore,
    "exp_covertree_stream_profile": exp_covertree_stream_profile,
    "exp_covertree_iter_cost": exp_covertree_iter_cost,
    "exp_ivf_fused_profile": exp_ivf_fused_profile,
    "exp_covertree_blockwalk": exp_covertree_blockwalk,
    "exp_covertree_profile": exp_covertree_profile,
}
# the JAX scripts that take --platform
PLATFORM = {"exp_blockmin_width", "exp_blockmin_stages", "exp_topk_twolevel",
            "exp_covertree_stream_profile", "exp_covertree_profile"}

# Runs each spec's JAX script in turn (see the module docstring).
_JAX_RUNNER = r"""
import contextlib, importlib.util, json, os, sys, traceback
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from vectordb_retrieval_tpu.utils import compat
compat.enable_compilation_cache = lambda *a, **k: None
from vectordb_retrieval_tpu.data import native_io
from vectordb_retrieval_tpu.data.datasets import Dataset
from vectordb_retrieval_tpu.ops import pallas_kernels as plk

def read_fvecs(path, limit=None):
    raw = np.fromfile(path, dtype=np.int32)
    rows = raw.reshape(-1, int(raw[0]) + 1)[:limit]
    return rows[:, 1:].view(np.float32).copy()

native_io.read_fvecs = read_fvecs
dbm = plk.dist_blockmin_pallas
plk.dist_blockmin_pallas = lambda *a, **k: dbm(*a, **{**k, "interpret": True})
init = Dataset.__init__
REPO, SPECS, CAP = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])

def capped(self, *args, **kwargs):
    init(self, *args, **kwargs)
    if self.name == "msmarco_surrogate":
        self.options.update(CAP, use_cache=False)

Dataset.__init__ = capped
asarray = jnp.asarray
recorded = []

def keep(a, *args, **kwargs):
    if isinstance(a, np.ndarray):
        recorded.append(np.array(a))
    return asarray(a, *args, **kwargs)

jnp.asarray = keep
for name, consts, argv in SPECS:
    del recorded[:]
    path = os.path.join(REPO, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location("jax_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    rc = 0
    with open(name + ".out", "w") as out, open(name + ".err", "w") as err:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                spec.loader.exec_module(mod)
                for key, value in consts.items():
                    setattr(mod, key, value)
                sys.argv = [path, *argv]
                mod.main()
            except BaseException:
                traceback.print_exc()
                rc = 1
    np.savez(name + ".npz", *recorded)
    with open(name + ".rc", "w") as f:
        f.write(str(rc))
"""


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The JAX side's working directory (``data/sift1m_synth``: 6,000 rows,
    48 queries from the port's writer) and the port's data dir beside it."""
    root = tmp_path_factory.mktemp("tuning")
    make_sift1m_surrogate.main(["--n", "6000", "--queries", "48",
                                "--out", str(root / "data" / "sift1m_synth")])
    (root / "pd").mkdir()
    os.symlink(root / "data" / "sift1m_synth", root / "pd" / "sift1m_synth")
    return root


@pytest.fixture(scope="module")
def jax_runs(workdir):
    """The JAX sides, all in one subprocess started once; ``result(name)``
    waits for that script: ``(stdout, [recorded arrays])``."""
    specs = [(name, consts, [*argv, *(["--platform", "cpu"] if name in PLATFORM else [])])
             for name, consts, argv in SPECS]
    with open(workdir / "runner.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_RUNNER, REPO, json.dumps(specs), json.dumps(CAP)],
            cwd=str(workdir), env=CPU_ENV, stdout=subprocess.DEVNULL, stderr=err)

    def result(name):
        rc_path = workdir / f"{name}.rc"
        deadline = time.monotonic() + 900
        while not rc_path.exists():
            if proc.poll() is not None and not rc_path.exists():
                raise AssertionError((workdir / "runner.err").read_text()[-3000:])
            assert time.monotonic() < deadline, f"{name}: no result after 900 s"
            time.sleep(0.2)
        assert rc_path.read_text() == "0", (workdir / f"{name}.out").read_text()[-3000:]
        with np.load(workdir / f"{name}.npz") as z:
            arrays = [z[f"arr_{i}"] for i in range(len(z.files))]
        return (workdir / f"{name}.out").read_text(), arrays

    yield result
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's k-means draws the JAX package's rows."""
    monkeypatch.setattr(kmeans, "_permutation", lambda n, seed: torch.from_numpy(
        np.asarray(jax.random.permutation(jax.random.PRNGKey(int(seed)), n)).astype(np.int64)))


def _port(name, monkeypatch, capsys, *extra):
    """The port's side of ``name`` under the spec's constants and options:
    ``(its lines but the check line, the check's numbers)``."""
    _, consts, argv = next(s for s in SPECS if s[0] == name)
    mod = PORT[name]
    for key, value in consts.items():
        monkeypatch.setattr(mod, key, value)
    capsys.readouterr()
    assert mod.main([*argv, *extra, "--device", "cpu"]) == 0
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


def _same_inputs(got, recorded, dtypes=None):
    """The port's inputs equal the JAX script's, after its dtype casts."""
    assert len(recorded) >= len(got)
    for i, (a, b) in enumerate(zip(got, recorded)):
        b = b.astype(dtypes[i]) if dtypes else b
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"input {i}")


# ---- the exact path -----------------------------------------------------------------


_WIDTH_LINE = r"  w=\s*(\d+)\s+[0-9.]+ ms/pass  \(\s*[0-9.]+ QPS\)  maxerr=(\S+)"


def test_blockmin_width_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_blockmin_width", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_blockmin_width")
    jl = jax_out.splitlines()
    heads = [ln for ln in port if ln.startswith("==")]
    assert heads == [ln for ln in jl if ln.startswith("==")] == [
        "== shape N=3000 d=16 B=8 k=5 chunk=262144", "== shape N=40000 d=8 B=4 k=10 chunk=262144"]
    prow = _fields([ln for ln in port if not ln.startswith("==")], _WIDTH_LINE)
    jrow = _fields([ln for ln in jl if not ln.startswith("==")], _WIDTH_LINE)
    assert [r[0] for r in prow] == [r[0] for r in jrow] == ["8", "16", "32"] * 2
    for (_, perr), (_, jerr) in zip(prow, jrow):
        assert float(perr) == float(jerr) == 0.0
    got = [*exp_blockmin_width.make_inputs(3000, 16, 8), *exp_blockmin_width.make_inputs(40000, 8, 4)]
    _same_inputs(got, arrays)
    for rows in check["shapes"].values():
        assert {w: (r["rel_err"], r["ids_agree"]) for w, r in rows.items()} == {
            w: (0.0, 1.0) for w in ("8", "16", "32")}


def test_flagship_w_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_flagship_w", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_flagship_w")
    line = r"w=\s*(\d+) slack=\s*(\d+)\s+\d+ QPS \(\s*[0-9.]+ ms/batch\)  max\|d err\|=(\S+)"
    prow, jrow = _fields(port, line), _fields(jax_out.splitlines(), line)
    assert [r[:2] for r in prow] == [r[:2] for r in jrow] == [
        (str(w), str(s)) for w, s in exp_flagship_w.SETTINGS]
    db, qs = exp_flagship_w.make_inputs()
    _same_inputs([db, qs], arrays)
    scale = float(np.max(np.sum((qs[0][:, None, :] - db[None, :, :]) ** 2, -1)))
    for p, j in zip(prow, jrow):
        assert float(p[2]) <= DIST_TOL * scale and float(j[2]) <= DIST_TOL * scale
    assert [r["recall"] for r in check["rows"].values()] == [1.0] * 5


def test_flagship_sweep_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_flagship_sweep", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_flagship_sweep")
    timed = r"(blockmin w=\s*\d+ reps=\d+)\s+[0-9.]+ ms/batch\s+\d+ QPS"
    agree = r"  ids agree w=8 vs w=(\d+): ([0-9.]+)"
    for pattern in (timed, agree):
        prow = _fields([ln for ln in port if re.fullmatch(pattern, ln)], pattern)
        jrow = _fields([ln for ln in jax_out.splitlines() if re.fullmatch(pattern, ln)], pattern)
        assert prow == jrow and len(prow) in (4, 6)
    assert len(port) == len(jax_out.splitlines()) == 10
    db, batches = exp_flagship_sweep.make_inputs()
    _same_inputs([db, *batches.values()], arrays)
    assert check["agree"] == {"20": {"16": 1.0, "32": 1.0}, "64": {"16": 1.0, "32": 1.0}}


def test_flagship_batch_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_flagship_batch", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_flagship_batch")
    prow = [json.loads(ln) for ln in port]
    jrow = [json.loads(ln) for ln in jax_out.splitlines()]
    assert [list(r) for r in prow] == [list(r) for r in jrow] == [["batch", "qps"]] * 3
    assert [r["batch"] for r in prow] == [r["batch"] for r in jrow] == [256, 512, 256]
    got = [a for batch in (256, 512, 256) for a in exp_flagship_batch.make_inputs(batch)]
    _same_inputs(got, arrays)
    assert [r["share"] for r in check["ids_agree"]] == [1.0] * 3


def test_flagship_profile_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_flagship_profile", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_flagship_profile")
    row = r"([a-g]\) .+?)\s+[0-9.]+ ms/batch\s+\d+ QPS"
    jl = jax_out.splitlines()
    assert _fields(port[:-1], row) == _fields(jl[:-1], row)
    assert len(port) == len(jl) == 8
    recall = r"   g recall vs exact: ([0-9.]+)"
    ((prec,),), ((jrec,),) = _fields(port[-1:], recall), _fields(jl[-1:], recall)
    assert abs(float(prec) - float(jrec)) <= 0.01 and check["g_recall"] == float(prec)
    _same_inputs(exp_flagship_profile.make_inputs(), arrays)
    assert check["a_ids_agree"] == 1.0


def test_blockmin_stages_match_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_blockmin_stages", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_blockmin_stages")
    row = r"(stage\d [a-z+_ ]+?)\s+[0-9.]+ ms/pass  \(\s*[0-9.]+ QPS\)"
    assert _fields(port, row) == _fields(jax_out.splitlines(), row) == [
        ("stage1 scan+blockmin",), ("stage2 +selection",), ("stage3 full exact_search",)]
    _same_inputs(exp_blockmin_stages.make_inputs(40000, 8, 8), arrays)
    assert check["stage3_ids_agree"] == 1.0


def test_topk_twolevel_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_topk_twolevel", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_topk_twolevel")
    jl = jax_out.splitlines()
    assert port[0] == jl[0] == "two-level == one-level (bit-exact values) at g in 8/16/32"
    row = r"(one-level top_k|two-level g=\d+)\s+[0-9.]+ ms/pass  \(checksum (\S+)\)"
    prow, jrow = _fields(port[1:], row), _fields(jl[1:], row)
    assert [r[0] for r in prow] == [r[0] for r in jrow] == [
        "one-level top_k", "two-level g=8", "two-level g=16", "two-level g=32", "two-level g=64"]
    _same_inputs([exp_topk_twolevel.make_input(8, 3000)], arrays, [np.float32])
    assert check["two_level_equal"] == {"8": True, "16": True, "32": True, "64": True}


# ---- the IVF fused stream --------------------------------------------------------------


def test_ivf_tail_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_ivf_tail", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_ivf_tail")
    row = r"([a-f]\. .+?)\s+[0-9.]+ ms/pass"
    assert _fields(port, row) == _fields(jax_out.splitlines(), row)
    assert len(port) == 6
    _same_inputs(list(exp_ivf_tail.make_inputs().values()), arrays)
    # ids below 65,536: the packed bf16 limbs are exact
    assert check == {"b_equals_c": True, "e_equals_f": True, "packed_ids_exact": 1.0}


def test_ivf_tail_packed_ids_round_above_a_bf16_limb():
    """A bf16 limb holds integers exactly up to 256: an id's high limb
    (id // 256) rounds once the id passes 65,536, as at the probe's 1.5M
    slot ids."""
    ids = torch.tensor([65_535, 65_536 + 256, 1_535_999], dtype=torch.float32)
    hi = torch.floor(ids / 256.0).to(torch.bfloat16)
    lo = torch.remainder(ids, 256.0).to(torch.bfloat16)
    back = hi.float() * 256.0 + lo.float()
    assert back.tolist()[0] == 65_535.0 and back.tolist()[1:] != ids.tolist()[1:]


def test_block_rescore_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_block_rescore", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_block_rescore")
    row = r"(\S+)\s+[0-9.]+ ms/pass   max\|err\|=(\S+) \(rel\)"
    prow, jrow = _fields(port, row), _fields(jax_out.splitlines(), row)
    assert [r[0] for r in prow] == [r[0] for r in jrow] == list(exp_block_rescore.VARIANTS)
    for (name, perr), (_, jerr) in zip(prow, jrow):
        assert abs(float(perr) - float(jerr)) <= RESCORE_TOL, name
        assert check["max_rel_err"][name] == pytest.approx(float(perr), rel=0.01)
    assert check["max_rel_err"]["a.diff-sum"] <= RESCORE_TOL
    _same_inputs(list(exp_block_rescore.make_inputs().values()), arrays)


def test_ivf_fused_profile_matches_jax(jax_runs, workdir, monkeypatch, capsys, jax_draws):
    port, check = _port("exp_ivf_fused_profile", monkeypatch, capsys,
                        "--data-dir", str(workdir / "pd"))
    jax_out, _ = jax_runs("exp_ivf_fused_profile")
    jl = jax_out.splitlines()
    assert port[0].startswith("build ") and jl[0].startswith("build ")
    layout = r"n_bkt=(\d+) L=(\d+) w=(\d+) budget=(\d+) bpb=(\d+)"
    (pl,), (jlay,) = _fields(port[1:2], layout), _fields(jl[1:2], layout)
    assert pl == jlay
    row = r"(\d [A-Za-z_+ ]+?)\s+[0-9.]+ ms/pass \(\s*\d+ QPS\)"
    assert _fields(port[2:], row) == _fields(jl[2:], row) == [
        ("1 probes",), ("2 +kernel",), ("3 +probed sel",), ("4 +block rescore",),
        ("5 FULL ivf_flat_search",)]
    assert check["full_ids_equal"] is True and check["recall"] >= 0.9


# ---- the cover tree -----------------------------------------------------------------------


def test_covertree_stream_profile_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_covertree_stream_profile", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_covertree_stream_profile")
    jl = jax_out.splitlines()
    assert port[0] == jl[0] == "shape: M=20000 d=8 B=8 k=10 kprime=266 chunks=5 depths=5"
    row = (r"(.+?)\s+[0-9.]+ ms total\s+[0-9.]+ ms/pass  -> \s*\d+ QPS  "
           r"\(checksum ([0-9.]+)\)")
    prow, jrow = _fields(port[1:], row), _fields(jl[1:], row)
    assert [r[0] for r in prow] == [r[0] for r in jrow] and len(prow) == 6
    for (name, p), (_, j) in zip(prow, jrow):
        assert float(p) == pytest.approx(float(j), rel=1e-3), name
    # the blockmin merges keep the full-width merge's kprime smallest bounds
    for rows in (prow, jrow):
        assert rows[2][1] == rows[3][1] == rows[1][1]
    assert check["rel_diff_to_fullwidth"] == {"blockmin16": 0.0, "blockmin64": 0.0}
    depth_sizes, got = exp_covertree_stream_profile.make_inputs(20000, 8, 8)
    _same_inputs(list(got.values()), arrays, [np.float32, np.float32, np.int32, np.float32])


def test_covertree_iter_cost_matches_jax(jax_runs, monkeypatch, capsys):
    port, check = _port("exp_covertree_iter_cost", monkeypatch, capsys)
    jax_out, arrays = jax_runs("exp_covertree_iter_cost")
    row = r"([a-h]2?\) .+?)\s+[0-9.]+ ms/iter"
    assert _fields(port, row) == _fields(jax_out.splitlines(), row)
    assert len(port) == 9
    got = list(exp_covertree_iter_cost.make_inputs().values())
    _same_inputs(got, arrays, [np.float32, np.float32, np.int32, np.int32, np.float32,
                               np.float32])
    assert check["finite_in_range"] is True and len(check["checksums"]) == 9


def test_covertree_blockwalk_matches_jax(jax_runs, workdir, monkeypatch, capsys):
    port, check = _port("exp_covertree_blockwalk", monkeypatch, capsys,
                        "--data-dir", str(workdir / "pd"))
    jax_out, _ = jax_runs("exp_covertree_blockwalk")
    jl = jax_out.splitlines()
    build = r"build [0-9.]+s nodes=(\d+)"
    assert _fields(port[:1], build) == _fields(jl[:1], build)
    row = r"(blockwalk|stream)\s+[0-9.]+ ms/pass \(\s*\d+ QPS\)  recall@10=([0-9.]+)"
    assert _fields(port[1:], row) == _fields(jl[1:], row) == [
        ("blockwalk", "1.0000"), ("stream", "1.0000")]
    assert [w["recall"] for w in check["walks"].values()] == [1.0, 1.0]


def test_covertree_profile_matches_jax(jax_runs, workdir, monkeypatch, capsys):
    init = TDataset.__init__

    def capped(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.options.update(CAP, use_cache=False)

    monkeypatch.setattr(TDataset, "__init__", capped)
    port, check = _port("exp_covertree_profile", monkeypatch, capsys,
                        "--data-dir", str(workdir / "pd"))
    jax_out, _ = jax_runs("exp_covertree_profile")
    jl = jax_out.splitlines()
    assert port[0] == jl[0] == ("dataset msmarco_surrogate: corpus (2000, 384) "
                                "queries (64, 384) metric cosine")
    assert port[2:4] == jl[2:4] and port[2].startswith("nodes M=")
    row = (r"stream kprime=\s*(\d+):\s+[0-9.]+ ms \(\s*[0-9.]+ QPS\)  depths=(\d+) "
           r"ndis/query=(\d+) overflow=(\d+)")
    assert _fields(port[4:8], row) == _fields(jl[4:8], row)
    assert port[8] == jl[8] == "recall@10 vs dataset GT: 1.0000"
    diff = r"max \|stream_d - exact_d\| over top-10: (\S+)"
    ((pd,),), ((jd,),) = _fields(port[9:], diff), _fields(jl[9:], diff)
    assert check["recall"] == 1.0 and check["max_rel_diff"] <= TREE_TOL
    assert float(jd) <= TREE_TOL * 2.0
    assert float(pd) == pytest.approx(check["max_abs_diff"], rel=0.01)
