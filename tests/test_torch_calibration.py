"""The port's calibration and data-making tools against the JAX package's
scripts, on the CPU: the surrogate calibrations (GloVe-50, MS MARCO,
manifold), the rotations A/B, the binary-LSH frontier, the SIFT1M surrogate
writer and the MS MARCO dataprep pipeline. Each case gives both the same seed
and options; the JAX scripts that do their work at import run as
subprocesses (``JAX_PLATFORMS=cpu``, ``--platform cpu``) from a temporary
directory, the others are loaded from ``scripts/`` by path; the port runs
with ``device="cpu"``.

The port's k-means draws its rows from a ``torch.Generator``, the JAX
package's from ``jax.random``; at these sizes the draws alone move an IVF
row's recall by more than 0.03. So every case that builds a k-means gives
the port the JAX package's draws (the ``jax_draws`` fixture: the port's
``kmeans._permutation`` returns ``jax.random.permutation``'s rows) and
compares the two builds of the same rows.

Tolerances: recalls within 0.03 (f32 sums in another order, ties; LSH
hashes with its own projections); corpora, SIFT surrogate files, samples
and synthetic embeddings bit for bit (both draw them with the same NumPy
calls); chip_smoke.py's NumPy ``jax_permutation`` bit for bit."""

import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

import chip_smoke
from vectordb_retrieval_tpu.data.datasets import Dataset as JDataset
from vectordb_retrieval_tpu_torch.data.datasets import Dataset as TDataset
from vectordb_retrieval_tpu_torch.ops import kmeans
from vectordb_retrieval_tpu_torch.scripts import (
    calibrate_glove_surrogate,
    calibrate_manifold,
    calibrate_msmarco_surrogate,
    exp_binary_lsh_tune,
    exp_manifold_rotations,
    make_sift1m_surrogate,
    prepare_msmarco,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_ENV = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
TOL = 0.03


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _start_jax(name, args, cwd):
    """A JAX script as a subprocess on the CPU, from ``cwd``, started so the
    port's side can run meanwhile; ``_finish`` waits for it."""
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", f"{name}.py"), *args],
        cwd=str(cwd), env=CPU_ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _finish(proc, check=True):
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if check:
        assert proc.returncode == 0, err[-3000:]
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _run_jax(name, args, cwd, check=True):
    return _finish(_start_jax(name, args, cwd), check)


def _start_jax_run_setting(name, cwd, *args, **opts):
    """``scripts/<name>.py``'s ``run_setting(*args, **opts)`` in a JAX
    subprocess on the CPU; ``_finish(...).stdout`` is its result as JSON."""
    code = (
        "import importlib.util, json, sys\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        f"spec = importlib.util.spec_from_file_location('j', {os.path.join(REPO, 'scripts', name + '.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"print(json.dumps(mod.run_setting(*{args!r}, **{opts!r})))\n"
    )
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(cwd), env=CPU_ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _jax_rows(n, seed):
    return torch.from_numpy(
        np.asarray(jax.random.permutation(jax.random.PRNGKey(int(seed)), n)).astype(np.int64))


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's k-means draws the JAX package's rows."""
    monkeypatch.setattr(kmeans, "_permutation", _jax_rows)


@pytest.mark.parametrize("n,seed", [(1, 3), (256, 123), (3000, 7), (65_536, 123),
                                    (100_000, 123 ^ 0x5EED)])
def test_chip_smoke_draws_are_jax_permutations(n, seed):
    np.testing.assert_array_equal(chip_smoke.jax_permutation(n, seed), _jax_rows(n, seed).numpy())


def _json_lines(text, prefix):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith(prefix)]


def _assert_recalls_near(got, want):
    assert set(got) == set(want)
    diff = {k: abs(got[k] - want[k]) for k in want}
    assert max(diff.values()) <= TOL, (got, want)


# ---- GloVe-50 surrogate --------------------------------------------------------


def test_glove_run_setting_matches_jax_on_the_defaults(tmp_path, jax_draws):
    jax_proc = _start_jax_run_setting("calibrate_glove_surrogate", tmp_path, train_limit=3000)
    port_rec = calibrate_glove_surrogate.run_setting("cpu", train_limit=3000)
    _assert_recalls_near(port_rec, json.loads(_finish(jax_proc).stdout))
    assert calibrate_glove_surrogate.TARGETS == _jax_script("calibrate_glove_surrogate").TARGETS


def test_glove_main_prints_every_setting_and_the_best(monkeypatch, capsys):
    """The CLI's lines: header, reference, one line a setting (the defaults
    first), the best setting; shrunk through run_setting's options."""
    calls = []
    orig = calibrate_glove_surrogate.run_setting

    def small(device, **opts):
        calls.append(opts)
        return orig(device, train_limit=600, test_size=32, **opts)

    monkeypatch.setattr(calibrate_glove_surrogate, "run_setting", small)
    monkeypatch.setattr(calibrate_glove_surrogate, "ALGOS",
                        {k: calibrate_glove_surrogate.ALGOS[k] for k in ("ivf_flat", "ivf_sq8")})
    monkeypatch.setattr(calibrate_glove_surrogate, "TARGETS",
                        {k: calibrate_glove_surrogate.TARGETS[k] for k in ("ivf_flat", "ivf_sq8")})
    assert calibrate_glove_surrogate.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert calls == calibrate_glove_surrogate.SETTINGS and calls[0] == {}
    assert lines[1].startswith("REFERENCE (real glove50)")
    rows = [ln for ln in lines if "maxerr=" in ln]
    assert len(rows) == 5 and rows[0].startswith("(defaults)")
    assert lines[-1].startswith("best: ")


# ---- MS MARCO surrogate ---------------------------------------------------------


GRID_SPEC = "anisotropy=0.6:child_scale=0.9:point_scale=0.55:zipf=0.9"


def test_msmarco_corpora_are_bit_identical_under_the_grid_knobs():
    (opts,) = calibrate_msmarco_surrogate.parse_grid(GRID_SPEC)
    base = {"train_limit": 2000, "test_size": 50, "ground_truth_k": 20, "use_cache": False}
    for knobs in ({}, opts):
        jds = JDataset("msmarco_surrogate", "data", dict(base, **knobs)).load()
        tds = TDataset("msmarco_surrogate", "data", dict(base, **knobs), device="cpu").load()
        np.testing.assert_array_equal(tds.train_vectors, np.asarray(jds.train_vectors))
        np.testing.assert_array_equal(tds.test_vectors, np.asarray(jds.test_vectors))


@pytest.mark.parametrize("spec,algos", [("", None), (GRID_SPEC, ("ivf_flat", "ivf_sq8", "hnsw"))])
def test_msmarco_run_setting_matches_jax(spec, algos, tmp_path, jax_draws):
    opts = calibrate_msmarco_surrogate.parse_grid(spec)[0] if spec else {}
    jax_proc = _start_jax_run_setting("calibrate_msmarco_surrogate", tmp_path, 5000, algos,
                                      **opts)
    port_rec = calibrate_msmarco_surrogate.run_setting(5000, algos, device="cpu", **opts)
    _assert_recalls_near(port_rec, json.loads(_finish(jax_proc).stdout))


def test_msmarco_grid_parses_like_jax(tmp_path):
    """Both spellings of --grid and the default grid, through each CLI's
    own parser (run_setting stubbed: the grid only)."""
    seen = []
    jmod = _jax_script("calibrate_msmarco_surrogate")
    for mod in (jmod, calibrate_msmarco_surrogate):
        got = []

        def fake(n, algos_filter=None, device=None, _got=got, **opts):
            _got.append((n, algos_filter, opts))
            return {"ivf_flat": 0.9}

        orig = mod.run_setting
        mod.run_setting = fake
        argv = sys.argv
        try:
            for args in (["--grid", "0.4:0.7:0.5:1.1:0.8," + GRID_SPEC, "--algos", "ivf_flat"],
                         ["--quick", "--n", "77"], []):
                if mod is jmod:
                    sys.argv = ["x", *args]
                    mod.main()
                else:
                    mod.main([*args, "--device", "cpu"])
        finally:
            mod.run_setting = orig
            sys.argv = argv
        seen.append(got)
    assert seen[0] == seen[1]
    assert len(seen[0]) == 2 + 1 + 18
    assert seen[0][0][2] == {"anisotropy": 0.4, "child_scale": 0.7, "point_scale": 0.5,
                             "query_scale": 1.1, "zipf": 0.8}


# ---- manifold ------------------------------------------------------------------


def test_manifold_grid_matches_jax(tmp_path, capsys, jax_draws):
    grid = json.dumps({"intrinsic_dim": [12], "point_scale": [0.35, 0.7], "dim": [128],
                       "n_patches": [128]})
    args = ["--n", "3000", "--queries", "128", "--grid", grid]
    jax_proc = _start_jax("calibrate_manifold", ["--platform", "cpu", *args], tmp_path)
    assert calibrate_manifold.main([*args, "--data-dir", str(tmp_path / "p"),
                                    "--device", "cpu"]) == 0
    port = _json_lines(capsys.readouterr().out, '{"opts"')
    jax = _json_lines(_finish(jax_proc).stdout, '{"opts"')
    assert [p["opts"] for p in port] == [j["opts"] for j in jax] and len(port) == 2
    for p, j in zip(port, jax):
        assert set(p) == set(j)
        _assert_recalls_near({k: p[k] for k in ("pq", "ivf_pq")},
                             {k: j[k] for k in ("pq", "ivf_pq")})
        assert p["gap"] == round(p["pq"] - p["ivf_pq"], 4)
    assert calibrate_manifold.GRID == {"intrinsic_dim": [8, 12, 16],
                                       "point_scale": [0.35, 0.5, 0.7]}


# ---- rotations A/B ---------------------------------------------------------------


def test_rotations_document_matches_jax(tmp_path, jax_draws):
    """At 3,000 rows and IVF4,PQ8 the manifold's rotation gain is ~0.5 and
    the surrogate's ~0, far on either side of the 0.05 threshold: both
    packages must take the same decisions, ON and OFF."""
    args = ["--n", "3000", "--queries", "256", "--index-key", "IVF4,PQ8", "--nprobe", "2",
            "--rot-bs", "128"]
    jax_proc = _start_jax("exp_manifold_rotations", ["--platform", "cpu", *args, "--out",
                                                     str(tmp_path / "j" / "ab.json")], tmp_path)
    assert exp_manifold_rotations.main([*args, "--out", str(tmp_path / "p" / "ab.json"),
                                        "--data-dir", str(tmp_path / "pd"),
                                        "--device", "cpu"]) == 0
    _finish(jax_proc)
    with open(tmp_path / "j" / "ab.json") as f:
        jdoc = json.load(f)
    with open(tmp_path / "p" / "ab.json") as f:
        tdoc = json.load(f)
    assert list(tdoc["regimes"]) == list(jdoc["regimes"]) == ["manifold", "msmarco_surrogate"]
    for regime, jreg in jdoc["regimes"].items():
        treg = tdoc["regimes"][regime]
        assert treg["note"] == jreg["note"]
        assert list(treg["rows"]) == list(jreg["rows"]) == ["plain", "auto", "rot128"]
        for variant, jrow in jreg["rows"].items():
            trow = treg["rows"][variant]
            assert set(trow) == set(jrow)
            assert trow["rot_enabled"] == jrow["rot_enabled"]
            assert abs(trow["recall"] - jrow["recall"]) <= TOL, (regime, variant, trow, jrow)
            if variant == "auto":
                assert set(trow["pq_rot_auto"]) == set(jrow["pq_rot_auto"])
                assert trow["pq_rot_auto"]["enabled"] == jrow["pq_rot_auto"]["enabled"]
    assert [tdoc["regimes"][r]["rows"]["auto"]["pq_rot_auto"]["enabled"]
            for r in ("manifold", "msmarco_surrogate")] == [True, False]


# ---- binary LSH -------------------------------------------------------------------


def test_binary_lsh_frontier_matches_jax(tmp_path, capsys):
    args = ["--dataset", "random", "--num-bits", "256", "--mults", "16,128", "--iters", "1"]
    jax_proc = _start_jax("exp_binary_lsh_tune", ["--platform", "cpu", *args, "--out",
                                                  str(tmp_path / "j.json")], tmp_path)
    assert exp_binary_lsh_tune.main([*args, "--out", str(tmp_path / "p.json"),
                                     "--data-dir", str(tmp_path / "pd"), "--device", "cpu"]) == 0
    _finish(jax_proc)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == ["mult    16", "mult   128"]
    with open(tmp_path / "j.json") as f:
        jdoc = json.load(f)
    with open(tmp_path / "p.json") as f:
        tdoc = json.load(f)
    assert {k: v for k, v in tdoc.items() if k != "rows"} == \
        {k: v for k, v in jdoc.items() if k != "rows"}
    assert list(tdoc["rows"]) == list(jdoc["rows"]) == ["16", "128"]
    for mult, jrow in jdoc["rows"].items():
        assert abs(tdoc["rows"][mult]["recall"] - jrow["recall"]) <= TOL, (mult, tdoc, jdoc)
        assert tdoc["rows"][mult]["qps"] > 0
    assert json.loads(lines[2]) == tdoc


# ---- SIFT1M surrogate ---------------------------------------------------------------


@pytest.mark.parametrize("n,queries,seed", [(3000, 16, 20), (1200, 7, 3)])
def test_sift_surrogate_files_are_byte_identical(tmp_path, n, queries, seed, capsys):
    args = ["--n", str(n), "--queries", str(queries), "--seed", str(seed)]
    _run_jax("make_sift1m_surrogate", [*args, "--out", str(tmp_path / "j")], tmp_path)
    assert make_sift1m_surrogate.main([*args, "--out", str(tmp_path / "p")]) == 0
    assert "wrote" in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p")) == [
        "PROVENANCE.json", "sift_base.fvecs", "sift_query.fvecs"]
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert (tmp_path / "p" / "sift_base.fvecs").stat().st_size == n * 129 * 4


# ---- MS MARCO dataprep pipeline ----------------------------------------------------------


def _prep_config(tmp_path, tag, **overrides):
    raw = tmp_path / "raw"
    if not raw.exists():
        raw.mkdir()
        for name, prefix, rows in (("corpus", "d", 300), ("queries", "q", 60)):
            with open(raw / f"{name}.tsv", "w") as f:
                f.writelines(f"{prefix}{i}\ttext {i}\twith a tab\n" for i in range(rows))
    cfg = {
        "subsample": {"output_dir": str(tmp_path / tag / "subset"), "corpus_sample": 120,
                      "query_sample": 25, "seed": 5, "corpus_tsv": str(raw / "corpus.tsv"),
                      "queries_tsv": str(raw / "queries.tsv")},
        "embed": {"input_dir": str(tmp_path / tag / "subset"),
                  "output_dir": str(tmp_path / tag / "emb"), "synthetic": True, "seed": 9},
    }
    for key, value in overrides.items():
        section, field = key.split("__")
        cfg[section][field] = value
    path = tmp_path / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_prepare_msmarco_matches_jax(tmp_path, capsys):
    _run_jax("prepare_msmarco", ["--config", _prep_config(tmp_path, "j")], tmp_path)
    assert prepare_msmarco.main(["--config", _prep_config(tmp_path, "p"), "--device", "cpu"]) == 0
    assert "subsampled 120 passages, 25 queries" in capsys.readouterr().out
    for name in ("corpus.tsv", "queries.tsv"):
        assert (tmp_path / "p" / "subset" / name).read_bytes() == \
            (tmp_path / "j" / "subset" / name).read_bytes()
    # the sampled ids equal, the synthetic embeddings bit for bit (tolerance 0)
    for name, shape in (("passage_ids", (120,)), ("query_ids", (25,)),
                        ("passage_embeddings", (120, 384)), ("query_embeddings", (25, 384))):
        got = np.load(tmp_path / "p" / "emb" / f"{name}.npy")
        assert got.shape == shape
        np.testing.assert_array_equal(got, np.load(tmp_path / "j" / "emb" / f"{name}.npy"))
    assert (tmp_path / "p" / "emb" / "metadata.json").read_text() == \
        (tmp_path / "j" / "emb" / "metadata.json").read_text()


@pytest.mark.parametrize("override,message", [
    ({"subsample__corpus_tsv": ""}, "ir_datasets"),
    ({"subsample__queries_tsv": ""}, "ir_datasets"),
    ({"embed__synthetic": False}, "weights"),
])
def test_prepare_msmarco_refuses_a_download_before_writing(tmp_path, override, message):
    cfg = _prep_config(tmp_path, "p", **override)
    with pytest.raises(SystemExit, match=message):
        prepare_msmarco.main(["--config", cfg, "--device", "cpu"])
    assert not (tmp_path / "p").exists()


# ---- CLI errors ---------------------------------------------------------------------------


def test_msmarco_unknown_knob_fails_like_jax(tmp_path):
    with pytest.raises(SystemExit, match=r"unknown surrogate knobs: \['bogus'\]"):
        _jax_script("calibrate_msmarco_surrogate").run_setting(100, bogus=1.0)
    with pytest.raises(SystemExit, match=r"unknown surrogate knobs: \['bogus'\]"):
        calibrate_msmarco_surrogate.run_setting(100, device="cpu", bogus=1.0)
    with pytest.raises(SystemExit, match=r"unknown surrogate knobs: \['bogus'\]"):
        calibrate_msmarco_surrogate.main(["--grid", "anisotropy=0.4:bogus=1",
                                          "--device", "cpu"])
    proc = _run_jax("calibrate_msmarco_surrogate",
                    ["--platform", "cpu", "--grid", "anisotropy=0.4:bogus=1"], tmp_path,
                    check=False)
    assert proc.returncode == 1 and "unknown surrogate knobs: ['bogus']" in proc.stderr


@pytest.mark.parametrize("name,args,error", [
    ("calibrate_manifold", ["--grid", "{intrinsic_dim: [12]}"], json.JSONDecodeError),
    ("exp_manifold_rotations", ["--n", "600", "--queries", "8", "--index-key", "IVF8,Bogus"],
     ValueError),
    ("calibrate_msmarco_surrogate", ["--grid", "0.4:0.7"], IndexError),
])
def test_bad_arguments_fail_like_jax(tmp_path, name, args, error):
    """The same bad argument fails both CLIs with the same exception."""
    proc = _run_jax(name, ["--platform", "cpu", *args], tmp_path, check=False)
    assert proc.returncode == 1 and error.__name__ in proc.stderr, proc.stderr[-2000:]
    mod = importlib.import_module(f"vectordb_retrieval_tpu_torch.scripts.{name}")
    with pytest.raises(error):
        mod.main([*args, "--data-dir", str(tmp_path / "p"), "--device", "cpu"]
                 if name != "calibrate_msmarco_surrogate" else [*args, "--device", "cpu"])


def test_binary_lsh_unknown_dataset_fails(tmp_path):
    """The JAX script fails on the unknown dataset with a KeyError; the
    port's parser names the choices."""
    proc = _run_jax("exp_binary_lsh_tune", ["--platform", "cpu", "--dataset", "bogus"],
                    tmp_path, check=False)
    assert proc.returncode == 1 and "KeyError: 'bogus'" in proc.stderr
    with pytest.raises(SystemExit) as exc:
        exp_binary_lsh_tune.main(["--dataset", "bogus", "--device", "cpu"])
    assert exc.value.code == 2


def test_sift_surrogate_bad_count_fails_like_jax(tmp_path):
    proc = _run_jax("make_sift1m_surrogate", ["--n", "many", "--out", str(tmp_path / "j")],
                    tmp_path, check=False)
    assert proc.returncode == 2 and "invalid int value" in proc.stderr
    with pytest.raises(SystemExit) as exc:
        make_sift1m_surrogate.main(["--n", "many", "--out", str(tmp_path / "p")])
    assert exc.value.code == 2
    assert not (tmp_path / "j").exists() and not (tmp_path / "p").exists()
