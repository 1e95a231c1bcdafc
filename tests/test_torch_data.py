"""The port's data layer (data/native_io.py, data/tfidf.py and the loaders of
data/datasets.py) against the JAX package's.

The same files, written here from a seed, are read by both packages on the
CPU. Vectors must be bit-identical (the readers and generators are the same
NumPy arithmetic); ground truth must be equal where no two rows tie (the
SIFT surrogate's integer rows tie exactly, and tie order is not part of
ground truth). No test touches the network: downloads are monkeypatched.
"""

import io
import os
import subprocess
import sys
import tarfile
import zipfile

import numpy as np
import pytest
import torch

from vectordb_retrieval_tpu.data import datasets as jdata
from vectordb_retrieval_tpu.data import tfidf as jtfidf
from vectordb_retrieval_tpu.data.dataprep.embed_msmarco import read_tsv as jax_read_tsv
from vectordb_retrieval_tpu_torch.data import datasets as tdata
from vectordb_retrieval_tpu_torch.data import native_io
from vectordb_retrieval_tpu_torch.data import tfidf as ttfidf

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_vecs(path, mat):
    n, d = mat.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = mat.view(np.int32)
    out.tofile(path)


def _fvecs_rows(rng, n=257, d=24):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[0, :4] = [np.inf, -np.inf, -0.0, np.float32(1e-40)]  # specials and a subnormal
    return x


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """``native/vrt_io.cpp`` built with the flags of ``native/Makefile`` into
    a temporary directory (the repo's ``native/libvrt_io.so`` is a build
    output, absent from a fresh checkout)."""
    out = tmp_path_factory.mktemp("native") / "libvrt_io.so"
    cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
           os.path.join(REPO, "native", "vrt_io.cpp"), "-o", str(out)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.CalledProcessError) as exc:
        pytest.skip(f"cannot build native/vrt_io.cpp here: {exc}")
    return str(out)


@pytest.fixture
def use_native(native_lib, monkeypatch):
    monkeypatch.setattr(native_io, "_LIB_PATHS", (native_lib,))
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_load_attempted", False)
    assert native_io.available()


@pytest.fixture
def numpy_only(monkeypatch):
    monkeypatch.setattr(native_io, "_LIB_PATHS", ())
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_load_attempted", False)
    assert not native_io.available()


@pytest.mark.parametrize("limit", [None, 10, 10_000])
def test_read_fvecs_ivecs_numpy_path_bit_identical(limit, numpy_only, tmp_path, rng):
    x = _fvecs_rows(rng)
    iv = rng.integers(-(2**31), 2**31 - 1, size=(64, 8)).astype(np.int32)
    _write_vecs(tmp_path / "a.fvecs", x)
    _write_vecs(tmp_path / "a.ivecs", iv)
    got = tdata.read_fvecs(str(tmp_path / "a.fvecs"), limit)
    want = jdata.read_fvecs(str(tmp_path / "a.fvecs"), limit)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(tdata.read_ivecs(str(tmp_path / "a.ivecs"), limit),
                                  jdata.read_ivecs(str(tmp_path / "a.ivecs"), limit))


@pytest.mark.parametrize("limit", [None, 10, 10_000])
def test_read_fvecs_ivecs_native_path_bit_identical(limit, use_native, tmp_path, rng):
    x = _fvecs_rows(rng)
    iv = rng.integers(0, 1000, size=(64, 8)).astype(np.int32)
    _write_vecs(tmp_path / "a.fvecs", x)
    _write_vecs(tmp_path / "a.ivecs", iv)
    got = tdata.read_fvecs(str(tmp_path / "a.fvecs"), limit)
    want = jdata.read_fvecs(str(tmp_path / "a.fvecs"), limit)  # NumPy: no library here
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(tdata.read_ivecs(str(tmp_path / "a.ivecs"), limit),
                                  jdata.read_ivecs(str(tmp_path / "a.ivecs"), limit))
    assert native_io.vecs_shape(str(tmp_path / "a.fvecs")) == x.shape


def _corrupt(path):
    good = np.array([4], np.int32).tobytes() + np.zeros(4, np.float32).tobytes()
    bad = np.array([5], np.int32).tobytes() + np.zeros(4, np.float32).tobytes()
    path.write_bytes(good + bad + good)


def test_corrupt_header_raises_in_both(numpy_only, tmp_path):
    p = tmp_path / "bad.fvecs"
    _corrupt(p)
    with pytest.raises(ValueError, match="inconsistent"):
        tdata.read_fvecs(str(p))
    with pytest.raises(ValueError, match="inconsistent"):
        jdata.read_fvecs(str(p))


def test_corrupt_header_raises_natively(use_native, tmp_path):
    p = tmp_path / "bad.fvecs"
    _corrupt(p)
    with pytest.raises(IOError):
        tdata.read_fvecs(str(p))


def test_native_io_raises_without_the_library(numpy_only, tmp_path):
    with pytest.raises(RuntimeError, match="make -C native"):
        native_io.read_fvecs(str(tmp_path / "x.fvecs"))


@pytest.mark.parametrize("native", [False, True])
def test_stream_chunks_roundtrip(native, request, tmp_path, rng):
    request.getfixturevalue("use_native" if native else "numpy_only")
    data = rng.integers(0, 256, size=100_000).astype(np.uint8)
    p = tmp_path / "blob.bin"
    p.write_bytes(data.tobytes())
    got = np.concatenate(list(native_io.stream_chunks(str(p), chunk_bytes=8192)))
    np.testing.assert_array_equal(got, data)
    tail = np.concatenate(list(native_io.stream_chunks(str(p), chunk_bytes=4096, offset=99_000)))
    np.testing.assert_array_equal(tail, data[99_000:])


# -- sift1m ------------------------------------------------------------------


@pytest.fixture(scope="module")
def sift_dir(tmp_path_factory):
    """A small SIFT1M surrogate written by ``scripts/make_sift1m_surrogate.py``."""
    root = tmp_path_factory.mktemp("sift")
    out = root / "sift1m_synth"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_sift1m_surrogate.py"),
         "--n", "5000", "--queries", "32", "--out", str(out)],
        check=True, capture_output=True, timeout=300,
    )
    return root


def _both(name, data_dir, options, **port_kw):
    opts = dict(options, use_cache=False)
    jds = jdata.Dataset(name, str(data_dir), dict(opts)).load()
    tds = tdata.Dataset(name, str(data_dir), dict(opts), device="cpu", **port_kw).load()
    return jds, tds


def _sqdist(x, q):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    return ((q64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)


def _assert_gt_equal_where_untied(got, want, x, q):
    """Rows whose k-th and (k+1)-th distances differ must hold the same id
    set; every row must point at the same sorted distances."""
    dist = _sqdist(x, q)
    k = got.shape[1]
    sorted_d = np.sort(dist, axis=1)
    untied = sorted_d[:, k - 1] < sorted_d[:, k]
    for i in range(len(q)):
        np.testing.assert_array_equal(np.sort(dist[i, got[i]]), np.sort(dist[i, want[i]]))
        if untied[i]:
            assert set(got[i]) == set(want[i])
    return int((~untied).sum())


def test_sift1m_surrogate_loader_matches_jax(sift_dir, numpy_only):
    opts = {"subdir": "sift1m_synth", "test_size": 32, "ground_truth_k": 10}
    jds, tds = _both("sift1m", sift_dir, opts)
    assert tds.train_vectors.tobytes() == jds.train_vectors.tobytes()
    assert tds.test_vectors.tobytes() == jds.test_vectors.tobytes()
    assert tds.train_vectors.shape == (5000, 128) and tds.test_vectors.shape == (32, 128)
    for key in ("surrogate", "surrogate_for", "n_train", "n_test", "dimensions",
                "ground_truth_k", "metric"):
        assert tds.metadata[key] == jds.metadata[key], key
    assert tds.metadata["surrogate"] is True
    _assert_gt_equal_where_untied(tds.ground_truth, jds.ground_truth,
                                  tds.train_vectors, tds.test_vectors)


def test_sift1m_loader_base_limit_and_native_reader(sift_dir, use_native):
    opts = {"subdir": "sift1m_synth", "test_size": 16, "ground_truth_k": 5,
            "base_limit": 3000}
    jds, tds = _both("sift1m", sift_dir, opts)
    assert tds.train_vectors.shape == (3000, 128)
    assert tds.train_vectors.tobytes() == jds.train_vectors.tobytes()
    _assert_gt_equal_where_untied(tds.ground_truth, jds.ground_truth,
                                  tds.train_vectors, tds.test_vectors)


def test_sift1m_surrogate_label_from_the_directory_name(tmp_path, rng, numpy_only):
    """No PROVENANCE.json: a ``*synth*`` directory is labelled surrogate, any
    other is not."""
    x = rng.integers(0, 50, size=(300, 8)).astype(np.float32)
    for sub, labelled in (("my_synth", True), ("sift1m", False)):
        os.makedirs(tmp_path / sub)
        _write_vecs(tmp_path / sub / "sift_base.fvecs", x)
        _write_vecs(tmp_path / sub / "sift_query.fvecs", x[:4] + 0.5)
        jds, tds = _both("sift1m", tmp_path, {"subdir": sub, "ground_truth_k": 3})
        assert tds.metadata.get("surrogate", False) is labelled
        assert tds.metadata.get("surrogate") == jds.metadata.get("surrogate")


@pytest.fixture
def texmex_dir(tmp_path, rng):
    """Real-SIFT layout with a TEXMEX ground-truth file (a marker pattern,
    so reading it is visible)."""
    root = tmp_path / "sift1m"
    os.makedirs(root)
    x = rng.integers(0, 100, size=(400, 16)).astype(np.float32)
    q = rng.integers(0, 100, size=(12, 16)).astype(np.float32) + 0.25
    _write_vecs(root / "sift_base.fvecs", x)
    _write_vecs(root / "sift_query.fvecs", q)
    gt = (np.arange(12 * 20, dtype=np.int32).reshape(12, 20) * 7) % 400
    _write_vecs(root / "sift_groundtruth.ivecs", gt)
    return tmp_path, gt


@pytest.mark.parametrize("case", ["read", "base_limit", "metric_ip", "too_narrow"])
def test_sift1m_texmex_ground_truth_rule(case, texmex_dir, numpy_only):
    """The TEXMEX file is read only for l2, with no base_limit, when it is
    wide enough; otherwise ground truth is computed, in both packages."""
    root, gt = texmex_dir
    opts = {"ground_truth_k": 10, "test_size": 12}
    if case == "base_limit":
        opts["base_limit"] = 300
    elif case == "metric_ip":
        opts["metric"] = "ip"
    elif case == "too_narrow":
        opts["ground_truth_k"] = 25
    jds, tds = _both("sift1m", root, opts)
    assert tds.ground_truth.dtype == np.int64
    if case == "read":
        np.testing.assert_array_equal(tds.ground_truth, gt[:, :10])
    else:
        assert not np.array_equal(tds.ground_truth[:, :10], gt[:, :10])
    if case == "metric_ip":
        dots = tds.test_vectors.astype(np.float64) @ tds.train_vectors.astype(np.float64).T
        for i in range(len(dots)):
            np.testing.assert_array_equal(np.sort(dots[i, tds.ground_truth[i]]),
                                          np.sort(dots[i, jds.ground_truth[i]]))
    else:
        _assert_gt_equal_where_untied(tds.ground_truth, jds.ground_truth,
                                      tds.train_vectors, tds.test_vectors)


# -- glove50 and its surrogate ---------------------------------------------------


def test_glove50_surrogate_bit_identical(tmp_path):
    opts = {"train_limit": 2000, "test_size": 64, "ground_truth_k": 20}
    jds, tds = _both("glove50_surrogate", tmp_path, opts)
    assert tds.train_vectors.tobytes() == jds.train_vectors.tobytes()
    assert tds.test_vectors.tobytes() == jds.test_vectors.tobytes()
    np.testing.assert_array_equal(tds.ground_truth, jds.ground_truth)
    assert tds.metadata["surrogate_for"] == jds.metadata["surrogate_for"] == "glove50"


def test_glove50_surrogate_options_bit_identical(tmp_path):
    opts = {"train_limit": 600, "test_size": 20, "ground_truth_k": 5, "seed": 3,
            "anisotropy": 0.4, "background_frac": 0.1, "n_parents": 20}
    jds, tds = _both("glove50_surrogate", tmp_path, opts)
    assert tds.train_vectors.tobytes() == jds.train_vectors.tobytes()
    np.testing.assert_array_equal(tds.ground_truth, jds.ground_truth)


def _write_glove(path, n=300, dim=50, seed=0):
    mat = np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)
    with open(path, "w", encoding="utf-8") as f:
        for i, row in enumerate(mat):
            f.write(f"word{i} " + " ".join(f"{v:.5f}" for v in row) + "\n")


@pytest.mark.parametrize("train_limit", [None, 200])
def test_glove50_text_loader_matches_jax(train_limit, tmp_path):
    path = tmp_path / "glove.6B.50d.txt"
    _write_glove(str(path))
    opts = {"glove_path": str(path), "test_size": 32, "ground_truth_k": 10, "seed": 4}
    if train_limit:
        opts["train_limit"] = train_limit
    jds, tds = _both("glove50", tmp_path / "data", opts)
    assert tds.train_vectors.shape == jds.train_vectors.shape
    assert tds.train_vectors.tobytes() == jds.train_vectors.tobytes()
    assert tds.test_vectors.tobytes() == jds.test_vectors.tobytes()
    np.testing.assert_array_equal(tds.ground_truth, jds.ground_truth)


# -- msmarco (pre-embedded and TF-IDF) ----------------------------------------------


@pytest.fixture
def msmarco_dir(tmp_path, rng):
    p = rng.standard_normal((500, 32)).astype(np.float32)
    q = rng.standard_normal((20, 32)).astype(np.float32)
    np.save(tmp_path / "passage_embeddings.npy", p)
    np.save(tmp_path / "query_embeddings.npy", q)
    return tmp_path


@pytest.mark.parametrize("limits", [{}, {"base_limit": 300, "query_limit": 8}])
def test_msmarco_npy_loader_matches_jax(limits, msmarco_dir):
    opts = dict(limits, embedded_dataset_dir=str(msmarco_dir), use_memmap_cache=False,
                ground_truth_k=10)
    jds, tds = _both("msmarco", msmarco_dir / "data", opts)
    assert tds.metric == jds.metric == "cosine"
    assert tds.train_vectors.tobytes() == jds.train_vectors.tobytes()
    assert tds.test_vectors.tobytes() == jds.test_vectors.tobytes()
    np.testing.assert_array_equal(tds.ground_truth, jds.ground_truth)


def test_msmarco_memmap_default_waits_for_item_9b(msmarco_dir):
    ds = tdata.Dataset("msmarco", str(msmarco_dir / "data"),
                       {"embedded_dataset_dir": str(msmarco_dir), "use_cache": False},
                       device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9b"):
        ds.load()


def test_msmarco_requires_a_source(tmp_path):
    with pytest.raises(ValueError, match="embedded_dataset_dir"):
        tdata.Dataset("msmarco", str(tmp_path), {"use_cache": False}, device="cpu").load()
    with pytest.raises(ValueError, match="corpus_tsv"):
        tdata.Dataset("msmarco", str(tmp_path), {"use_cache": False, "use_tfidf": True},
                      device="cpu").load()


_DOCS = [
    "the quick brown fox jumps over the lazy dog",
    "a fast auburn fox leaped above a sleepy canine",
    "stock markets rallied as tech shares surged today",
    "bond yields fell while equity markets were volatile",
    "the dog slept in the sun all afternoon",
    "Ünïcode tokens, digits 123 and punctuation!!",
] * 7


def _write_tsv(path, texts):
    with open(path, "w", encoding="utf-8") as f:
        f.write("no tab on this line\n")
        for i, t in enumerate(texts):
            f.write(f"{i}\t{t} {i}\n")


def test_read_tsv_and_texts_to_vectors_bit_identical(tmp_path):
    _write_tsv(tmp_path / "c.tsv", _DOCS)
    got, want = ttfidf.read_tsv(str(tmp_path / "c.tsv")), jax_read_tsv(str(tmp_path / "c.tsv"))
    assert got == want and len(got[1]) == len(_DOCS)
    for dim, n_features, seed in ((16, 64, 0), (48, 4096, 7)):
        a, va = ttfidf.texts_to_vectors(got[1], dim=dim, n_features=n_features, seed=seed)
        b, vb = jtfidf.texts_to_vectors(got[1], dim=dim, n_features=n_features, seed=seed)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        qa, _ = ttfidf.texts_to_vectors(_DOCS[:3], dim=dim, seed=seed, vectorizer=va)
        qb, _ = jtfidf.texts_to_vectors(_DOCS[:3], dim=dim, seed=seed, vectorizer=vb)
        assert qa.tobytes() == qb.tobytes()


def test_msmarco_tfidf_loader_matches_jax(tmp_path):
    _write_tsv(tmp_path / "corpus.tsv", _DOCS)
    _write_tsv(tmp_path / "queries.tsv", _DOCS[:5])
    opts = {"use_tfidf": True, "corpus_tsv": str(tmp_path / "corpus.tsv"),
            "queries_tsv": str(tmp_path / "queries.tsv"), "dimensions": 24,
            "ground_truth_k": 5, "base_limit": 30, "query_limit": 4}
    jds, tds = _both("msmarco", tmp_path / "data", opts)
    assert tds.train_vectors.shape == (30, 24) and tds.test_vectors.shape == (4, 24)
    assert tds.train_vectors.tobytes() == jds.train_vectors.tobytes()
    assert tds.test_vectors.tobytes() == jds.test_vectors.tobytes()
    # repeated documents tie exactly: compare the neighbours' similarities
    sims = tds.test_vectors.astype(np.float64) @ tds.train_vectors.astype(np.float64).T
    for i in range(4):
        np.testing.assert_allclose(np.sort(sims[i, tds.ground_truth[i]]),
                                   np.sort(sims[i, jds.ground_truth[i]]), rtol=1e-6)


# -- missing files and downloads -------------------------------------------------


def _no_network(url, dest):
    raise OSError(f"no network for {url}")


@pytest.mark.parametrize("name", ["sift1m", "glove50"])
def test_missing_files_raise_file_not_found(name, tmp_path, monkeypatch):
    monkeypatch.setattr(tdata, "_download", _no_network)
    with pytest.raises(FileNotFoundError, match="download failed"):
        tdata.Dataset(name, str(tmp_path), {"use_cache": False}, device="cpu").load()


def test_download_is_atomic(tmp_path, monkeypatch):
    """A fetch that fails midway leaves no file and no ``.part`` behind."""
    import urllib.request

    class Broken(io.BytesIO):
        def read(self, n=-1):
            if self.tell() >= 4:
                raise OSError("connection reset")
            return super().read(4)

    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout: Broken(b"abcdefgh"))
    dest = tmp_path / "sub" / "f.bin"
    with pytest.raises(OSError, match="connection reset"):
        tdata._download("http://localhost/f.bin", str(dest))
    assert not dest.exists() and not (tmp_path / "sub" / "f.bin.part").exists()
    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout: io.BytesIO(b"abc"))
    tdata._download("http://localhost/f.bin", str(dest))
    assert dest.read_bytes() == b"abc"


def test_sift1m_archive_is_extracted(tmp_path, monkeypatch, rng, numpy_only):
    """``ensure_sift1m`` unpacks the TEXMEX archive's ``sift/`` directory."""
    x = rng.integers(0, 50, size=(200, 8)).astype(np.float32)
    staging = tmp_path / "staging"
    os.makedirs(staging / "sift")
    _write_vecs(staging / "sift" / "sift_base.fvecs", x)
    _write_vecs(staging / "sift" / "sift_query.fvecs", x[:5] + 0.5)

    def fetch(url, dest):
        assert url == tdata.SIFT1M_URL
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with tarfile.open(dest, "w:gz") as tf:
            tf.add(staging / "sift", arcname="sift")

    monkeypatch.setattr(tdata, "_download", fetch)
    ds = tdata.Dataset("sift1m", str(tmp_path / "data"),
                       {"use_cache": False, "ground_truth_k": 3}, device="cpu").load()
    np.testing.assert_array_equal(ds.train_vectors, x)
    assert ds.ground_truth.shape == (5, 3) and "surrogate" not in ds.metadata


def test_glove50_archive_is_extracted(tmp_path, monkeypatch):
    src = tmp_path / "src.txt"
    _write_glove(str(src), n=60)

    def fetch(url, dest):
        assert url == tdata.GLOVE_URL
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with zipfile.ZipFile(dest, "w") as zf:
            zf.write(src, "glove.6B.50d.txt")

    monkeypatch.setattr(tdata, "_download", fetch)
    ds = tdata.Dataset("glove50", str(tmp_path / "data"),
                       {"use_cache": False, "test_size": 10, "ground_truth_k": 3},
                       device="cpu").load()
    assert ds.train_vectors.shape == (50, 50)


def test_every_catalog_name_is_ported():
    assert set(tdata.Dataset.CATALOG) == set(jdata.Dataset.CATALOG)
    for name in tdata.Dataset.CATALOG:
        assert callable(getattr(tdata.Dataset, f"_load_{name}"))
