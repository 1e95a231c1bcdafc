"""The port's out-of-core data layer (data/storage.py, the memmap paths of
data/datasets.py, the streaming IVF and block-graph builds) against the
JAX package's.

Each test of tests/data/test_storage.py has a counterpart here, at a small
size on the CPU. Stores are one on-disk format: either package reads the
other's, and the seeded ``storage: memmap`` corpus is byte-identical.
Exact searches must equal the JAX package's and the resident path's to f32
rounding; streamed builds train on each package's own RNG, so they are
held to the JAX tests' recall bounds and to the resident build's recall.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from vectordb_retrieval_tpu.data import datasets as jdata
from vectordb_retrieval_tpu.data import storage as jstorage
from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
from vectordb_retrieval_tpu_torch.data import datasets as tdata
from vectordb_retrieval_tpu_torch.data import native_io
from vectordb_retrieval_tpu_torch.data.storage import (
    BigStore,
    chunked_device_put,
    corpus_to_device,
    is_out_of_core,
    peak_rss_bytes,
    streamed_exact_search,
)
from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.ops import distances as tdops
from vectordb_retrieval_tpu_torch.ops import graph as tgops

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def store(tmp_path):
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((1000, 24), dtype=np.float32)
    path = str(tmp_path / "corpus.bin")
    with BigStore.create(path, 24) as w:
        for start in range(0, 1000, 170):  # ragged chunks
            w.append(ref[start : start + 170])
    return BigStore.open(path), ref


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """``native/vrt_io.cpp`` built with the flags of ``native/Makefile``
    into a temporary directory (the repo's ``native/libvrt_io.so`` is a
    build output, absent from a fresh checkout)."""
    out = tmp_path_factory.mktemp("native") / "libvrt_io.so"
    cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
           os.path.join(REPO, "native", "vrt_io.cpp"), "-o", str(out)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.CalledProcessError) as exc:
        pytest.skip(f"cannot build native/vrt_io.cpp here: {exc}")
    return str(out)


def _reader(native, request, monkeypatch):
    """Point native_io at the built library (native) or at none (NumPy)."""
    paths = (request.getfixturevalue("native_lib"),) if native else ()
    monkeypatch.setattr(native_io, "_LIB_PATHS", paths)
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_load_attempted", False)
    assert native_io.available() == native


def _dense_store(tmp_path, ref, name="c.bin"):
    path = str(tmp_path / name)
    with BigStore.create(path, ref.shape[1]) as w:
        w.append(ref)
    return BigStore.open(path)


# ---- BigStore -----------------------------------------------------------------


class TestBigStore:
    def test_round_trip(self, store):
        s, ref = store
        assert s.shape == (1000, 24) and s.nbytes == ref.nbytes
        np.testing.assert_array_equal(s.read_rows(0, 1000), ref)

    def test_offset_reads(self, store):
        s, ref = store
        np.testing.assert_array_equal(s.read_rows(123, 456), ref[123:456])
        assert s.read_rows(990, 2000).shape == (10, 24)  # clamped
        assert s.read_rows(5, 5).shape == (0, 24)
        buf = np.zeros((40, 24), np.float32)
        assert s.read_into(980, buf) == 20
        np.testing.assert_array_equal(buf[:20], ref[980:])

    @pytest.mark.parametrize("native", [False, True])
    def test_iter_chunks_covers_all(self, store, native, request, monkeypatch):
        _reader(native, request, monkeypatch)
        s, ref = store
        chunks = list(s.iter_chunks(333))
        assert [c.shape[0] for c in chunks] == [333, 333, 333, 1]
        np.testing.assert_array_equal(np.concatenate(chunks), ref)

    def test_as_memmap(self, store):
        s, ref = store
        mm = s.as_memmap()
        assert isinstance(mm, np.memmap) and is_out_of_core(mm) and is_out_of_core(s)
        np.testing.assert_array_equal(np.asarray(mm[200:300]), ref[200:300])

    def test_open_missing_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            BigStore.open(str(tmp_path / "nope.bin"))
        (tmp_path / "bad.bin.json").write_text('{"magic": "other"}')
        with pytest.raises(ValueError, match="not a BigStore"):
            BigStore.open(str(tmp_path / "bad.bin"))


def test_stores_cross_packages(tmp_path, rng):
    """A store written by either package is read by the other, bit for
    bit, with the same sidecar."""
    ref = rng.standard_normal((300, 12)).astype(np.float32)
    with jstorage.BigStore.create(str(tmp_path / "j.bin"), 12) as w:
        w.append(ref[:100])
        w.append(ref[100:])
    with BigStore.create(str(tmp_path / "t.bin"), 12) as w:
        w.append(ref[:7])
        w.append(ref[7:])
    t_of_j = BigStore.open(str(tmp_path / "j.bin"))
    j_of_t = jstorage.BigStore.open(str(tmp_path / "t.bin"))
    np.testing.assert_array_equal(t_of_j.read_rows(0, 300), ref)
    np.testing.assert_array_equal(j_of_t.read_rows(0, 300), ref)
    np.testing.assert_array_equal(np.concatenate(list(t_of_j.iter_chunks(64))), ref)
    assert (tmp_path / "j.bin.json").read_text() == (tmp_path / "t.bin.json").read_text()
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()


# ---- chunked upload -----------------------------------------------------------


class TestChunkedDevicePut:
    def test_matches_direct_upload(self, store):
        s, ref = store
        np.testing.assert_array_equal(chunked_device_put(s, chunk_rows=170, device="cpu").numpy(), ref)

    def test_ragged_tail_overlap(self, store):
        s, ref = store
        # chunk_rows not dividing N: a shorter last chunk
        dev = chunked_device_put(s, chunk_rows=512, device="cpu")
        np.testing.assert_array_equal(dev.numpy(), ref)
        np.testing.assert_array_equal(
            np.asarray(jstorage.chunked_device_put(s.as_memmap(), chunk_rows=512)), dev.numpy())

    def test_memmap_source(self, store):
        s, ref = store
        dev = chunked_device_put(s.as_memmap(), chunk_rows=256, device="cpu")
        assert dev.dtype == torch.float32
        np.testing.assert_array_equal(dev.numpy(), ref)

    def test_corpus_to_device_plain_array(self, monkeypatch, store):
        ref = np.random.default_rng(1).standard_normal((64, 8)).astype(np.float32)
        np.testing.assert_array_equal(corpus_to_device(ref, device="cpu").numpy(), ref)
        # above the byte threshold a plain array takes the chunked path too
        from vectordb_retrieval_tpu_torch.data import storage

        calls = []
        monkeypatch.setattr(storage, "CHUNKED_UPLOAD_BYTES", 100)
        monkeypatch.setattr(storage, "chunked_device_put",
                            lambda *a, **k: calls.append(1) or torch.as_tensor(ref))
        storage.corpus_to_device(ref, device="cpu")
        assert calls == [1]


# ---- memmap datasets ------------------------------------------------------------


class TestMemmapDataset:
    def test_random_memmap_mode(self, tmp_path):
        opts = {"train_size": 600, "test_size": 16, "dimensions": 16, "ground_truth_k": 5,
                "seed": 3, "storage": "memmap", "chunk_rows": 128}
        ds = tdata.Dataset("random", data_dir=str(tmp_path / "t"), options=opts, device="cpu").load()
        jds = jdata.Dataset("random", data_dir=str(tmp_path / "j"), options=opts).load()
        assert isinstance(ds.train_vectors, np.memmap) and ds.train_vectors.shape == (600, 16)
        # the same draws: byte-identical stores, equal ground truth
        with open(ds.metadata["train_store"], "rb") as a, open(jds.metadata["train_store"], "rb") as b:
            assert a.read() == b.read()
        assert ds.test_vectors.tobytes() == jds.test_vectors.tobytes()
        np.testing.assert_array_equal(ds.ground_truth, jds.ground_truth)
        dense = np.array(ds.train_vectors)
        np.testing.assert_array_equal(
            ds.ground_truth, tdata.compute_ground_truth(dense, ds.test_vectors, 5, ds.metric,
                                                        device="cpu"))
        # the cache round trip keeps the memmap view and identical payloads
        ds2 = tdata.Dataset("random", data_dir=str(tmp_path / "t"), options=opts, device="cpu").load()
        assert isinstance(ds2.train_vectors, np.memmap)
        np.testing.assert_array_equal(np.asarray(ds2.train_vectors), dense)
        np.testing.assert_array_equal(ds2.ground_truth, ds.ground_truth)

    def test_builders_accept_memmap(self, tmp_path):
        rng = np.random.default_rng(5)
        ref = rng.standard_normal((800, 16), dtype=np.float32)
        mm = _dense_store(tmp_path, ref).as_memmap()
        q = rng.standard_normal((8, 16), dtype=np.float32)
        for indexer, searcher in (
            ({"type": "BruteForceIndexer"}, {"type": "LinearSearcher"}),
            ({"type": "IVFIndexer", "index_type": "IVF16,Flat"},
             {"type": "ANNSearcher", "nprobe": 16}),
        ):
            a = CompositeAlgorithm(dimension=16, indexer=indexer, searcher=searcher,
                                   metric="l2", device="cpu")
            a.build_index(mm)
            b = CompositeAlgorithm(dimension=16, indexer=indexer, searcher=searcher,
                                   metric="l2", device="cpu")
            b.build_index(ref)
            da, ia = a.batch_search(q, 5)
            db, ib = b.batch_search(q, 5)
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-5)
            assert "built_streaming" not in a.artifact.metadata  # chunked upload


# ---- streamed exact search ------------------------------------------------------


class TestStreamedSearch:
    def test_matches_resident_exact(self, store):
        s, ref = store
        q = np.random.default_rng(7).standard_normal((8, 24)).astype(np.float32)
        for metric in ("l2", "ip"):
            ds, is_ = streamed_exact_search(q, s, 10, metric=metric, chunk_rows=170, device="cpu")
            dd, id_ = tdops.exact_search(q, ref, 10, metric=metric, refine=metric == "l2",
                                         device="cpu")
            np.testing.assert_allclose(ds, dd.numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(is_, id_.numpy())  # tie-free random rows
            jd, ji = jstorage.streamed_exact_search(q, jstorage.BigStore.open(s.path), 10,
                                                    metric=metric, chunk_rows=170)
            np.testing.assert_array_equal(is_, np.asarray(ji))
            np.testing.assert_allclose(ds, np.asarray(jd), rtol=1e-5, atol=1e-5)
            assert is_.dtype == np.int64

    def test_streaming_gt_matches_dense_gt(self, store):
        s, ref = store
        q = np.random.default_rng(9).standard_normal((6, 24)).astype(np.float32)
        gt_stream = tdata.compute_ground_truth(s.as_memmap(), q, 5, "l2", device="cpu")
        np.testing.assert_array_equal(gt_stream, tdata.compute_ground_truth(ref, q, 5, "l2",
                                                                            device="cpu"))
        np.testing.assert_array_equal(gt_stream, jdata.compute_ground_truth(s.as_memmap(), q, 5))
        np.testing.assert_array_equal(tdata.compute_ground_truth(s, q, 5, "l2", device="cpu"),
                                      gt_stream)


def test_streaming_gt_cosine_matches_dense(tmp_path):
    rng = np.random.default_rng(13)
    ref = rng.standard_normal((800, 24)).astype(np.float32)
    mm = _dense_store(tmp_path, ref).as_memmap()
    q = rng.standard_normal((6, 24)).astype(np.float32)
    gt_stream = tdata.compute_ground_truth(mm, q, 5, "cosine", device="cpu")
    np.testing.assert_array_equal(gt_stream, tdata.compute_ground_truth(ref, q, 5, "cosine",
                                                                        device="cpu"))
    np.testing.assert_array_equal(gt_stream, jdata.compute_ground_truth(mm, q, 5, "cosine"))


def test_streamed_tail_smaller_than_overfetch(tmp_path):
    """A final chunk with fewer rows than k + overfetch must not bring back
    padded zero rows (the port never pads; the JAX package pads and masks)."""
    rng = np.random.default_rng(3)
    # 1056 rows with chunk_rows=1000 -> a 56-row tail < kk = 10 + 16
    ref = rng.standard_normal((1056, 16)).astype(np.float32) + 5.0
    s = _dense_store(tmp_path, ref)
    q = rng.standard_normal((4, 16)).astype(np.float32) + 5.0
    d, ids = streamed_exact_search(q, s, 10, metric="l2", chunk_rows=1000, device="cpu")
    assert (ids >= 0).all() and (ids < 1056).all()
    exp = np.sort(((q[:, None, :] - ref[None, :, :]) ** 2).sum(-1), axis=1)[:, :10]
    np.testing.assert_allclose(np.sort(d, 1), exp, rtol=1e-4, atol=1e-4)
    jd, ji = jstorage.streamed_exact_search(q, jstorage.BigStore.open(s.path), 10, metric="l2",
                                            chunk_rows=1000)
    np.testing.assert_array_equal(ids, np.asarray(ji))
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5)
    # chunks of 3 rows (every chunk smaller than the overfetch), ties on
    # integer rows: equal distances keep the lower row, as the resident path
    ints = np.floor(ref[:60] - 4.0)
    qi = np.floor(q[:, :] - 4.0)
    d3, i3 = streamed_exact_search(qi, _dense_store(tmp_path, ints, "i.bin"), 10, chunk_rows=3,
                                   device="cpu")
    full = ((qi[:, None, :] - ints[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(i3, np.argsort(full, axis=1, kind="stable")[:, :10])
    np.testing.assert_array_equal(d3, np.sort(full, axis=1)[:, :10])
    with pytest.raises(ValueError, match="exceeds database size"):
        streamed_exact_search(q, s, 2000, device="cpu")


def test_peak_rss_and_trim_host_heap():
    from vectordb_retrieval_tpu.utils.compat import trim_host_heap as jtrim
    from vectordb_retrieval_tpu_torch.utils.compat import trim_host_heap

    rss = peak_rss_bytes()
    assert rss is not None and rss > 0 and jstorage.peak_rss_bytes() > 0
    assert trim_host_heap() == jtrim()


def test_peak_rss_counts_this_process_only():
    """A fresh subprocess of a large parent reports its own peak: linux
    carries ru_maxrss over fork and exec, VmHWM starts anew."""
    import sys

    ballast = np.ones(64 << 20)  # 512 MB resident in this process
    code = ("import resource\n"
            "from vectordb_retrieval_tpu_torch.data.storage import peak_rss_bytes\n"
            "print(peak_rss_bytes(), resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    peak, maxrss = int(out[0]), int(out[1])
    assert peak < ballast.nbytes <= maxrss, (peak, maxrss)


# ---- streaming IVF builds -------------------------------------------------------


def _coded_recall(tmp_path, seed, key):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((3000, 16), dtype=np.float32)
    store = _dense_store(tmp_path, ref)
    q = rng.standard_normal((16, 16), dtype=np.float32)
    gt = np.argsort(((q[:, None, :] - ref[None, :, :]) ** 2).sum(-1), axis=1)[:, :10]
    algo = CompositeAlgorithm(
        dimension=16, indexer={"type": "FactoryIndexer", "index_key": key},
        searcher={"type": "ANNSearcher", "nprobe": 8}, metric="l2", device="cpu",
    )
    algo.build_index(store)
    _, ids = algo.batch_search(q, 10)
    return algo, recall_at_k(gt, ids, 10)


class TestStreamingIVFBuild:
    def test_sq8_stream_build_recall(self, tmp_path):
        algo, recall = _coded_recall(tmp_path, 4, "IVF8,SQ8")
        meta = algo.artifact.metadata
        assert meta.get("built_streaming") is True and algo.artifact.kind == "ivf_sq8"
        assert set(algo.indexer.build_seconds) == {
            "sample", "coarse_kmeans", "sq_train", "encode", "layout"}
        assert recall > 0.95  # all-probe SQ8: near-exact

    def test_pq_stream_build_recall(self, tmp_path):
        algo, recall = _coded_recall(tmp_path, 8, "IVF8,PQ8")
        assert algo.artifact.metadata.get("built_streaming") is True
        assert algo.artifact.kind == "ivf_pq"
        assert recall > 0.5  # PQ8 on 16-d residuals, all probes: lossy


def test_stream_built_codes_equal_a_resident_encode(tmp_path):
    """The streamed SQ8 codes are the resident encode of the store's rows
    under the trained ranges, placed by the bucket layout; a rotated
    IVF-PQ streams through pq_encode_rotated."""
    from vectordb_retrieval_tpu_torch.ops import sq as tsq

    rng = np.random.default_rng(21)
    ref = rng.standard_normal((2500, 8), dtype=np.float32)
    store = _dense_store(tmp_path, ref)
    algo = CompositeAlgorithm(
        dimension=8, indexer={"type": "FactoryIndexer", "index_key": "IVF4,SQ8"},
        searcher={"type": "ANNSearcher", "nprobe": 4}, metric="l2", device="cpu")
    algo.build_index(store)
    d = algo.artifact.data
    codes = tsq.sq_encode(torch.as_tensor(ref), d["vmin"], d["step"])
    slots = d["slot_ids"].numpy()
    live = slots >= 0
    np.testing.assert_array_equal(d["list_codes"].numpy()[live], codes.numpy()[slots[live]])
    rot = CompositeAlgorithm(
        dimension=8, indexer={"type": "FactoryIndexer", "index_key": "IVF4,PQ4",
                              "pq_rotations": 4},
        searcher={"type": "ANNSearcher", "nprobe": 4}, metric="l2", device="cpu")
    rot.build_index(store)
    assert "list_rotations" in rot.artifact.data and rot.artifact.kind == "ivf_pq"
    q = rng.standard_normal((8, 8), dtype=np.float32)
    gt = np.argsort(((q[:, None, :] - ref[None, :, :]) ** 2).sum(-1), axis=1)[:, :10]
    assert recall_at_k(gt, rot.batch_search(q, 10)[1], 10) > 0.5


# ---- streaming block graph ------------------------------------------------------


def _clustered_store(tmp_path, rng, n=20_000, d=16, n_clusters=120):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 4
    ref = centers[rng.integers(0, n_clusters, n)] + rng.standard_normal((n, d)).astype(np.float32) * 0.3
    return _dense_store(tmp_path, ref, "graph_corpus.bin"), ref


def _queries(rng, ref):
    qi = rng.choice(ref.shape[0], 32, replace=False)
    q = ref[qi] + rng.standard_normal((32, ref.shape[1])).astype(np.float32) * 0.05
    return q, np.argsort(((q[:, None, :] - ref[None, :, :]) ** 2).sum(-1), axis=1)[:, :10]


class TestGraphStreamBuild:
    def test_model_level_stream_build(self, tmp_path):
        rng = np.random.default_rng(11)
        store, ref = _clustered_store(tmp_path, rng)
        q, gt = _queries(rng, ref)
        algo = CompositeAlgorithm(
            dimension=16, indexer={"type": "GraphIndexer", "M": 16, "mode": "block"},
            searcher={"type": "ANNSearcher", "efSearch": 128}, metric="l2", device="cpu",
        )
        algo.build_index(store)
        meta = algo.artifact.metadata
        assert meta.get("built_streaming") is True and meta["mode"] == "block"
        assert meta["selfcheck_recall"] > 0.8
        assert algo.artifact.device_nbytes() <= 1.25 * ref.nbytes  # memory parity
        assert recall_at_k(gt, algo.batch_search(q, 10)[1], 10) > 0.9

    def test_multichunk_matches_resident_class(self, tmp_path):
        """Chunked streaming (4 chunks) reaches the resident build's recall
        class; from the same centroids it builds the resident layout."""
        rng = np.random.default_rng(12)
        store, ref = _clustered_store(tmp_path, rng, n=12_000)
        parts_s = tgops.build_block_graph_stream(store, 96, 16, seed=7, chunk_rows=3_000,
                                                 device="cpu")
        parts_r = tgops.build_block_graph(torch.as_tensor(ref), 96, 16, seed=7)
        q, gt = _queries(rng, ref)
        recs = []
        for parts in (parts_s, parts_r):
            assert (parts[2].numpy()[:-1] >= 0).all()  # pad slots only in the last block
            _, ids = tgops.block_graph_search(torch.as_tensor(q), *parts, 10, efb=128)
            recs.append(recall_at_k(gt, ids.numpy(), 10))
        assert recs[0] > 0.9 and recs[0] >= recs[1] - 0.05

    def test_stream_spill_matches_resident_spill(self, tmp_path):
        """Spilled streamed build: the resident spill's layout law (clone
        count, block_len) and duplicate-free search."""
        rng = np.random.default_rng(13)
        store, ref = _clustered_store(tmp_path, rng, n=12_000)
        parts_s = tgops.build_block_graph_stream(store, 96, 16, seed=7, chunk_rows=3_000,
                                                 spill=0.15, device="cpu")
        parts_r = tgops.build_block_graph(torch.as_tensor(ref), 96, 16, seed=7, spill=0.15)
        assert parts_s[2].shape == parts_r[2].shape
        sn = parts_s[2].numpy()
        valid = sn[sn >= 0]
        assert valid.size - np.unique(valid).size == int(0.15 * ref.shape[0])
        q, gt = _queries(rng, ref)
        _, ids = tgops.block_graph_search(torch.as_tensor(q), *parts_s, 10, efb=128, dedup=True)
        ids = ids.numpy()
        for row in ids:
            got = [i for i in row.tolist() if i >= 0]
            assert len(got) == len(set(got))
        assert recall_at_k(gt, ids, 10) > 0.9


@pytest.mark.parametrize("spill", [0.0, 0.15])
def test_stream_layout_equals_resident_from_the_same_centroids(tmp_path, monkeypatch, spill):
    """Given the resident build's centroids, the streamed build (small
    chunks) lays out the same slots, entries, slabs and entry graph: the
    rank scatter and the segment sums are exact and order-free."""
    from vectordb_retrieval_tpu_torch.ops import kmeans as tkm

    rng = np.random.default_rng(14)
    store, ref = _clustered_store(tmp_path, rng, n=3_000)
    x = torch.as_tensor(ref)
    cents, _ = tkm.kmeans_fit(x, 24, seed=1, iters=4)
    monkeypatch.setattr(tkm, "kmeans_fit", lambda *a, **k: (cents, None))
    parts_s = tgops.build_block_graph_stream(store, 24, 8, chunk_rows=700, spill=spill,
                                             slab_dtype="bf16", device="cpu")
    parts_r = tgops._block_layout(x, cents, 8, spill, "bf16")
    for a, b in zip(parts_s, parts_r):
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


def test_graph_stream_selfcheck_uses_streamed_truth(tmp_path):
    """The out-of-core self-check scores 256 evenly spaced rows against a
    streamed exact search; a cosine corpus normalises both."""
    rng = np.random.default_rng(15)
    store, ref = _clustered_store(tmp_path, rng, n=4_000)
    for metric in ("l2", "cosine"):
        algo = CompositeAlgorithm(
            dimension=16, indexer={"type": "GraphIndexer", "M": 8, "mode": "auto"},
            searcher={"type": "ANNSearcher", "efSearch": 64}, metric=metric, device="cpu")
        algo.build_index(store.as_memmap())
        meta = algo.artifact.metadata
        assert meta["mode"] == "block" and meta["built_streaming"] and meta["normalize_queries"] == (
            metric == "cosine")
        assert 0.8 < meta["selfcheck_recall"] <= 1.0


@pytest.mark.parametrize("native", [False, True])
def test_memmaps_read_by_file_offset(tmp_path, native, request, monkeypatch):
    """A memmapped .npy (an offset past its header) and a row prefix of it
    stream from the file by offset, never through the mapping, with the
    mapping's values; a copy-on-write mapping reads through the mapping."""
    from vectordb_retrieval_tpu_torch.data import storage

    _reader(native, request, monkeypatch)
    ref = np.random.default_rng(31).standard_normal((1000, 12)).astype(np.float32)
    np.save(tmp_path / "x.npy", ref)
    full = np.load(tmp_path / "x.npy", mmap_mode="r")
    prefix = full[:700]
    touched = []
    monkeypatch.setattr(storage, "_drop_pages", lambda src: touched.append(1))
    for mm, want in ((full, ref), (prefix, ref[:700])):
        view = storage._file_rows(mm)
        assert view is not None and view.offset >= 128 and view.shape == want.shape
        chunks = list(storage.iter_chunks_any(mm, 300))
        assert [c.shape[0] for _, c in chunks] == [300] * (len(want) // 300) + (
            [len(want) % 300] if len(want) % 300 else [])
        np.testing.assert_array_equal(np.concatenate([c for _, c in chunks]), want)
        np.testing.assert_array_equal(storage._read_chunk(mm, 650, 720), want[650:720])
        np.testing.assert_array_equal(chunked_device_put(mm, chunk_rows=256, device="cpu").numpy(),
                                      want)
    assert not touched  # the mapping was never read
    cow = np.load(tmp_path / "x.npy", mmap_mode="c")
    assert storage._file_rows(cow) is None and storage._file_rows(ref) is None
    np.testing.assert_array_equal(storage._read_chunk(cow, 0, 5), ref[:5])
