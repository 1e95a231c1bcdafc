"""Dataset manager: loaders of the catalog, exact ground truth, npz cache.

Counterpart of ``vectordb_retrieval_tpu/data/datasets.py``. Ground truth is
computed on the device with the port's exact search. Every loader of the
catalog is ported:
  * seeded synthesis (``random``, ``glove50_surrogate``,
    ``msmarco_surrogate``, ``manifold``): NumPy only, so the same seed gives
    the same vectors bit for bit in both packages;
  * files: ``sift1m`` (.fvecs/.ivecs, through ``data/native_io.py`` where
    ``native/libvrt_io.so`` is built), ``glove50`` (GloVe txt) and
    ``msmarco`` (pre-embedded .npy directory, or TSV text through
    ``data/tfidf.py``). A missing file is downloaded where the host has
    egress, else ``FileNotFoundError``.
Out-of-core corpora stay off the host's heap: ``storage: memmap`` draws the
``random`` corpus chunk by chunk straight into a ``BigStore``
(``data/storage.py``) and reloads it as a read-only ``np.memmap``, and the
ground truth of a memmap or ``BigStore`` corpus (``msmarco``'s default
``use_memmap_cache: true`` included) is ``streamed_exact_search``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.data.storage import (
    BigStore,
    corpus_to_device,
    is_out_of_core,
    streamed_exact_search,
)
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device
from vectordb_retrieval_tpu_torch.utils.hashing import stable_hash

CACHE_KEY_VERSION = 3
# The port's own tag: its cache files never mix with the JAX package's.
GROUND_TRUTH_METHOD = "torch_exact_v1"


def compute_ground_truth(
    train,
    queries: np.ndarray,
    k: int,
    metric: str = "l2",
    normalize: bool = False,
    device: DeviceLike = None,
) -> np.ndarray:
    """Exact top-k ground truth (ids only, int64) on ``device``.

    Runs ``exact_search(refine=True)``: cancellation-free rescoring makes
    the ranking exact to f32 rounding. Cosine normalises both sides and
    scores as ip. ``train`` may be a tensor, an ndarray, an ``np.memmap``
    or a ``BigStore``; out-of-core sources run the fully streaming scan
    (O(chunk) host and device memory, the same rescore).
    """
    from vectordb_retrieval_tpu_torch.ops import distances as dops

    dev = resolve_device(device)
    if is_out_of_core(train):
        norm = metric == "cosine" or normalize
        _, ids = streamed_exact_search(
            queries, train, min(k, train.shape[0]),
            metric="ip" if norm else metric, normalize=norm, device=dev,
        )
        return ids.astype(np.int64)
    x = corpus_to_device(train, device=dev)
    q = torch.as_tensor(np.ascontiguousarray(queries, dtype=np.float32), device=dev)
    if metric == "cosine" or normalize:
        x = dops.normalize(x)
        q = dops.normalize(q)
        metric = "ip"
    k = min(k, x.shape[0])
    _, ids = dops.exact_search(q, x, k, metric=metric, refine=True, device=dev)
    return ids.cpu().numpy().astype(np.int64)


def _read_vecs_numpy(path: str, limit: Optional[int], dtype) -> np.ndarray:
    """Parse .fvecs/.ivecs with NumPy: per row an int32 dim header, then dim
    values; every header must agree."""
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=dtype)
    dim = int(raw[0])
    row = dim + 1
    n = raw.size // row
    if limit is not None:
        n = min(n, limit)
    mat = raw[: n * row].reshape(n, row)
    if not np.all(mat[:, 0] == dim):
        raise ValueError(f"inconsistent vecs dims in {path}")
    return mat[:, 1:].view(dtype).copy()


def read_fvecs(path: str, limit: Optional[int] = None) -> np.ndarray:
    """Parse .fvecs with the native mmap/multithreaded parser
    (``native/vrt_io.cpp``) where the library is built, NumPy otherwise."""
    from vectordb_retrieval_tpu_torch.data import native_io

    if native_io.available():
        return native_io.read_fvecs(path, limit)
    return _read_vecs_numpy(path, limit, np.float32)


def read_ivecs(path: str, limit: Optional[int] = None) -> np.ndarray:
    """Parse .ivecs, as :func:`read_fvecs`."""
    from vectordb_retrieval_tpu_torch.data import native_io

    if native_io.available():
        return native_io.read_ivecs(path, limit)
    return _read_vecs_numpy(path, limit, np.int32)


def _download(url: str, dest: str) -> None:
    """Fetch ``url`` to ``dest`` atomically; a partial file is removed on
    error. Works for http(s) and ftp URLs."""
    import urllib.request

    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = dest + ".part"
    try:
        with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
        os.replace(tmp, dest)
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


SIFT1M_URL = "ftp://ftp.irisa.fr/local/texmex/corpus/sift.tar.gz"
GLOVE_URL = "https://nlp.stanford.edu/data/glove.6B.zip"


def ensure_sift1m(root: str) -> None:
    """Download + extract SIFT1M if the .fvecs files are absent."""
    if os.path.exists(os.path.join(root, "sift_base.fvecs")):
        return
    import tarfile

    archive = os.path.join(root, "sift.tar.gz")
    if not os.path.exists(archive):
        _download(SIFT1M_URL, archive)
    with tarfile.open(archive, "r:gz") as tf:
        # the 'data' filter blocks path traversal from a tampered archive
        tf.extractall(root, filter="data")
    inner = os.path.join(root, "sift")  # the archive extracts into sift/
    if os.path.isdir(inner):
        for name in os.listdir(inner):
            os.replace(os.path.join(inner, name), os.path.join(root, name))


def ensure_glove50(path: str) -> None:
    """Download + extract glove.6B.50d.txt if absent."""
    if os.path.exists(path):
        return
    import zipfile

    root = os.path.dirname(path)
    archive = os.path.join(root, "glove.6B.zip")
    if not os.path.exists(archive):
        _download(GLOVE_URL, archive)
    with zipfile.ZipFile(archive) as zf:
        zf.extract("glove.6B.50d.txt", root)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"glove archive extracted to {root} but {path} still missing "
            "(custom glove_path must point at glove.6B.50d.txt)"
        )


class Dataset:
    """Loads a named dataset exposing train/test vectors + ground truth.

    Construct with ``(name, data_dir, options, device)``, call ``load()``,
    then read ``.train_vectors / .test_vectors / .ground_truth / .metric``.
    ``device`` is where the ground truth is computed (``None``: the card).
    """

    CATALOG = (
        "random", "glove50", "glove50_surrogate", "sift1m", "msmarco",
        "msmarco_surrogate", "manifold",
    )

    def __init__(
        self,
        name: str,
        data_dir: str = "data",
        options: Optional[Dict[str, Any]] = None,
        device: DeviceLike = None,
    ):
        self.name = name
        self.data_dir = data_dir
        self.options = dict(options or {})
        self.device = device
        self.train_vectors: Optional[np.ndarray] = None
        self.test_vectors: Optional[np.ndarray] = None
        self.ground_truth: Optional[np.ndarray] = None
        self.metric = self.options.get("metric", "l2")
        self.metadata: Dict[str, Any] = {}

    # -- caching --------------------------------------------------------
    def _cache_key(self) -> str:
        payload = {
            "name": self.name,
            "options": self.options,
            "gt_method": GROUND_TRUTH_METHOD,
            "cache_key_version": CACHE_KEY_VERSION,
        }
        return stable_hash(payload)[:12]

    def _cache_path(self) -> str:
        return os.path.join(
            self.data_dir, "cache", f"{self.name}_{self._cache_key()}.npz"
        )

    def _store_path(self) -> str:
        return os.path.join(
            self.data_dir, "cache", f"{self.name}_{self._cache_key()}_train.bin"
        )

    @property
    def _memmap_mode(self) -> bool:
        """True when the train corpus lives in an out-of-core BigStore
        (the ``storage: memmap`` option: the >RAM staging path)."""
        return self.options.get("storage") == "memmap"

    def _load_cache(self) -> bool:
        path = self._cache_path()
        if not os.path.exists(path):
            return False
        try:
            with np.load(path, allow_pickle=False) as z:
                if "train" in z.files:
                    self.train_vectors = z["train"]
                elif BigStore.exists(self._store_path()):
                    # out-of-core train corpus: a lazy read-only memmap view
                    self.train_vectors = BigStore.open(self._store_path()).as_memmap()
                else:
                    return False
                self.test_vectors = z["test"]
                self.ground_truth = z["gt"]
            meta_path = path + ".json"
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    self.metadata = json.load(f)
            self.metric = self.metadata.get("metric", self.metric)
            return True
        except (OSError, KeyError, ValueError):
            return False

    def _save_cache(self) -> None:
        """Write the cache through temporary files of this process's own
        (processes that load one dataset from one data dir at once each
        replace the cache whole; a shared temporary name let one move the
        other's file away)."""
        path = self._cache_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        payload = {"test": self.test_vectors, "gt": self.ground_truth}
        if not isinstance(self.train_vectors, np.memmap):
            # a memmap corpus already lives on disk (the BigStore beside the
            # npz, or the loader's own file): copying it into the npz would
            # defeat the RSS bound
            payload["train"] = self.train_vectors
        with open(tmp + ".npz", "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp + ".npz", path)
        with open(tmp + ".json", "w") as f:
            json.dump(self.metadata, f, indent=2)
        os.replace(tmp + ".json", path + ".json")

    # -- loading --------------------------------------------------------
    def load(self) -> "Dataset":
        if self.name not in self.CATALOG:
            raise ValueError(
                f"unknown dataset {self.name!r}; known: {self.CATALOG}"
            )
        use_cache = bool(self.options.get("use_cache", True))
        if use_cache and self._load_cache():
            return self
        getattr(self, f"_load_{self.name}")()
        self.metadata.update(
            {
                "name": self.name,
                "n_train": int(self.train_vectors.shape[0]),
                "n_test": int(self.test_vectors.shape[0]),
                "dimensions": int(self.train_vectors.shape[1]),
                "ground_truth_k": int(self.ground_truth.shape[1]),
                "metric": self.metric,
                "gt_method": GROUND_TRUTH_METHOD,
            }
        )
        if use_cache:
            self._save_cache()
        return self

    def _gt_k(self) -> int:
        return int(self.options.get("ground_truth_k", 100))

    def _load_random(self) -> None:
        """Seeded gaussian synthesis (the same draws as the JAX package).

        With ``storage: memmap`` the train corpus is drawn ``chunk_rows``
        rows at a time straight into an on-disk BigStore (never whole on
        the host) and exposed as a read-only memmap: the same draws in the
        same order, so both packages write byte-identical stores."""
        dim = int(self.options.get("dimensions", 128))
        n_train = int(self.options.get("train_size", 10000))
        n_test = int(self.options.get("test_size", 1000))
        seed = int(self.options.get("seed", 42))
        rng = np.random.default_rng(seed)
        if self._memmap_mode:
            chunk = int(self.options.get("chunk_rows", 1 << 18))
            with BigStore.create(self._store_path(), dim) as store:
                for start in range(0, n_train, chunk):
                    rows = min(chunk, n_train - start)
                    store.append(rng.standard_normal((rows, dim), dtype=np.float32))
            self.train_vectors = BigStore.open(self._store_path()).as_memmap()
            self.metadata["train_store"] = self._store_path()
        else:
            self.train_vectors = rng.standard_normal((n_train, dim), dtype=np.float32)
        self.test_vectors = rng.standard_normal((n_test, dim), dtype=np.float32)
        self.ground_truth = compute_ground_truth(
            self.train_vectors, self.test_vectors, self._gt_k(), self.metric,
            device=self.device,
        )

    def _load_msmarco_surrogate(self) -> None:
        """Difficulty-calibrated MiniLM-384d stand-in (NOT real data).

        Real MS MARCO MiniLM embeddings need an egress-enabled host
        (data/download_attempts.log; reference embed_msmarco.py:149-172).
        This generator synthesises unit vectors with the structural
        statistics that set quantisation difficulty for sentence-encoder
        embeddings:

          * power-law anisotropic spectrum (variance ~ (i+1)^-alpha) in a
            random rotated basis — transformer embeddings concentrate
            variance in a few hundred directions (Ethayarajh 2019);
          * Zipf-occupied hierarchical topic clusters (parents + children)
            — passages cluster by topic with frequency skew;
          * queries drawn NEAR passage clusters with extra spread (real
            queries are short texts embedded into the same space).

        Knobs are calibrated (scripts/calibrate_msmarco_surrogate.py) so
        the framework's algorithms, configured EXACTLY like the
        reference's msmarco rows (IVF100,Flat np10 / IVF256,PQ64 np48 /
        IVF256,SQ8 np48 / PQ64 / hnsw M16 ef100), land near the
        reference's real-MiniLM recalls
        (benchmark_20260305_070532/benchmark_summary.md:43-50).
        Results on this dataset are labelled surrogate in benchmark
        metadata — difficulty-matched, not real-MiniLM numbers.
        """
        d = int(self.options.get("dim", 384))
        n_train = int(self.options.get("train_limit", 100_000))
        n_test = int(self.options.get("test_size", 200))
        seed = int(self.options.get("seed", 13))
        # Shipped defaults = the round-3 calibration winner (TPU grid,
        # exact nprobe semantics): identically-configured ivf_flat /
        # ivf_pq / ivf_sq8 / pq land within max|err| = 0.042 of the
        # reference's real-MiniLM recalls (0.9529 / 0.6986 / 0.9471 /
        # 0.7757 — reference benchmark_20260305_070532/
        # benchmark_summary.md:43-50; measured -0.006 / +0.040 / +0.007 /
        # -0.042). The residual +-0.04 on the PQ pair is a FAMILY limit:
        # in any energy-preserving gaussian-mixture surrogate, residual
        # coding is at least as easy as global coding, so the reference's
        # pq (0.776) > ivf_pq (0.699) inequality can only be approached,
        # not reproduced — every knob moves the pair together (grid logs:
        # scripts/calibrate_msmarco_surrogate.py).
        alpha = float(self.options.get("anisotropy", 0.45))
        n_parents = int(self.options.get("n_parents", 384))
        children_per = int(self.options.get("children_per_parent", 8))
        child_scale = float(self.options.get("child_scale", 0.9))
        point_scale = float(self.options.get("point_scale", 0.55))
        query_scale = float(self.options.get("query_scale", 0.8))
        # Topic-frequency skew: occupancy of child cluster rank r ~ r^-zipf.
        # High values over-crowd the head clusters (thousands of
        # near-duplicates -> vanishing neighbour margins -> flat-PQ recall
        # collapses far below the real-MiniLM level); the calibrated value
        # keeps the skew without the pile-up.
        zipf = float(self.options.get("zipf", 0.45))

        # Degree to which the variance spectrum stays in the NATIVE
        # coordinate basis (0 = fully random-rotated, 1 = axis-aligned).
        # Measured direction (calibration grid): alignment HURTS global
        # PQ (0.63 -> 0.58 at 0.5, -> 0.36 at 0.75) — with the spectrum
        # axis-aligned the first consecutive 6-dim PQ group carries the
        # dominant variance with only 256 centroids, while a random
        # rotation spreads variance evenly over all groups (the same
        # balancing OPQ's rotation performs). Kept at 0 for the shipped
        # calibration; the knob remains for sensitivity studies.
        align = float(self.options.get("spectrum_align", 0.0))

        # Per-cluster covariance heterogeneity: each child cluster's
        # scatter gets its own per-dimension lognormal scale vector
        # (sigma = cluster_var), rms-normalised per cluster so total
        # scatter energy — and hence coarse-quantiser / flat / graph
        # difficulty — is unchanged. What it changes is the SHAPE of the
        # residual distribution per list: IVF-PQ trains one shared
        # residual codebook over all lists (ops/pq.py), so heterogeneous
        # residual covariances make residual coding strictly harder,
        # mirroring real sentence embeddings where residual IVF-PQ
        # (ref 0.699) underperforms global PQ (ref 0.776). Without this
        # knob the surrogate had the inequality BACKWARDS (ivf_pq 0.81 >
        # pq 0.78 at the otherwise-best setting).
        cluster_var = float(self.options.get("cluster_var", 0.0))

        # Per-cluster RADIUS heterogeneity: each child cluster's scatter
        # gets one lognormal scale (sigma = radius_var), mean-energy
        # normalised so the corpus-level scatter budget is unchanged.
        # Distinct from ``cluster_var`` (per-dimension SHAPE, rms-fixed):
        # radius spread is the axis that makes residual IVF-PQ
        # specifically hard — the shared residual codebook's cell size is
        # set by the GLOBAL residual energy, so tight topics (small
        # radius, small neighbour margins) get quantised at a spacing
        # tuned for diffuse ones, scrambling their rankings. Real MiniLM
        # shows exactly this signature: residual coding (ivf_pq/ivf_sq8 =
        # 0.738) UNDERPERFORMS global coding (pq = 0.776), which no
        # energy-preserving shape knob reproduced.
        radius_var = float(self.options.get("radius_var", 0.85))

        # Heavy-tailed point scatter: student-t with ``tail_df`` degrees
        # of freedom (variance-normalised; 0 = gaussian). Quantiser-
        # SELECTIVE difficulty: exact scoring (ivf_flat lists, graph) is
        # indifferent to the coordinate value distribution, but 8-bit
        # affine SQ ranges and 256-codeword PQ cells are stretched by
        # outliers, inflating quantisation error relative to neighbour
        # margins — the axis the round-2 surrogate had uniformly too easy
        # (sq8 +0.05, pq +0.05, ivf_pq +0.11 vs the real-MiniLM targets
        # while ivf_flat sat ON target).
        tail_df = float(self.options.get("tail_df", 0.0))

        # Stray points: a fraction of passages displaced ``outlier_scale``
        # x the point scatter. Their coarse-list assignment is then weakly
        # coupled to the topic geometry, so when a stray IS a true
        # neighbour it tends to live in a list the query ranks poorly —
        # fattening the tail of the neighbour-list-rank CDF. This is the
        # coverage axis the gaussian surrogate lacks: its CDF saturates by
        # ~10% of lists probed (ivf_sq8 0.99 at nprobe 48/256 vs the
        # real-MiniLM 0.947), while real embeddings keep paying for more
        # probes. Exact search is unaffected (GT includes strays).
        outlier_frac = float(self.options.get("outlier_frac", 0.03))
        outlier_scale = float(self.options.get("outlier_scale", 6.0))

        rng = np.random.default_rng(seed)

        def scatter(*shape: int) -> np.ndarray:
            if tail_df > 2.0:
                out = rng.standard_t(tail_df, size=shape)
                out /= np.sqrt(tail_df / (tail_df - 2.0))
                return out.astype(np.float32)
            return rng.standard_normal(shape).astype(np.float32)
        spectrum = (np.arange(1, d + 1, dtype=np.float32)) ** (-alpha)
        spectrum /= np.sqrt(np.mean(spectrum**2))
        # random rotation so the spectrum is not trivially axis-aligned;
        # ``align`` interpolates back toward the identity (columns
        # renormalised so each spectrum component keeps its scale)
        basis, _ = np.linalg.qr(rng.standard_normal((d, d)))
        if align:
            basis = (1.0 - align) * basis + align * np.eye(d)
            basis /= np.maximum(
                np.linalg.norm(basis, axis=0, keepdims=True), 1e-12
            )
        basis = (basis * spectrum[None, :]).astype(np.float32)  # scaled

        parents = rng.standard_normal((n_parents, d)).astype(np.float32)
        children = (
            parents[:, None, :]
            + child_scale
            * rng.standard_normal((n_parents, children_per, d)).astype(
                np.float32
            )
        ).reshape(n_parents * children_per, d)
        ranks = np.arange(1, children.shape[0] + 1, dtype=np.float64)
        probs = ranks**-zipf
        probs /= probs.sum()
        if cluster_var:
            shapes = np.exp(
                cluster_var
                * rng.standard_normal((children.shape[0], d))
            ).astype(np.float32)
            shapes /= np.sqrt(
                np.mean(shapes**2, axis=1, keepdims=True)
            )  # per-cluster energy preserved
        else:
            shapes = np.ones((children.shape[0], d), np.float32)
        if radius_var:
            radii = np.exp(
                radius_var * rng.standard_normal(children.shape[0])
            ).astype(np.float32)
            radii /= np.sqrt(np.mean(radii**2))  # corpus energy preserved
            shapes = shapes * radii[:, None]
        assign = rng.choice(children.shape[0], size=n_train, p=probs)
        point_mult = np.ones((n_train, 1), np.float32)
        if outlier_frac > 0.0:
            stray = rng.random(n_train) < outlier_frac
            point_mult[stray] = outlier_scale
        pts = children[assign] + point_scale * point_mult * shapes[
            assign
        ] * scatter(n_train, d)
        # queries: near passage clusters, wider spread, same cluster shapes
        q_assign = rng.choice(children.shape[0], size=n_test, p=probs)
        qs = children[q_assign] + query_scale * shapes[
            q_assign
        ] * scatter(n_test, d)

        def shape(v: np.ndarray) -> np.ndarray:
            v = v @ basis.T  # impose the anisotropic spectrum
            return v / np.maximum(
                np.linalg.norm(v, axis=1, keepdims=True), 1e-12
            )

        self.train_vectors = np.ascontiguousarray(shape(pts))
        self.test_vectors = np.ascontiguousarray(shape(qs))
        self.metric = self.options.get("metric", "cosine")
        self.metadata["surrogate"] = True
        self.metadata["surrogate_for"] = "msmarco (MiniLM-L6-v2 384d)"
        self.ground_truth = compute_ground_truth(
            self.train_vectors, self.test_vectors, self._gt_k(), self.metric,
            device=self.device,
        )

    def _load_manifold(self) -> None:
        """Locally low-rank 'manifold' corpus (synthetic, labelled as such).

        Points live on K local patches, each with its OWN random
        ``r``-dimensional oriented frame and power-law singular spectrum:
        ``x = c_k + U_k (s * z) + eps * n``, ``z ~ N(0, I_r)``. IVF's coarse
        quantiser tracks the patch centres, so each list's residuals lie in
        that patch's own frame: a SHARED residual codebook quantises every
        list badly, and per-list rotations (``ops/pq.
        train_per_list_rotations``) re-align it. The corpus the rotations
        were built for.
        """
        d = int(self.options.get("dim", 128))
        n_train = int(self.options.get("train_limit", 100_000))
        n_test = int(self.options.get("test_size", 200))
        seed = int(self.options.get("seed", 29))
        n_patches = int(self.options.get("n_patches", 256))
        r = int(self.options.get("intrinsic_dim", 12))
        alpha = float(self.options.get("spectrum_alpha", 0.7))
        patch_spread = float(self.options.get("patch_spread", 1.0))
        point_scale = float(self.options.get("point_scale", 0.35))
        ambient_noise = float(self.options.get("ambient_noise", 0.02))
        query_scale = float(self.options.get("query_scale", 0.5))
        zipf = float(self.options.get("zipf", 0.3))

        rng = np.random.default_rng(seed)
        centers = patch_spread * rng.standard_normal((n_patches, d)).astype(
            np.float32
        )
        # per-patch orthonormal r-frame with power-law singular values
        frames = np.empty((n_patches, d, r), np.float32)
        for p in range(n_patches):
            q_, _ = np.linalg.qr(rng.standard_normal((d, r)))
            frames[p] = q_.astype(np.float32)
        spec = (np.arange(1, r + 1, dtype=np.float32)) ** (-alpha)
        spec /= np.sqrt(np.mean(spec**2))
        ranks = np.arange(1, n_patches + 1, dtype=np.float64)
        probs = ranks**-zipf
        probs /= probs.sum()

        def sample(n: int, scale: float) -> np.ndarray:
            a = rng.choice(n_patches, size=n, p=probs)
            z = rng.standard_normal((n, r)).astype(np.float32) * spec[None]
            local = np.einsum("ndr,nr->nd", frames[a], z).astype(np.float32)
            eps = rng.standard_normal((n, d)).astype(np.float32)
            return (
                centers[a] + scale * local + ambient_noise * eps
            ).astype(np.float32)

        self.train_vectors = np.ascontiguousarray(sample(n_train, point_scale))
        self.test_vectors = np.ascontiguousarray(sample(n_test, query_scale))
        self.metric = self.options.get("metric", "l2")
        self.metadata["surrogate"] = True
        self.metadata["surrogate_for"] = (
            "per-list-structured corpora (synthetic manifold evidence set)"
        )
        self.ground_truth = compute_ground_truth(
            self.train_vectors, self.test_vectors, self._gt_k(), self.metric,
            device=self.device,
        )

    def _load_sift1m(self) -> None:
        """SIFT1M from local .fvecs/.ivecs files.

        Expects ``{data_dir}/{subdir}/sift_{base,query}.fvecs`` (``subdir``
        defaults to ``sift1m``) and optionally ``sift_groundtruth.ivecs``.
        The TEXMEX ground truth is read only for l2, with no ``base_limit``,
        when it is at least ``ground_truth_k`` wide; otherwise it is
        computed on the device. A directory holding ``PROVENANCE.json`` or
        named ``*synth*`` (``scripts/make_sift1m_surrogate.py``'s output)
        is labelled surrogate.
        """
        root = os.path.join(self.data_dir, self.options.get("subdir", "sift1m"))
        if not os.path.exists(os.path.join(root, "sift_base.fvecs")):
            try:
                ensure_sift1m(root)
            except Exception as exc:
                raise FileNotFoundError(
                    f"SIFT1M files missing under {root} and download failed "
                    f"({exc}); place sift_base.fvecs / sift_query.fvecs there"
                ) from exc
        if os.path.exists(os.path.join(root, "PROVENANCE.json")) or "synth" in os.path.basename(root):
            self.metadata["surrogate"] = True
            self.metadata["surrogate_for"] = "SIFT1M (TEXMEX 128d)"
        base_limit = self.options.get("base_limit")
        query_limit = self.options.get("test_size", self.options.get("query_limit"))
        base = read_fvecs(os.path.join(root, "sift_base.fvecs"), base_limit)
        queries = read_fvecs(os.path.join(root, "sift_query.fvecs"), query_limit)
        self.train_vectors = base
        self.test_vectors = queries
        gt_path = os.path.join(root, "sift_groundtruth.ivecs")
        gt = None
        if base_limit is None and self.metric == "l2" and os.path.exists(gt_path):
            gt = read_ivecs(gt_path, query_limit).astype(np.int64)
            if gt.shape[1] < self._gt_k():
                gt = None
        if gt is not None:
            self.ground_truth = gt[:, : self._gt_k()]
        else:
            self.ground_truth = compute_ground_truth(
                base, queries, self._gt_k(), self.metric, device=self.device
            )

    def _load_glove50(self) -> None:
        """GloVe-50 from a local txt: parse, optional subsample, seeded
        train/test split, device ground truth."""
        path = self.options.get(
            "glove_path", os.path.join(self.data_dir, "glove50", "glove.6B.50d.txt")
        )
        if not os.path.exists(path):
            try:
                ensure_glove50(path)
            except Exception as exc:
                raise FileNotFoundError(
                    f"GloVe file missing at {path} and download failed "
                    f"({exc}); place glove.6B.50d.txt there"
                ) from exc
        train_limit = self.options.get("train_limit")
        test_size = int(self.options.get("test_size", 1000))
        seed = int(self.options.get("seed", 42))
        vecs = []
        limit_rows = (train_limit + test_size) if train_limit else None
        with open(path, "r", encoding="utf-8") as f:
            for line_no, line in enumerate(f):
                if limit_rows is not None and line_no >= limit_rows:
                    break
                parts = line.rstrip().split(" ")
                vecs.append(np.asarray(parts[1:], dtype=np.float32))
        mat = np.stack(vecs)
        perm = np.random.default_rng(seed).permutation(mat.shape[0])
        test_idx, train_idx = perm[:test_size], perm[test_size:]
        if train_limit:
            train_idx = train_idx[:train_limit]
        self.train_vectors = np.ascontiguousarray(mat[train_idx])
        self.test_vectors = np.ascontiguousarray(mat[test_idx])
        self.ground_truth = compute_ground_truth(
            self.train_vectors, self.test_vectors, self._gt_k(), self.metric,
            device=self.device,
        )

    def _load_glove50_surrogate(self) -> None:
        """Distribution-matched GloVe-50 stand-in (NOT real data).

        Synthesises a corpus with glove.6B.50d's structural statistics:
        an optional anisotropic spectrum (per-component scale ~
        (i+1)^-alpha), Zipf-weighted hierarchical clusters (parents and
        tight children), a common mean offset and a log-normal radial
        spread rescaled to a mean norm of ~4.4. The defaults are the JAX
        package's calibration (``scripts/calibrate_glove_surrogate.py``:
        its five glove50 rows land within 0.015 of the reference's
        recalls). Results are labelled surrogate.
        """
        d = 50
        n_train = int(self.options.get("train_limit", 20000))
        n_test = int(self.options.get("test_size", 256))
        seed = int(self.options.get("seed", 11))
        alpha = float(self.options.get("anisotropy", 0.0))
        n_parents = int(self.options.get("n_parents", 160))
        children_per = int(self.options.get("children_per_parent", 6))
        child_scale = float(self.options.get("child_scale", 1.2))
        point_scale = float(self.options.get("point_scale", 1.7))
        mean_norm = float(self.options.get("mean_norm", 4.4))

        rng = np.random.default_rng(seed)
        n = n_train + n_test
        spectrum = (np.arange(1, d + 1, dtype=np.float32)) ** (-alpha)
        spectrum /= np.sqrt(np.mean(spectrum**2))

        parents = rng.standard_normal((n_parents, d)).astype(np.float32)
        children = (
            parents[:, None, :]
            + child_scale
            * rng.standard_normal((n_parents, children_per, d)).astype(np.float32)
        ).reshape(n_parents * children_per, d)
        # Zipfian cluster occupancy (frequency-skewed semantic clusters)
        ranks = np.arange(1, children.shape[0] + 1, dtype=np.float64)
        probs = ranks**-0.85
        probs /= probs.sum()
        assign = rng.choice(children.shape[0], size=n, p=probs)
        pts = children[assign] + point_scale * rng.standard_normal((n, d)).astype(np.float32)
        # diffuse background mass (rare words scatter far from any cluster)
        bg_frac = float(self.options.get("background_frac", 0.0))
        if bg_frac > 0:
            n_bg = int(n * bg_frac)
            bg_rows = rng.choice(n, size=n_bg, replace=False)
            bg_scale = float(np.linalg.norm(pts, axis=1).mean()) / np.sqrt(d)
            pts[bg_rows] = bg_scale * rng.standard_normal((n_bg, d)).astype(np.float32)
        pts *= spectrum[None, :]
        # common (non-centred) offset along a fixed direction
        mu_dir = rng.standard_normal(d).astype(np.float32) * spectrum
        mu_dir /= np.linalg.norm(mu_dir)
        pts += 0.35 * np.linalg.norm(pts, axis=1).mean() * mu_dir[None, :]
        # log-normal radial spread, rescaled to the target mean norm
        radial = rng.lognormal(0.0, 0.28, size=n).astype(np.float32)
        pts *= radial[:, None]
        pts *= mean_norm / np.linalg.norm(pts, axis=1).mean()

        perm = rng.permutation(n)
        self.train_vectors = np.ascontiguousarray(pts[perm[:n_train]])
        self.test_vectors = np.ascontiguousarray(pts[perm[n_train:]])
        self.metadata["surrogate"] = True
        self.metadata["surrogate_for"] = "glove50"
        self.ground_truth = compute_ground_truth(
            self.train_vectors, self.test_vectors, self._gt_k(), self.metric,
            device=self.device,
        )

    def _load_msmarco_tfidf(self) -> None:
        """TF-IDF text path: corpus/queries TSVs -> hashing tf-idf + random
        projection (``data/tfidf.py``) -> unit vectors + ground truth."""
        from vectordb_retrieval_tpu_torch.data.tfidf import read_tsv, texts_to_vectors

        corpus_tsv = self.options.get("corpus_tsv")
        queries_tsv = self.options.get("queries_tsv")
        if not corpus_tsv or not queries_tsv:
            raise ValueError(
                "msmarco tf-idf mode needs options.corpus_tsv and options.queries_tsv"
            )
        dim = int(self.options.get("dimensions", 384))
        seed = int(self.options.get("seed", 42))
        _, passages = read_tsv(corpus_tsv)
        _, queries = read_tsv(queries_tsv)
        base_limit = self.options.get("base_limit")
        query_limit = self.options.get("query_limit")
        if base_limit:
            passages = passages[: int(base_limit)]
        if query_limit:
            queries = queries[: int(query_limit)]
        train, vectorizer = texts_to_vectors(passages, dim=dim, seed=seed)
        test, _ = texts_to_vectors(queries, dim=dim, seed=seed, vectorizer=vectorizer)
        self.train_vectors = train
        self.test_vectors = test
        self.metric = self.options.get("metric", "cosine")
        self.ground_truth = compute_ground_truth(
            train, test, self._gt_k(), self.metric, device=self.device
        )

    def _load_msmarco(self) -> None:
        """Pre-embedded MS MARCO .npy directory: ``passage_embeddings.npy``
        + ``query_embeddings.npy`` with ``base_limit``/``query_limit``
        prefix slicing and device ground truth; ``use_tfidf`` takes the TSV
        text path instead. With the default ``use_memmap_cache: true`` the
        corpus stays a read-only ``np.memmap`` and its ground truth streams
        (``streamed_exact_search``); ``use_memmap_cache: false`` reads it
        into memory."""
        if self.options.get("use_tfidf"):
            self._load_msmarco_tfidf()
            return
        emb_dir = self.options.get("embedded_dataset_dir")
        if not emb_dir:
            raise ValueError(
                "msmarco requires options.embedded_dataset_dir pointing at "
                "passage_embeddings.npy / query_embeddings.npy "
                "(or use_tfidf with corpus_tsv/queries_tsv)"
            )
        mmap = "r" if self.options.get("use_memmap_cache", True) else None
        passages = np.load(os.path.join(emb_dir, "passage_embeddings.npy"), mmap_mode=mmap)
        queries = np.load(os.path.join(emb_dir, "query_embeddings.npy"), mmap_mode=mmap)
        base_limit = self.options.get("base_limit")
        query_limit = self.options.get("query_limit")
        if base_limit:
            passages = passages[: int(base_limit)]
        if query_limit:
            queries = queries[: int(query_limit)]
        # keep the memmap view where possible: np.ascontiguousarray would
        # strip the np.memmap wrapper and with it the out-of-core path
        if (
            isinstance(passages, np.memmap)
            and passages.dtype == np.float32
            and passages.flags["C_CONTIGUOUS"]
        ):
            self.train_vectors = passages
        else:
            self.train_vectors = np.ascontiguousarray(passages, dtype=np.float32)
        self.test_vectors = np.ascontiguousarray(queries, dtype=np.float32)
        self.metric = self.options.get("metric", "cosine")
        self.ground_truth = compute_ground_truth(
            self.train_vectors, self.test_vectors, self._gt_k(), self.metric,
            device=self.device,
        )
