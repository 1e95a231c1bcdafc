"""Dataset manager: seeded synthesis, exact ground truth, npz cache.

Counterpart of ``vectordb_retrieval_tpu/data/datasets.py``. Ground truth is
computed on the device with the port's exact search. Ported loaders:
``random``, ``msmarco_surrogate`` and ``manifold`` (numpy only, so the same
seed gives the same vectors bit for bit in both packages). The other
loaders of the catalog (glove50, glove50_surrogate, sift1m, msmarco) and
the out-of-core ``storage: memmap`` staging come with the data-layer
slice, ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.data.storage import corpus_to_device, is_out_of_core
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device
from vectordb_retrieval_tpu_torch.utils.hashing import stable_hash

CACHE_KEY_VERSION = 3
# The port's own tag: its cache files never mix with the JAX package's.
GROUND_TRUTH_METHOD = "torch_exact_v1"

_NOT_PORTED = "is ported with the data layer, ROADMAP queue 1 item 9"


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
    scores as ip.
    """
    from vectordb_retrieval_tpu_torch.ops import distances as dops

    if is_out_of_core(train):
        raise NotImplementedError(f"ground truth over out-of-core corpora {_NOT_PORTED}")
    dev = resolve_device(device)
    x = corpus_to_device(train, device=dev)
    q = torch.as_tensor(np.ascontiguousarray(queries, dtype=np.float32), device=dev)
    if metric == "cosine" or normalize:
        x = dops.normalize(x)
        q = dops.normalize(q)
        metric = "ip"
    k = min(k, x.shape[0])
    _, ids = dops.exact_search(q, x, k, metric=metric, refine=True, device=dev)
    return ids.cpu().numpy().astype(np.int64)


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
    PORTED = ("random", "msmarco_surrogate", "manifold")

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

    def _load_cache(self) -> bool:
        path = self._cache_path()
        if not os.path.exists(path):
            return False
        try:
            with np.load(path, allow_pickle=False) as z:
                self.train_vectors = z["train"]
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
        path = self._cache_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez(
            tmp, train=self.train_vectors, test=self.test_vectors,
            gt=self.ground_truth,
        )
        os.replace(tmp, path)
        with open(path + ".json", "w") as f:
            json.dump(self.metadata, f, indent=2)

    # -- loading --------------------------------------------------------
    def load(self) -> "Dataset":
        if self.name not in self.CATALOG:
            raise ValueError(
                f"unknown dataset {self.name!r}; known: {self.CATALOG}"
            )
        if self.name not in self.PORTED:
            raise NotImplementedError(f"dataset {self.name!r} {_NOT_PORTED}")
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
        """Seeded gaussian synthesis (the same draws as the JAX package)."""
        if self.options.get("storage") == "memmap":
            raise NotImplementedError(f"'storage: memmap' {_NOT_PORTED}")
        dim = int(self.options.get("dimensions", 128))
        n_train = int(self.options.get("train_size", 10000))
        n_test = int(self.options.get("test_size", 1000))
        seed = int(self.options.get("seed", 42))
        rng = np.random.default_rng(seed)
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
