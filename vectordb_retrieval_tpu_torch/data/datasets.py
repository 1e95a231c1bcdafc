"""Dataset manager: seeded random synthesis, exact ground truth, npz cache.

Counterpart of ``vectordb_retrieval_tpu/data/datasets.py``. Ground truth is
computed on the device with the port's exact search. The other loaders of
the catalog (glove50, sift1m, msmarco, surrogates, manifold) and the
out-of-core ``storage: memmap`` staging come with the data-layer slice,
ROADMAP queue 1 item 9.
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
        if self.name != "random":
            raise NotImplementedError(f"dataset {self.name!r} {_NOT_PORTED}")
        use_cache = bool(self.options.get("use_cache", True))
        if use_cache and self._load_cache():
            return self
        self._load_random()
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
