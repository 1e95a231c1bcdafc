"""Core contracts: algorithm ABC, index artifact, indexer/searcher registries.

Counterpart of ``vectordb_retrieval_tpu/models/base.py``. An
``IndexArtifact`` holds a dict of tensors on one device plus host metadata;
:func:`artifact_from_numpy` carries the JAX package's artifacts (their
leaves taken as numpy arrays) across under the same key names, and
``models/persist.py`` saves and loads them in the JAX package's on-disk
format.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
    resolve_devices,
)
from vectordb_retrieval_tpu_torch.utils.profiling import span


@dataclass
class IndexArtifact:
    """A built index: ``kind`` discriminates the payload schema.

    ``data`` holds tensors; ``metadata`` holds static, host-side facts
    (metric, dimension, counts, knobs) that searchers need.
    """

    kind: str
    data: Dict[str, torch.Tensor]
    metadata: Dict[str, Any] = field(default_factory=dict)

    def device_nbytes(self) -> int:
        """Total bytes of the artifact's tensors (a sharded array's: each
        tensor once, ``parallel/mesh.ShardedTensor.device_nbytes``)."""
        return sum(
            t.device_nbytes() if hasattr(t, "device_nbytes") else int(t.numel() * t.element_size())
            for t in self.data.values()
        )


BF16_SUFFIX = ".bf16"


def leaf_to_tensor(
    key: str, arr: Any, device: torch.device
) -> Tuple[str, torch.Tensor]:
    """One stored leaf as ``(key, tensor on device)``.

    bf16 arrives either as raw 16-bit words under ``key + ".bf16"`` (the
    persisted format) or as a numpy array whose dtype is named
    ``bfloat16`` (a JAX array taken with ``np.asarray``); both become
    ``torch.bfloat16`` through an ``int16`` view of the bits, so no
    bfloat16 numpy type is needed. uint32 leaves become ``int32`` views of
    the same bits.
    """
    if isinstance(arr, torch.Tensor):
        return key, arr.to(device)
    arr = np.ascontiguousarray(arr)
    if key.endswith(BF16_SUFFIX):
        key = key[: -len(BF16_SUFFIX)]
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{key}{BF16_SUFFIX}: expected 16-bit words, got {arr.dtype}")
        return key, torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    if arr.dtype.name == "bfloat16":
        return key, torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    if arr.dtype == np.uint32:  # int32 views: torch's uint32 has no CPU shifts
        return key, torch.from_numpy(arr.view(np.int32)).to(device)
    return key, torch.as_tensor(arr, device=device)


def artifact_from_numpy(
    kind: str,
    data: Dict[str, np.ndarray],
    metadata: Dict[str, Any],
    device: DeviceLike = None,
) -> IndexArtifact:
    """Build an artifact from numpy leaves (e.g. a JAX-built artifact's
    ``{k: np.asarray(v)}``), uploaded to ``device``. bf16 leaves may be
    bfloat16 arrays or uint16 views under a ``.bf16`` key suffix."""
    dev = resolve_device(device)
    return IndexArtifact(
        kind=kind,
        data=dict(leaf_to_tensor(k, v, dev) for k, v in data.items()),
        metadata=dict(metadata),
    )


class BaseAlgorithm(ABC):
    """Common interface every retrieval algorithm implements:
    ``build_index``, ``search``, ``batch_search``, operation counters and
    the optional ``save_index``/``load_index`` persistence hooks."""

    def __init__(self, dimension: int, metric: str = "l2", **params: Any):
        self.dimension = int(dimension)
        self.metric = metric
        self.params: Dict[str, Any] = dict(params)
        self.name = self.__class__.__name__
        self.is_built = False
        self._operations: Dict[str, int] = {}

    # -- build/search ---------------------------------------------------
    @abstractmethod
    def build_index(self, vectors: np.ndarray) -> None:
        """Build the index over ``vectors [N, d]``."""

    @abstractmethod
    def batch_search(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Return ``(distances [B, k], indices [B, k])``, ascending distance."""

    def search(self, query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Single query convenience; defaults to a batch of one."""
        q = np.asarray(query, dtype=np.float32).reshape(1, -1)
        d, i = self.batch_search(q, k)
        return d[0], i[0]

    # -- operation counters ---------------------------------------------
    def record_operation(self, key: str, value: int = 1) -> None:
        self._operations[key] = self._operations.get(key, 0) + int(value)

    def get_operations(self) -> Dict[str, int]:
        return dict(self._operations)

    def reset_operations(self) -> None:
        self._operations = {}

    # -- persistence hooks ----------------------------------------------
    def save_index(self, path: str, context: Optional[Dict[str, Any]] = None) -> None:
        raise NotImplementedError(f"{self.name} does not support save_index")

    def load_index(self, path: str, context: Optional[Dict[str, Any]] = None) -> None:
        raise NotImplementedError(f"{self.name} does not support load_index")

    @property
    def supports_persistence(self) -> bool:
        return type(self).save_index is not BaseAlgorithm.save_index

    # -- reporting ------------------------------------------------------
    def get_parameters(self) -> Dict[str, Any]:
        return {"name": self.name, "metric": self.metric, **self.params}

    def index_memory_bytes(self) -> int:
        """Device footprint of the artifact, where there is one."""
        art = getattr(self, "artifact", None)
        if isinstance(art, IndexArtifact):
            return art.device_nbytes()
        return 0


class BaseIndexer(ABC):
    """Builds an :class:`IndexArtifact` from raw vectors on ``device`` (a
    list of devices: the first; the row-sharded indexers build their mesh
    over ``devices``)."""

    def __init__(self, metric: str = "l2", device: DeviceLike = None, **params: Any):
        self.metric = metric
        self.device = resolve_device(device)
        self.devices = resolve_devices(device)
        self.params = dict(params)

    @abstractmethod
    def build(self, vectors: np.ndarray, dimension: int) -> IndexArtifact:
        ...

    def describe(self) -> Dict[str, Any]:
        return {"type": self.__class__.__name__, "metric": self.metric, **self.params}


class BaseSearcher(ABC):
    """Attaches to an artifact on ``device`` and serves batched queries (a
    loaded row-sharded artifact is placed over a mesh of ``devices``)."""

    def __init__(self, metric: str = "l2", device: DeviceLike = None, **params: Any):
        self.metric = metric
        self.device = resolve_device(device)
        self.devices = resolve_devices(device)
        self.params = dict(params)
        self.artifact: Optional[IndexArtifact] = None

    @abstractmethod
    def attach(self, artifact: IndexArtifact) -> None:
        ...

    @abstractmethod
    def device_kernel(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device queries in, device ``(dists, ids)`` out; no host copy."""

    def batch_search(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        if self.artifact is None:
            raise RuntimeError("searcher not attached")
        dists, ids, _ = host_search(lambda q: self.device_kernel(q, k), queries, k, self.device)
        return dists, ids

    def search(self, query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        d, i = self.batch_search(
            np.asarray(query, dtype=np.float32).reshape(1, -1), k
        )
        return d[0], i[0]

    def describe(self) -> Dict[str, Any]:
        return {"type": self.__class__.__name__, "metric": self.metric, **self.params}

    def estimated_ops_per_query(self, n_database: int) -> int:
        """Analytic distance-op estimate."""
        return int(n_database)


def host_search(
    device_part: Callable[[torch.Tensor], Tuple[Any, ...]],
    queries: np.ndarray,
    k: int,
    device: torch.device,
) -> Tuple[np.ndarray, np.ndarray, Tuple[Any, ...]]:
    """The host entry of every search: upload the host queries as float32
    to ``device`` (``vrt.h2d``), run ``device_part`` on them
    (``vrt.search``; it returns device ``(dists, ids, *extra)``), then copy
    dists and int64 ids back and pad them to ``k`` columns with ``inf`` /
    ``-1`` (``vrt.d2h``: the wait for the card and the copies). Returns
    ``(dists [B, k], ids [B, k], extra)``."""
    with span("vrt.h2d"):
        q = torch.as_tensor(np.ascontiguousarray(queries, dtype=np.float32), device=device)
    with span("vrt.search"):
        dists, ids, *extra = device_part(q)
    with span("vrt.d2h"):
        out_d = dists.cpu().numpy()
        out_i = ids.cpu().numpy().astype(np.int64, copy=False)
        if out_d.shape[1] < k:
            pad = ((0, 0), (0, k - out_d.shape[1]))
            out_d = np.pad(out_d, pad, constant_values=np.inf)
            out_i = np.pad(out_i, pad, constant_values=-1)
    return out_d, out_i, tuple(extra)


def check_artifact_device(artifact: IndexArtifact, device: torch.device) -> None:
    """Raise unless every tensor of ``artifact`` lies on ``device``."""
    for key, t in artifact.data.items():
        if isinstance(t, torch.Tensor) and t.device != device:
            raise ValueError(f"artifact tensor {key!r} lives on {t.device}, searcher on {device}")


INDEXER_REGISTRY: Dict[str, Type[BaseIndexer]] = {}
SEARCHER_REGISTRY: Dict[str, Type[BaseSearcher]] = {}


def register_indexer(name: str) -> Callable[[Type[BaseIndexer]], Type[BaseIndexer]]:
    def deco(cls: Type[BaseIndexer]) -> Type[BaseIndexer]:
        INDEXER_REGISTRY[name] = cls
        return cls

    return deco


def register_searcher(name: str) -> Callable[[Type[BaseSearcher]], Type[BaseSearcher]]:
    def deco(cls: Type[BaseSearcher]) -> Type[BaseSearcher]:
        SEARCHER_REGISTRY[name] = cls
        return cls

    return deco


def pad_batch(queries: np.ndarray, buckets: Tuple[int, ...] = ()) -> Tuple[np.ndarray, int]:
    """Pad a query batch up to a size bucket (powers of two by default).

    Returns the padded batch and the original row count; real rows come
    first so results slice cleanly.
    """
    b = queries.shape[0]
    target = 1
    while target < b:
        target *= 2
    for bucket in buckets:
        if bucket >= b:
            target = bucket
            break
    if target == b:
        return queries, b
    pad = np.zeros((target - b, queries.shape[1]), dtype=queries.dtype)
    return np.concatenate([queries, pad], axis=0), b


def _to_host(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def timed_blocking(fn: Callable[[], Any]) -> Tuple[Any, float]:
    """Run ``fn``, wait for the card's queued work, copy tensor results to
    host; return (result, seconds). The clock stops with the results on the
    host."""
    start = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out = _to_host(out)
    return out, time.perf_counter() - start
