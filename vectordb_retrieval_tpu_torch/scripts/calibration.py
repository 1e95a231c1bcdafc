"""What the calibration tools share: recall@k of algorithm rows on a
loaded corpus, each built and searched on one device.

``recall_rows`` runs ``CompositeAlgorithm`` rows (the surrogate
calibrations); ``factory_recall`` builds one ``FactoryIndexer`` artifact
and searches it with an ``ANNSearcher`` (the manifold calibration and the
rotations A/B). ``batch_search`` returns host arrays, so a clock read after
either has waited for the card.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
from vectordb_retrieval_tpu_torch.models.base import IndexArtifact
from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher, FactoryIndexer
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike


def recall_rows(
    x: np.ndarray,
    q: np.ndarray,
    gt: np.ndarray,
    algos: Dict[str, Tuple[Dict[str, Any], Dict[str, Any]]],
    metric: str,
    k: int,
    device: DeviceLike,
) -> Dict[str, float]:
    """name -> recall@k of each ``(indexer, searcher)`` row."""
    out = {}
    for name, (idx, srch) in algos.items():
        algo = CompositeAlgorithm(
            dimension=x.shape[1], indexer=idx, searcher=srch, metric=metric,
            device=device,
        )
        algo.build_index(x)
        _, ids = algo.batch_search(q, k)
        out[name] = recall_at_k(gt, ids, k)
    return out


def factory_recall(
    x: np.ndarray,
    q: np.ndarray,
    gt: np.ndarray,
    index_key: str,
    k: int,
    device: DeviceLike,
    nprobe: Optional[int] = None,
    **indexer_kw: Any,
) -> Tuple[float, IndexArtifact, float, float]:
    """``(recall@k, artifact, build seconds, build + search seconds)`` of
    one l2 ``FactoryIndexer`` artifact searched by an ``ANNSearcher``
    (its default probe count unless ``nprobe``)."""
    t0 = time.time()
    art = FactoryIndexer(
        metric="l2", index_key=index_key, device=device, **indexer_kw
    ).build(x, x.shape[1])
    build_s = time.time() - t0
    s = ANNSearcher(metric="l2", device=device, **({"nprobe": nprobe} if nprobe else {}))
    s.attach(art)
    _, ids = s.batch_search(q, k)
    return float(recall_at_k(gt, np.asarray(ids), k)), art, build_s, time.time() - t0
