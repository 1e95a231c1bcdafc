"""Retrieval quality + latency metrics, vectorized.

Semantic parity with reference src/benchmark/metrics.py:4-262 (including its
quirks, which the committed baseline numbers depend on):

  * ``recall_at_k``    intersects ``pred[:, :k]`` with ``gt[:, :k]`` and
    divides by ``|gt[:, :k]|`` (metrics.py:26-33).
  * ``precision_at_k`` intersects ``pred[:, :k]`` with the FULL ground-truth
    set and divides by ``k`` (metrics.py:55-62).
  * MAP / NDCG / hit-rate / MRR use the full ground-truth set.

Implementation is vectorized NumPy (membership via broadcast compare instead
of Python set loops, reference hot loop (4) in SURVEY.md section 3.1); rows
are processed in query chunks to bound the [B, k, G] bool tensor.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

_CHUNK = 1024


def _membership(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Bool [B, P]: pred[i, j] in set(gt[i]). Ignores negative ids in gt."""
    b = pred.shape[0]
    out = np.zeros(pred.shape, dtype=bool)
    for start in range(0, b, _CHUNK):
        end = min(start + _CHUNK, b)
        p = pred[start:end, :, None]
        g = gt[start:end, None, :]
        out[start:end] = ((p == g) & (g >= 0)).any(axis=2)
    return out


def _first_occurrence(a: np.ndarray) -> np.ndarray:
    """Bool [B, A]: True where a[i, j] is the first occurrence in its row."""
    b, width = a.shape
    out = np.ones(a.shape, dtype=bool)
    for start in range(0, b, _CHUNK):
        end = min(start + _CHUNK, b)
        eq = a[start:end, :, None] == a[start:end, None, :]  # [c, j, i]
        earlier = np.tril(np.ones((width, width), dtype=bool), k=-1)[None]
        out[start:end] = ~np.any(eq & earlier, axis=2)
    return out


def _intersection_size(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-row ``|set(a) & set(b)|`` ignoring negative ids."""
    member = _membership(a, b)
    uniq = _first_occurrence(a)
    return (member & uniq & (a >= 0)).sum(axis=1)


def _gt_set_sizes(gt: np.ndarray) -> np.ndarray:
    """Per-row count of unique non-negative ground-truth ids."""
    return (_first_occurrence(gt) & (gt >= 0)).sum(axis=1)


def recall_at_k(ground_truth: np.ndarray, predicted: np.ndarray, k: int) -> float:
    k = min(k, predicted.shape[1])
    gt_k = ground_truth[:, :k] if ground_truth.shape[1] >= k else ground_truth
    hits = _intersection_size(gt_k, predicted[:, :k]).astype(np.float64)
    denom = _gt_set_sizes(gt_k).astype(np.float64)
    recalls = np.where(denom > 0, hits / np.maximum(denom, 1), 0.0)
    return float(np.mean(recalls))


def precision_at_k(ground_truth: np.ndarray, predicted: np.ndarray, k: int) -> float:
    k = min(k, predicted.shape[1])
    hits = _intersection_size(predicted[:, :k], ground_truth)
    return float(np.mean(hits / float(k)))


def mean_average_precision(
    ground_truth: np.ndarray, predicted: np.ndarray, k: Optional[int] = None
) -> float:
    k = predicted.shape[1] if k is None else min(k, predicted.shape[1])
    rel = _membership(predicted[:, :k], ground_truth).astype(np.float64)
    ranks = np.arange(1, k + 1, dtype=np.float64)[None, :]
    cum_rel = np.cumsum(rel, axis=1)
    prec_at_hit = (cum_rel / ranks) * rel
    denom = _gt_set_sizes(ground_truth).astype(np.float64)
    aps = np.where(denom > 0, prec_at_hit.sum(axis=1) / np.maximum(denom, 1), 0.0)
    return float(np.mean(aps))


def ndcg_at_k(ground_truth: np.ndarray, predicted: np.ndarray, k: int) -> float:
    k = min(k, predicted.shape[1])
    rel = _membership(predicted[:, :k], ground_truth).astype(np.float64)
    discounts = 1.0 / np.log2(np.arange(2, k + 2, dtype=np.float64))
    dcg = (rel * discounts[None, :]).sum(axis=1)
    gt_sizes = np.minimum(_gt_set_sizes(ground_truth), k)
    cum_disc = np.concatenate([[0.0], np.cumsum(discounts)])
    idcg = cum_disc[gt_sizes]
    scores = np.where(idcg > 0, dcg / np.maximum(idcg, 1e-12), 0.0)
    return float(np.mean(scores))


def hit_rate_at_k(ground_truth: np.ndarray, predicted: np.ndarray, k: int) -> float:
    k = min(k, predicted.shape[1])
    hits = _membership(predicted[:, :k], ground_truth).any(axis=1)
    return float(np.mean(hits))


def mean_reciprocal_rank(
    ground_truth: np.ndarray, predicted: np.ndarray, k: Optional[int] = None
) -> float:
    k = predicted.shape[1] if k is None else min(k, predicted.shape[1])
    rel = _membership(predicted[:, :k], ground_truth)
    first = np.argmax(rel, axis=1)
    any_hit = rel.any(axis=1)
    rr = np.where(any_hit, 1.0 / (first + 1.0), 0.0)
    return float(np.mean(rr))


def compute_cost_latency(timing_data: Sequence[float]) -> Dict[str, float]:
    t = np.asarray(list(timing_data), dtype=np.float64)
    if t.size == 0:
        return {k: 0.0 for k in ("mean", "median", "p95", "p99", "min", "max")}
    return {
        "mean": float(np.mean(t)),
        "median": float(np.median(t)),
        "p95": float(np.percentile(t, 95)),
        "p99": float(np.percentile(t, 99)),
        "min": float(np.min(t)),
        "max": float(np.max(t)),
    }


def vector_similarity_count(
    dataset_size: int, query_count: int, algorithm_type: str = "exhaustive"
) -> int:
    """Analytic distance-op estimate (reference metrics.py:240-262)."""
    if algorithm_type == "exhaustive":
        return query_count * dataset_size
    if algorithm_type == "approximate":
        return query_count * int(np.ceil(np.log2(max(dataset_size, 2))))
    raise ValueError(f"Unsupported algorithm type: {algorithm_type}")
