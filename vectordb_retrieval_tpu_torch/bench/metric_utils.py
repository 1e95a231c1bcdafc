"""Metric aggregation over a k-grid + cross-algorithm comparison plots.

Parity with reference src/benchmark/metric_utils.py:6-133:
``evaluate_all_metrics`` computes every retrieval metric at each cutoff,
``plot_metrics_by_k`` renders per-metric curves, ``compare_algorithms_plot``
overlays algorithms, ``metrics_text_summary`` renders a text table.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from vectordb_retrieval_tpu_torch.bench import metrics as M

DEFAULT_K_GRID = (1, 5, 10, 20, 50, 100)


def evaluate_all_metrics(
    ground_truth: np.ndarray,
    predicted: np.ndarray,
    k_values: Iterable[int] = DEFAULT_K_GRID,
) -> Dict[str, float]:
    """All quality metrics over a k-grid (reference metric_utils.py:6-48)."""
    out: Dict[str, float] = {}
    max_k = predicted.shape[1]
    for k in k_values:
        if k > max_k:
            continue
        out[f"recall@{k}"] = M.recall_at_k(ground_truth, predicted, k)
        out[f"precision@{k}"] = M.precision_at_k(ground_truth, predicted, k)
        out[f"ndcg@{k}"] = M.ndcg_at_k(ground_truth, predicted, k)
        out[f"hit_rate@{k}"] = M.hit_rate_at_k(ground_truth, predicted, k)
    out["map"] = M.mean_average_precision(ground_truth, predicted)
    out["mrr"] = M.mean_reciprocal_rank(ground_truth, predicted)
    return out


def _metric_curve(
    results: Dict[str, float], metric: str
) -> List[tuple]:
    pts = []
    for key, val in results.items():
        if key.startswith(f"{metric}@"):
            try:
                pts.append((int(key.split("@")[1]), float(val)))
            except ValueError:
                continue
    return sorted(pts)


def plot_metrics_by_k(
    results: Dict[str, float],
    output_file: str,
    metrics: Iterable[str] = ("recall", "precision", "ndcg", "hit_rate"),
) -> bool:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    plotted = False
    for metric in metrics:
        pts = _metric_curve(results, metric)
        if pts:
            ks, vals = zip(*pts)
            ax.plot(ks, vals, marker="o", label=metric)
            plotted = True
    if not plotted:
        plt.close(fig)
        return False
    ax.set_xlabel("k")
    ax.set_ylabel("metric value")
    ax.set_xscale("log")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(output_file, dpi=120)
    plt.close(fig)
    return True


def compare_algorithms_plot(
    all_results: Dict[str, Dict[str, float]],
    output_file: str,
    metric: str = "recall",
) -> bool:
    """Overlay one metric-vs-k curve per algorithm (metric_utils.py:80-110)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    plotted = False
    for alg, results in sorted(all_results.items()):
        pts = _metric_curve(results, metric)
        if pts:
            ks, vals = zip(*pts)
            ax.plot(ks, vals, marker="o", label=alg)
            plotted = True
    if not plotted:
        plt.close(fig)
        return False
    ax.set_xlabel("k")
    ax.set_ylabel(metric)
    ax.set_xscale("log")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(output_file, dpi=120)
    plt.close(fig)
    return True


def metrics_text_summary(
    all_results: Dict[str, Dict[str, float]],
    keys: Optional[List[str]] = None,
) -> str:
    if not all_results:
        return "(no results)"
    if keys is None:
        keys = sorted({k for r in all_results.values() for k in r})
    width = max(len(a) for a in all_results) + 2
    lines = [" " * width + "  ".join(f"{k:>14}" for k in keys)]
    for alg, r in sorted(all_results.items()):
        vals = "  ".join(
            f"{r.get(k, float('nan')):>14.4f}" if isinstance(r.get(k), (int, float))
            else f"{'-':>14}"
            for k in keys
        )
        lines.append(f"{alg:<{width}}{vals}")
    return "\n".join(lines)
