"""Evaluator: per-algorithm retrieval quality + latency metrics, and plots.

Metric-key parity with reference src/benchmark/evaluation.py:31-66
(``recall@k``/``precision@k`` over k in {1,10,100} plus user cutoffs,
``map@10``, ``qps`` = 1/mean(query_times), query-time stats in ms) and the
operations-vs-recall metric fallback chain (evaluation.py:68-120).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from vectordb_retrieval_tpu_torch.bench.metrics import (
    mean_average_precision,
    precision_at_k,
    recall_at_k,
)


class Evaluator:
    def __init__(
        self, ground_truth: np.ndarray, k_values: Optional[Iterable[int]] = None
    ):
        self.ground_truth = np.asarray(ground_truth)
        default = {1, 10, 100}
        if k_values is not None:
            default.update(int(k) for k in k_values)
        self.k_values = sorted(default)
        self.results: Dict[str, Dict[str, Any]] = {}

    def evaluate(
        self,
        algorithm_name: str,
        predicted_indices: np.ndarray,
        query_times: np.ndarray,
    ) -> Dict[str, Any]:
        predicted_indices = np.asarray(predicted_indices)
        query_times = np.asarray(query_times, dtype=np.float64)
        m: Dict[str, Any] = {}
        for k in self.k_values:
            if k <= predicted_indices.shape[1]:
                m[f"recall@{k}"] = recall_at_k(self.ground_truth, predicted_indices, k)
                m[f"precision@{k}"] = precision_at_k(
                    self.ground_truth, predicted_indices, k
                )
        if predicted_indices.shape[1] >= 10:
            m["map@10"] = mean_average_precision(
                self.ground_truth, predicted_indices, 10
            )
        mean_t = float(np.mean(query_times)) if query_times.size else 0.0
        m["qps"] = (1.0 / mean_t) if mean_t > 0 else 0.0
        m["mean_query_time"] = mean_t * 1000.0
        m["median_query_time"] = float(np.median(query_times)) * 1000.0 if query_times.size else 0.0
        m["min_query_time"] = float(np.min(query_times)) * 1000.0 if query_times.size else 0.0
        m["max_query_time"] = float(np.max(query_times)) * 1000.0 if query_times.size else 0.0
        self.results[algorithm_name] = m
        return m

    # -- operations metric resolution (reference evaluation.py:68-120) ---
    def _resolve_operations_metric(
        self, algorithms: List[str]
    ) -> Tuple[str, List[float], str]:
        candidates = [
            ("operations_per_query", "Operations / Query"),
            ("operation_count", "Operations"),
            ("distance_computations", "Distance Computations"),
            ("distance_operations", "Distance Operations"),
            ("mean_query_time_ms", "Mean Query Time (ms)"),
            ("mean_query_time", "Mean Query Time (ms)"),
            ("total_query_time_s", "Total Query Time (s)"),
        ]
        for key, label in candidates:
            values: List[float] = []
            for alg in algorithms:
                raw = self.results.get(alg, {}).get(key)
                try:
                    val = float(raw) if raw is not None else None
                except (TypeError, ValueError):
                    val = None
                if val is None or not np.isfinite(val):
                    values = []
                    break
                values.append(val)
            if values:
                return key, values, label
        derived: List[float] = []
        for alg in algorithms:
            try:
                qps = float(self.results.get(alg, {}).get("qps") or 0.0)
            except (TypeError, ValueError):
                qps = 0.0
            if qps <= 0:
                return "qps", [], "Mean Query Time (ms, derived from QPS)"
            derived.append(1000.0 / qps)
        return "qps", derived, "Mean Query Time (ms, derived from QPS)"

    def print_results(self) -> None:
        """Console summary table (reference evaluation.py print_results)."""
        if not self.results:
            print("No evaluation results available.")
            return
        from vectordb_retrieval_tpu_torch.bench.metric_utils import (
            metrics_text_summary,
        )

        order = [f"recall@{k}" for k in self.k_values] + [
            f"precision@{k}" for k in self.k_values
        ] + ["map@10", "qps", "mean_query_time", "median_query_time"]
        keys = [
            m for m in order if any(m in r for r in self.results.values())
        ]
        print("\nEvaluation Results:\n")
        print(metrics_text_summary(self.results, keys=keys))

    # -- plots -----------------------------------------------------------
    def plot_recall_vs_qps(self, output_file: str, k: int = 10) -> bool:
        """Recall@k vs QPS scatter (reference evaluation.py:147-210)."""
        algorithms = [
            a for a in self.results if f"recall@{k}" in self.results[a]
        ]
        if not algorithms:
            return False
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 6))
        for alg in algorithms:
            r = self.results[alg]
            ax.scatter(r["qps"], r[f"recall@{k}"], label=alg, s=60)
        ax.set_xscale("log")
        ax.set_xlabel("Queries per second (log scale)")
        ax.set_ylabel(f"Recall@{k}")
        ax.set_title(f"Recall@{k} vs QPS")
        ax.grid(True, alpha=0.3)
        ax.legend()
        fig.tight_layout()
        fig.savefig(output_file, dpi=120)
        plt.close(fig)
        return True

    def plot_operations_vs_recall(self, output_file: str, k: int = 10) -> bool:
        """Operations (or fallback metric) vs recall plot
        (reference evaluation.py:212-276)."""
        algorithms = [
            a for a in self.results if f"recall@{k}" in self.results[a]
        ]
        if not algorithms:
            return False
        key, values, label = self._resolve_operations_metric(algorithms)
        if not values:
            return False
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 6))
        recalls = [self.results[a][f"recall@{k}"] for a in algorithms]
        for alg, x, y in zip(algorithms, values, recalls):
            ax.scatter(x, y, label=alg, s=60)
        ax.set_xscale("log")
        ax.set_xlabel(f"{label} (log scale)")
        ax.set_ylabel(f"Recall@{k}")
        ax.set_title(f"Cost vs Recall@{k}")
        ax.grid(True, alpha=0.3)
        ax.legend()
        fig.tight_layout()
        fig.savefig(output_file, dpi=120)
        plt.close(fig)
        return True
