"""Statistical algorithm comparison: repeated runs and significance tests.

Runs every algorithm of a benchmark config's first dataset ``--runs``
times with shifted seeds; writes descriptive statistics, pairwise Welch
t-tests and Mann-Whitney U tests on QPS (scipy), ``comparison_stats.json``,
``comparison_summary.md`` and, where matplotlib is installed, an error-bar
plot.

    python -m vectordb_retrieval_tpu_torch.scripts.compare_algorithms \
        --config configs/benchmark_config_smoke.yaml --runs 3 [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np
import yaml

from vectordb_retrieval_tpu_torch.bench.config import ExperimentConfig
from vectordb_retrieval_tpu_torch.bench.experiment import ExperimentRunner
from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device


class AlgorithmComparator:
    """``n_runs`` experiments of every algorithm of a benchmark config's
    first dataset, seed shifted by one each run, on ``device`` (default: the
    CUDA card, raising without one); descriptive statistics and pairwise
    significance tests on QPS."""

    def __init__(self, config: Dict[str, Any], n_runs: int, output_dir: str,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        self.n_runs = n_runs
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        # per-algorithm metric samples across runs
        self.samples: Dict[str, Dict[str, List[float]]] = {}

    def run(self) -> Dict[str, Any]:
        ds_entry = self.config.get("datasets", ["random"])[0]
        if isinstance(ds_entry, str):
            ds_entry = {"name": ds_entry}
        base_seed = int(self.config.get("seed", 42))

        # resolve modular refs once via a throw-away runner
        tmp_cfg = os.path.join(self.output_dir, "_cfg.yaml")
        with open(tmp_cfg, "w") as f:
            yaml.dump(self.config, f)
        resolver = BenchmarkRunner(tmp_cfg, output_dir=os.path.join(self.output_dir, "_r"),
                                   device=self.device)
        merged = dict(self.config.get("algorithms", {}))
        for name, override in (ds_entry.get("algorithms") or {}).items():
            merged[name] = {**merged.get(name, {}), **(override or {})}
        algorithms = resolver._resolve_modular_components(merged)

        for run_idx in range(self.n_runs):
            seed = base_seed + run_idx  # shifted seeds
            exp = ExperimentConfig(
                dataset=ds_entry["name"],
                data_dir=self.config.get("data_dir", "data"),
                dataset_options=ds_entry.get(
                    "dataset_options", self.config.get("dataset_options", {})
                ),
                n_queries=ds_entry.get("n_queries", self.config.get("n_queries", 256)),
                topk=ds_entry.get("topk", self.config.get("topk", 20)),
                query_batch_size=self.config.get("query_batch_size", 0),
                seed=seed,
                metric=ds_entry.get("metric", self.config.get("metric")),
                algorithms=algorithms,
            )
            runner = ExperimentRunner(
                exp, output_dir=os.path.join(self.output_dir, f"run_{run_idx}"),
                device=self.device,
            )
            results = runner.run()
            for alg, m in results.items():
                if "error" in m:
                    continue
                store = self.samples.setdefault(alg, {})
                for key in ("recall", "qps", "build_time_s", "mean_query_time_ms"):
                    if m.get(key) is not None:
                        store.setdefault(key, []).append(float(m[key]))
        report = self._analyze()
        self._write(report)
        return report

    def _analyze(self) -> Dict[str, Any]:
        stats: Dict[str, Any] = {}
        for alg, metrics in self.samples.items():
            stats[alg] = {
                key: {
                    "mean": float(np.mean(v)),
                    "std": float(np.std(v, ddof=1)) if len(v) > 1 else 0.0,
                    "min": float(np.min(v)),
                    "max": float(np.max(v)),
                    "n": len(v),
                }
                for key, v in metrics.items()
            }
        tests: Dict[str, Any] = {}
        try:
            from scipy import stats as sps

            for a, b in itertools.combinations(sorted(self.samples), 2):
                va = self.samples[a].get("qps", [])
                vb = self.samples[b].get("qps", [])
                if len(va) > 1 and len(vb) > 1:
                    t = sps.ttest_ind(va, vb, equal_var=False)
                    u = sps.mannwhitneyu(va, vb, alternative="two-sided")
                    tests[f"{a}_vs_{b}"] = {
                        "t_stat": float(t.statistic),
                        "t_pvalue": float(t.pvalue),
                        "u_stat": float(u.statistic),
                        "u_pvalue": float(u.pvalue),
                    }
        except ImportError:
            tests["note"] = "scipy unavailable; significance tests skipped"
        return {
            "n_runs": self.n_runs,
            "statistics": stats,
            "significance": tests,
            "timestamp": datetime.now().isoformat(),
        }

    def _write(self, report: Dict[str, Any]) -> None:
        with open(os.path.join(self.output_dir, "comparison_stats.json"), "w") as f:
            json.dump(report, f, indent=2, default=str)
        lines = ["# Algorithm comparison", "", f"Runs per algorithm: {self.n_runs}", ""]
        lines.append("| Algorithm | Recall mean±std | QPS mean±std | Build s |")
        lines.append("|---|---|---|---|")
        for alg, s in sorted(report["statistics"].items()):
            r = s.get("recall", {})
            q = s.get("qps", {})
            bt = s.get("build_time_s", {})
            lines.append(
                f"| {alg} | {r.get('mean', 0):.4f}±{r.get('std', 0):.4f} "
                f"| {q.get('mean', 0):.1f}±{q.get('std', 0):.1f} "
                f"| {bt.get('mean', 0):.2f} |"
            )
        if report["significance"]:
            lines += ["", "## Pairwise significance (QPS)", ""]
            for pair, t in report["significance"].items():
                if isinstance(t, dict):
                    lines.append(
                        f"- {pair}: t p={t['t_pvalue']:.4f}, "
                        f"U p={t['u_pvalue']:.4f}"
                    )
                else:
                    lines.append(f"- {t}")
        with open(os.path.join(self.output_dir, "comparison_summary.md"), "w") as f:
            f.write("\n".join(lines))
        self._plot(report)

    def _plot(self, report: Dict[str, Any]) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        algs = sorted(report["statistics"])
        if not algs:
            return
        means = [report["statistics"][a].get("qps", {}).get("mean", 0) for a in algs]
        stds = [report["statistics"][a].get("qps", {}).get("std", 0) for a in algs]
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.bar(range(len(algs)), means, yerr=stds, capsize=4)
        ax.set_xticks(range(len(algs)))
        ax.set_xticklabels(algs, rotation=30, ha="right")
        ax.set_ylabel("QPS")
        ax.set_yscale("log")
        ax.set_title("QPS across runs (mean ± std)")
        fig.tight_layout()
        fig.savefig(os.path.join(self.output_dir, "qps_comparison.png"), dpi=120)
        plt.close(fig)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Compare algorithms statistically")
    parser.add_argument("--config", required=True)
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = yaml.safe_load(f)
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    out = args.output_dir or os.path.join("comparison_results", f"compare_{stamp}")
    AlgorithmComparator(config, args.runs, out, device=args.device).run()
    print(f"comparison results in {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
