"""Parameter sweep: cartesian grids over algorithm knobs.

The sweep spec maps parameter names to value lists; each combination runs
a full experiment on the configured dataset; outputs are
``sweep_results.csv``, ``sweep_results.json`` (rows and the best-recall /
best-QPS / balanced analysis) and ``sweep_summary.md``.

    python -m vectordb_retrieval_tpu_torch.scripts.parameter_sweep \
        --config configs/sweep_example.yaml [--output-dir DIR] [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import json
import os
from datetime import datetime
from typing import Any, Dict, List, Optional

import yaml

from vectordb_retrieval_tpu_torch.bench.config import ExperimentConfig
from vectordb_retrieval_tpu_torch.bench.experiment import ExperimentRunner
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device


class ParameterSweepRunner:
    """Every combination of ``config["sweep"]`` over ``config["algorithm"]``,
    one experiment each on ``device`` (default: the CUDA card, raising
    without one)."""

    def __init__(self, config: Dict[str, Any], output_dir: str, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.rows: List[Dict[str, Any]] = []

    def _combinations(self) -> List[Dict[str, Any]]:
        sweep: Dict[str, List[Any]] = self.config["sweep"]
        keys = sorted(sweep)
        combos = []
        for values in itertools.product(*(sweep[k] for k in keys)):
            combos.append(dict(zip(keys, values)))
        return combos

    def run(self) -> List[Dict[str, Any]]:
        base_algo = dict(self.config["algorithm"])
        algo_name = self.config.get("algorithm_name", "swept")
        for idx, combo in enumerate(self._combinations()):
            algo_cfg = {**base_algo, **combo}
            exp = ExperimentConfig(
                dataset=self.config.get("dataset", "random"),
                data_dir=self.config.get("data_dir", "data"),
                dataset_options=self.config.get("dataset_options", {}),
                n_queries=self.config.get("n_queries", 256),
                topk=self.config.get("topk", 20),
                query_batch_size=self.config.get("query_batch_size", 0),
                seed=self.config.get("seed", 42),
                metric=self.config.get("metric"),
                algorithms={algo_name: algo_cfg},
            )
            out = os.path.join(self.output_dir, f"combo_{idx:04d}")
            runner = ExperimentRunner(exp, output_dir=out, device=self.device)
            results = runner.run()
            m = results.get(algo_name, {})
            row = {"combo": idx, **combo}
            for key in ("recall", "qps", "build_time_s", "index_memory_mb",
                        "mean_query_time_ms", "error"):
                if key in m:
                    row[key] = m[key]
            self.rows.append(row)
            print(f"combo {idx}: {combo} -> recall={m.get('recall')} qps={m.get('qps')}")
        self._write_outputs()
        return self.rows

    def _best(self, key: str) -> Dict[str, Any]:
        ok = [r for r in self.rows if "error" not in r and r.get(key) is not None]
        return max(ok, key=lambda r: r[key]) if ok else {}

    def _balanced(self) -> Dict[str, Any]:
        ok = [
            r
            for r in self.rows
            if "error" not in r and r.get("recall") and r.get("qps")
        ]
        if not ok:
            return {}
        max_qps = max(r["qps"] for r in ok)
        return max(ok, key=lambda r: r["recall"] * (r["qps"] / max_qps) ** 0.5)

    def _write_outputs(self) -> None:
        if not self.rows:
            return
        fieldnames = sorted({k for r in self.rows for k in r})
        with open(os.path.join(self.output_dir, "sweep_results.csv"), "w",
                  newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fieldnames)
            writer.writeheader()
            writer.writerows(self.rows)
        analysis = {
            "best_recall": self._best("recall"),
            "best_qps": self._best("qps"),
            "balanced": self._balanced(),
            "n_combinations": len(self.rows),
            "timestamp": datetime.now().isoformat(),
        }
        with open(os.path.join(self.output_dir, "sweep_results.json"), "w") as f:
            json.dump({"rows": self.rows, "analysis": analysis}, f, indent=2,
                      default=str)
        lines = ["# Parameter sweep", "", f"Combinations: {len(self.rows)}", ""]
        lines.append("| " + " | ".join(fieldnames) + " |")
        lines.append("|" + "---|" * len(fieldnames))
        for r in self.rows:
            lines.append(
                "| " + " | ".join(str(r.get(k, "")) for k in fieldnames) + " |"
            )
        for label, best in (
            ("Best recall", analysis["best_recall"]),
            ("Best QPS", analysis["best_qps"]),
            ("Balanced", analysis["balanced"]),
        ):
            lines.append("")
            lines.append(f"**{label}:** `{best}`")
        with open(os.path.join(self.output_dir, "sweep_summary.md"), "w") as f:
            f.write("\n".join(lines))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Parameter sweep")
    parser.add_argument("--config", required=True)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = yaml.safe_load(f)
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    out = args.output_dir or os.path.join(
        config.get("output_dir", "sweep_results"), f"sweep_{stamp}"
    )
    ParameterSweepRunner(config, out, device=args.device).run()
    print(f"sweep results in {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
