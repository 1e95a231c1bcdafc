"""BenchmarkRunner: multi-dataset orchestration, YAML schema, reports.

Counterpart of ``vectordb_retrieval_tpu/bench/runner.py``, with the same
YAML schema and outputs:
  * global ``indexers:`` / ``searchers:`` component registries,
  * ``algorithms:`` entries referencing them via ``indexer_ref`` /
    ``searcher_ref`` or inline dicts (deep-merged),
  * ``datasets:`` entries as strings or dicts with per-dataset
    ``algorithms:`` overrides deep-merged over the base,
  * per-dataset error isolation,
  * outputs: per-dataset results JSON, all_results.json,
    benchmark_summary.md, one-page-summary.md + dependency-free SVG scatter.

The device is a constructor argument (``--device`` on the command line),
not a YAML key. Run as
``python -m vectordb_retrieval_tpu_torch.bench.runner --config <yaml>``.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
from datetime import datetime
from typing import Any, Dict, List, Optional

import torch
import yaml

from vectordb_retrieval_tpu_torch.bench.config import ExperimentConfig
from vectordb_retrieval_tpu_torch.bench.experiment import ExperimentRunner
from vectordb_retrieval_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
    resolve_devices,
)

logger = logging.getLogger("vectordb_retrieval_tpu_torch.benchmark")

# HBM3 bandwidth of the H100 SXM (NVIDIA data sheet, 700 W): a GB/s cell
# above it counts bytes that caches and reuse served, marked † in the summary
HBM_PEAK_GBPS = 3350.0

GLOBAL_KEYS = (
    "n_queries",
    "query_batch_size",
    "topk",
    "repeat",
    "seed",
    "data_dir",
    "metric",
)


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge; override wins; nested dicts merge."""
    out = copy.deepcopy(base)
    for key, val in (override or {}).items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = deep_merge(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out


class BenchmarkRunner:
    def __init__(
        self,
        config_file: str,
        output_dir: Optional[str] = None,
        device: DeviceLike = None,
    ):
        # a list of devices is a mesh's, for the row-sharded indexers; the
        # rest of the run takes the first
        self.devices = resolve_devices(device)
        self.device = resolve_device(device)
        with open(config_file, "r") as f:
            self.config: Dict[str, Any] = yaml.safe_load(f) or {}
        self.indexers: Dict[str, Any] = copy.deepcopy(self.config.get("indexers", {}))
        self.searchers: Dict[str, Any] = copy.deepcopy(
            self.config.get("searchers", {})
        )
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        base_out = output_dir or self.config.get("output_dir", "benchmark_results")
        prefix = self.config.get("output_prefix", "benchmark")
        self.output_dir = os.path.join(base_out, f"{prefix}_{stamp}")
        os.makedirs(self.output_dir, exist_ok=True)
        self.all_results: Dict[str, Dict[str, Any]] = {}
        self._setup_logging()

    def _setup_logging(self) -> None:
        """Console(INFO) + file(DEBUG) logging (reference runner.py:56-82)."""
        logger.setLevel(logging.DEBUG)
        logger.handlers = []
        console = logging.StreamHandler()
        console.setLevel(logging.INFO)
        console.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(console)
        fileh = logging.FileHandler(os.path.join(self.output_dir, "benchmark.log"))
        fileh.setLevel(logging.DEBUG)
        fileh.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(fileh)

    # -- component resolution (reference runner.py:217-299) --------------
    def _materialize_component(
        self,
        config: Dict[str, Any],
        ref_key: str,
        registry: Dict[str, Any],
        inline_key: str,
    ) -> Dict[str, Any]:
        """Resolve ``*_ref`` against the global registry, deep-merging any
        inline overrides on top of the referenced definition."""
        cfg = dict(config)
        ref = cfg.pop(ref_key, None)
        inline = cfg.pop(inline_key, None)
        if ref is not None:
            if ref not in registry:
                raise ValueError(
                    f"{ref_key} {ref!r} not found in global registry "
                    f"(known: {sorted(registry)})"
                )
            resolved = copy.deepcopy(registry[ref])
            if isinstance(inline, dict):
                resolved = deep_merge(resolved, inline)
            cfg[inline_key] = resolved
        elif isinstance(inline, dict):
            cfg[inline_key] = copy.deepcopy(inline)
        return cfg

    def _resolve_modular_components(
        self, algorithms: Dict[str, Any]
    ) -> Dict[str, Any]:
        resolved = {}
        for name, cfg in algorithms.items():
            if not isinstance(cfg, dict):
                raise ValueError(f"algorithm {name!r} config must be a dict")
            cfg = self._materialize_component(
                cfg, "indexer_ref", self.indexers, "indexer"
            )
            cfg = self._materialize_component(
                cfg, "searcher_ref", self.searchers, "searcher"
            )
            resolved[name] = cfg
        return resolved

    @staticmethod
    def _normalize_dataset_entry(entry: Any) -> Dict[str, Any]:
        """Accept ``"name"`` or ``{name: ..., ...}`` (reference runner.py:301-311)."""
        if isinstance(entry, str):
            return {"name": entry}
        if isinstance(entry, dict) and "name" in entry:
            return dict(entry)
        raise ValueError(f"invalid dataset entry: {entry!r}")

    # -- main loop --------------------------------------------------------
    def run(self) -> Dict[str, Dict[str, Any]]:
        datasets: List[Any] = self.config.get("datasets", ["random"])
        base_algorithms = self.config.get("algorithms", {})
        for entry in datasets:
            ds = self._normalize_dataset_entry(entry)
            name = ds["name"]
            logger.info("=== dataset %s ===", name)
            try:
                self.all_results[name] = self._run_dataset(ds, base_algorithms)
            except Exception as exc:  # per-dataset isolation
                logger.exception("dataset %s failed: %s", name, exc)
                self.all_results[name] = {"error": str(exc)}
            out = os.path.join(self.output_dir, f"{name}_results.json")
            with open(out, "w") as f:
                json.dump(self.all_results[name], f, indent=2, default=str)
        with open(os.path.join(self.output_dir, "all_results.json"), "w") as f:
            json.dump(self.all_results, f, indent=2, default=str)
        try:
            self._generate_summary_report()
            self._generate_one_page_summary()
        except Exception as exc:
            logger.warning("report generation failed: %s", exc)
        return self.all_results

    def _run_dataset(
        self, ds: Dict[str, Any], base_algorithms: Dict[str, Any]
    ) -> Dict[str, Any]:
        # Merge base algorithms with per-dataset overrides (runner.py:108-131).
        merged = copy.deepcopy(base_algorithms)
        for alg_name, override in (ds.get("algorithms") or {}).items():
            if alg_name in merged:
                merged[alg_name] = deep_merge(merged[alg_name], override or {})
            else:
                merged[alg_name] = copy.deepcopy(override or {})
        ds_metric = ds.get("metric", self.config.get("metric"))
        if ds_metric:
            for cfg in merged.values():
                if isinstance(cfg, dict):
                    cfg.setdefault("metric", ds_metric)
        resolved = self._resolve_modular_components(merged)

        kwargs: Dict[str, Any] = {
            "dataset": ds["name"],
            "dataset_options": ds.get(
                "dataset_options", self.config.get("dataset_options", {})
            ),
            "algorithms": resolved,
            "output_prefix": self.config.get("output_prefix", "benchmark"),
        }
        for key in GLOBAL_KEYS:
            val = ds.get(key, self.config.get(key))
            if val is not None:
                kwargs[key] = val
        config = ExperimentConfig(**kwargs)
        ds_out = os.path.join(self.output_dir, ds["name"])
        runner = ExperimentRunner(config, output_dir=ds_out, device=self.devices)
        runner.load_dataset()
        results = runner.run()
        # surface dataset provenance so reports can label surrogate rows
        # (they are difficulty-matched stand-ins, not real-data numbers)
        if runner.dataset is not None and runner.dataset.metadata.get(
            "surrogate"
        ):
            results["_dataset"] = {
                "surrogate": True,
                "surrogate_for": runner.dataset.metadata.get(
                    "surrogate_for", ""
                ),
            }
        return results

    # -- reports (reference runner.py:402-728) ----------------------------
    def _fmt(self, val: Any, spec: str = ".4f") -> str:
        try:
            return format(float(val), spec)
        except (TypeError, ValueError):
            return "-"

    def _generate_summary_report(self) -> None:
        lines = ["# Benchmark Summary", ""]
        lines.append(f"Generated: {datetime.now().isoformat()}")
        lines.append("")
        for ds_name, results in self.all_results.items():
            ds_meta = results.get("_dataset", {}) if isinstance(
                results, dict
            ) else {}
            label = ""
            if ds_meta.get("surrogate"):
                label = (
                    " (SURROGATE — difficulty-calibrated stand-in for "
                    f"{ds_meta.get('surrogate_for') or 'real data'}, "
                    "not real-data numbers)"
                )
            lines.append(f"## Dataset: {ds_name}{label}")
            lines.append("")
            if "error" in results:
                lines.append(f"**ERROR**: {results['error']}")
                lines.append("")
                continue
            lines.append(
                "| Algorithm | Recall | QPS | Mean query (ms) | Build (s) "
                "| Index mem (MB) | TFLOP/s | GB/s | Status |"
            )
            lines.append("|---|---|---|---|---|---|---|---|---|")
            for alg, m in results.items():
                if not isinstance(m, dict) or alg.startswith("_"):
                    continue
                status = m.get("status", "ok" if "error" not in m else "error")
                gbps = m.get("achieved_gbps")
                gbps_cell = self._fmt(gbps, ".1f")
                if isinstance(gbps, (int, float)) and gbps > HBM_PEAK_GBPS:
                    gbps_cell += " †"
                lines.append(
                    f"| {alg} | {self._fmt(m.get('recall'))} "
                    f"| {self._fmt(m.get('qps'), '.2f')} "
                    f"| {self._fmt(m.get('mean_query_time_ms'), '.4f')} "
                    f"| {self._fmt(m.get('build_time_s'), '.2f')} "
                    f"| {self._fmt(m.get('index_memory_mb'), '.2f')} "
                    f"| {self._fmt(m.get('achieved_tflops'), '.2f')} "
                    f"| {gbps_cell} "
                    f"| {status} |"
                )
            lines.append("")
            lines.append(
                "TFLOP/s and GB/s: the counted work of one batch of the row's "
                "device kernel (utils/profiling.cost_estimate: the kernel "
                "wrappers' operations and bytes from their shapes, each input "
                "read once and each output written once, plus the aten matrix "
                "products and the logical bytes of the aten ops around them) "
                "times the measured batches per second; '-' = no device "
                f"kernel. Run on {self._device_name()}. † marks rates above "
                f"the H100 SXM's {HBM_PEAK_GBPS:,.0f} GB/s HBM3 peak (data "
                "sheet): logical bytes that caches and reuse served, not "
                "bandwidth."
            )
            lines.append("")
        with open(os.path.join(self.output_dir, "benchmark_summary.md"), "w") as f:
            f.write("\n".join(lines))

    def _device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "the host CPU (counts only: its rates are no card's)"

    def _svg_scatter(
        self, points: List[Dict[str, Any]], title: str
    ) -> str:
        """Hand-rolled dependency-free QPS-vs-recall SVG (runner.py:523-662)."""
        import math

        width, height, pad = 640, 420, 60
        qps_vals = [p["qps"] for p in points if p["qps"] > 0]
        if not qps_vals:
            return "<svg xmlns='http://www.w3.org/2000/svg'/>"
        lo = math.floor(math.log10(min(qps_vals)))
        hi = math.ceil(math.log10(max(qps_vals))) or lo + 1
        if hi == lo:
            hi = lo + 1

        def x_of(q: float) -> float:
            return pad + (math.log10(max(q, 1e-9)) - lo) / (hi - lo) * (
                width - 2 * pad
            )

        def y_of(r: float) -> float:
            return height - pad - r * (height - 2 * pad)

        colors = [
            "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
            "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
        ]
        parts = [
            f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' "
            f"height='{height}'>",
            f"<text x='{width/2}' y='24' text-anchor='middle' "
            f"font-size='16'>{title}</text>",
            f"<line x1='{pad}' y1='{height-pad}' x2='{width-pad}' "
            f"y2='{height-pad}' stroke='black'/>",
            f"<line x1='{pad}' y1='{pad}' x2='{pad}' y2='{height-pad}' "
            f"stroke='black'/>",
        ]
        for exp in range(lo, hi + 1):
            x = x_of(10 ** exp)
            parts.append(
                f"<text x='{x}' y='{height-pad+20}' text-anchor='middle' "
                f"font-size='11'>1e{exp}</text>"
            )
        for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
            y = y_of(frac)
            parts.append(
                f"<text x='{pad-8}' y='{y+4}' text-anchor='end' "
                f"font-size='11'>{frac:.2f}</text>"
            )
        for i, p in enumerate(points):
            if p["qps"] <= 0:
                continue
            c = colors[i % len(colors)]
            x, y = x_of(p["qps"]), y_of(p["recall"])
            parts.append(f"<circle cx='{x}' cy='{y}' r='5' fill='{c}'/>")
            parts.append(
                f"<text x='{x+8}' y='{y-6}' font-size='11'>{p['name']}</text>"
            )
        parts.append(
            f"<text x='{width/2}' y='{height-12}' text-anchor='middle' "
            f"font-size='12'>QPS (log scale)</text>"
        )
        parts.append("</svg>")
        return "".join(parts)

    def _generate_one_page_summary(self) -> None:
        lines = ["# One-page summary", ""]
        for ds_name, results in self.all_results.items():
            if "error" in results:
                continue
            points = []
            for alg, m in results.items():
                if alg.startswith("_"):
                    continue
                if isinstance(m, dict) and m.get("recall") is not None:
                    points.append(
                        {
                            "name": alg,
                            "qps": float(m.get("qps") or 0.0),
                            "recall": float(m.get("recall") or 0.0),
                        }
                    )
            if points:
                svg_name = f"qps_recall_{ds_name}.svg"
                with open(os.path.join(self.output_dir, svg_name), "w") as f:
                    f.write(
                        self._svg_scatter(points, f"QPS vs Recall — {ds_name}")
                    )
                lines.append(f"## {ds_name}")
                lines.append("")
                lines.append(f"![qps vs recall]({svg_name})")
                best = max(points, key=lambda p: (p["recall"], p["qps"]))
                lines.append(
                    f"Best recall: **{best['name']}** "
                    f"(recall={best['recall']:.4f}, qps={best['qps']:.1f})"
                )
                lines.append("")
        with open(os.path.join(self.output_dir, "one-page-summary.md"), "w") as f:
            f.write("\n".join(lines))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Run a benchmark config")
    parser.add_argument("--config", required=True, help="YAML config path")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = parser.parse_args(argv)
    runner = BenchmarkRunner(args.config, output_dir=args.output_dir, device=args.device)
    runner.run()
    print(f"results written to {runner.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
