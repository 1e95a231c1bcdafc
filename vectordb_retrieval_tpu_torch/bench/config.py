"""ExperimentConfig: kwargs/YAML config object.

Field and default parity with reference src/experiments/config.py:5-101
(dataset=random, n_queries=1000, topk=100, query_batch_size=0, seed=42,
metric propagation into per-algorithm configs, to_dict/save/from_yaml).
The default algorithm set is the exact scan.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import yaml

DEFAULT_ALGORITHMS: Dict[str, Dict[str, Any]] = {
    "exact": {"type": "ExactSearch", "metric": "l2"},
}


class ExperimentConfig:
    def __init__(self, **kwargs: Any):
        self.dataset = kwargs.get("dataset", "random")
        self.data_dir = kwargs.get("data_dir", "data")
        self.force_download = kwargs.get("force_download", False)
        self.dataset_options = copy.deepcopy(kwargs.get("dataset_options", {}))

        self.n_queries = kwargs.get("n_queries", 1000)
        self.topk = kwargs.get("topk", 100)
        self.repeat = kwargs.get("repeat", 1)
        self.query_batch_size = kwargs.get("query_batch_size", 0)

        self.algorithms = copy.deepcopy(kwargs.get("algorithms", DEFAULT_ALGORITHMS))

        self.metric: Optional[str] = kwargs.get("metric")
        if self.metric is not None:
            for alg_config in self.algorithms.values():
                if isinstance(alg_config, dict):
                    alg_config.setdefault("metric", self.metric)

        self.seed = kwargs.get("seed", 42)
        self.output_prefix = kwargs.get("output_prefix", "experiment")

    @classmethod
    def from_yaml(cls, yaml_file: str) -> "ExperimentConfig":
        with open(yaml_file, "r") as f:
            return cls(**yaml.safe_load(f))

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "dataset": self.dataset,
            "data_dir": self.data_dir,
            "force_download": self.force_download,
            "dataset_options": self.dataset_options,
            "n_queries": self.n_queries,
            "topk": self.topk,
            "repeat": self.repeat,
            "query_batch_size": self.query_batch_size,
            "algorithms": self.algorithms,
            "seed": self.seed,
            "output_prefix": self.output_prefix,
        }
        if self.metric is not None:
            d["metric"] = self.metric
        return d

    def save(self, output_file: str) -> None:
        with open(output_file, "w") as f:
            yaml.dump(self.to_dict(), f)

    def __str__(self) -> str:
        return yaml.dump(self.to_dict())
