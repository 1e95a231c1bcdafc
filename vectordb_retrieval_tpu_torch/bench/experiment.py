"""ExperimentRunner: single-dataset build -> search -> time loop.

Counterpart of ``vectordb_retrieval_tpu/bench/experiment.py``: seeded query
subsetting, the batched timing loop with an untimed warm-up batch, QPS /
mean-latency derivation, the result-JSON schema and per-algorithm +
combined JSON and plots.

Timing: queries are uploaded before the clock. The clock covers every
batch of every ``repeat`` pass, then a ``torch.cuda.synchronize()`` and the
copy of the ids to host, so it stops only once the results are on the host.

Persistence: the modes ``build_only`` / ``retrieve_only`` /
``build_and_retrieve`` with dataset fingerprint and config hash validation,
as in the JAX package; artifacts are written in its format
(``models/persist.py``), so either package can load the other's.
"""

from __future__ import annotations

import json
import logging
import os
import time
from datetime import datetime
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.bench.config import ExperimentConfig
from vectordb_retrieval_tpu_torch.bench.evaluation import Evaluator
from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.models import get_algorithm_instance
from vectordb_retrieval_tpu_torch.models.base import BaseAlgorithm
from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
    resolve_devices,
    synchronize,
)
from vectordb_retrieval_tpu_torch.utils.hashing import stable_hash

logger = logging.getLogger(__name__)

PERSISTENCE_MODES = ("build_and_retrieve", "build_only", "retrieve_only")


def algorithm_from_config(
    name: str, config: Dict[str, Any], dimension: int, device: DeviceLike = None
) -> BaseAlgorithm:
    """Instantiate an algorithm from a config dict on ``device``.

    A config with materialised ``indexer``/``searcher`` dicts becomes a
    CompositeAlgorithm; one with ``type`` goes through the registry factory.
    """
    cfg = {
        k: v
        for k, v in config.items()
        if k not in ("persistence", "enabled", "repeat")
    }
    if "indexer" in cfg and "searcher" in cfg:
        metric = cfg.pop("metric", "l2")
        indexer = cfg.pop("indexer")
        searcher = cfg.pop("searcher")
        cfg.pop("type", None)
        cfg.pop("indexer_ref", None)
        cfg.pop("searcher_ref", None)
        return CompositeAlgorithm(
            dimension=dimension,
            indexer=indexer,
            searcher=searcher,
            metric=metric,
            name=name,
            device=device,
            **cfg,
        )
    algo_type = cfg.pop("type", None)
    if algo_type is None:
        raise ValueError(
            f"algorithm {name!r} config needs either 'type' or "
            f"'indexer'+'searcher': {config!r}"
        )
    algo = get_algorithm_instance(algo_type, dimension, device=device, **cfg)
    algo.name = name
    return algo


class ExperimentRunner:
    def __init__(
        self,
        config: ExperimentConfig,
        output_dir: str = "results",
        device: DeviceLike = None,
    ):
        self.devices = resolve_devices(device)  # a mesh's, for sharded rows
        self.device = resolve_device(device)
        self.config = config
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.dataset: Optional[Dataset] = None
        self.algorithms: Dict[str, BaseAlgorithm] = {}
        self.results: Dict[str, Dict[str, Any]] = {}

    # -- setup -----------------------------------------------------------
    def load_dataset(self) -> Dataset:
        options = dict(self.config.dataset_options)
        if self.config.metric and "metric" not in options:
            options["metric"] = self.config.metric
        self.dataset = Dataset(
            self.config.dataset,
            data_dir=self.config.data_dir,
            options=options,
            device=self.device,
        ).load()
        return self.dataset

    def register_algorithm(self, name: str, algorithm: BaseAlgorithm) -> None:
        self.algorithms[name] = algorithm

    def _select_query_subset(self) -> Tuple[np.ndarray, np.ndarray]:
        """Seeded subset of test queries + matching ground-truth rows."""
        assert self.dataset is not None
        test = self.dataset.test_vectors
        gt = self.dataset.ground_truth
        n = min(int(self.config.n_queries), test.shape[0])
        if n < test.shape[0]:
            rng = np.random.default_rng(self.config.seed)
            idx = rng.choice(test.shape[0], size=n, replace=False)
            return np.ascontiguousarray(test[idx]), np.ascontiguousarray(gt[idx])
        return test, gt

    # -- persistence helpers ---------------------------------------------
    def _extract_persistence_config(
        self, algo_config: Dict[str, Any]
    ) -> Dict[str, Any]:
        p = dict(algo_config.get("persistence") or {})
        mode = p.get("mode", "build_and_retrieve")
        if mode not in PERSISTENCE_MODES:
            raise ValueError(
                f"invalid persistence mode {mode!r}; expected {PERSISTENCE_MODES}"
            )
        p.setdefault("enabled", bool(algo_config.get("persistence")))
        p.setdefault("path_policy", "fixed")
        p.setdefault("force_rebuild", False)
        p.setdefault("fail_if_missing", True)
        p["mode"] = mode
        return p

    def _dataset_fingerprint(self, algo_name: str, algo_config: Dict[str, Any]) -> str:
        assert self.dataset is not None
        payload = {
            "dataset": self.config.dataset,
            "algorithm": algo_name,
            "metric": algo_config.get("metric", self.config.metric),
            "dimensions": int(self.dataset.train_vectors.shape[1]),
            "train_count": int(self.dataset.train_vectors.shape[0]),
            "dataset_options": self.config.dataset_options,
        }
        emb_dir = self.config.dataset_options.get("embedded_dataset_dir")
        if emb_dir:
            emb = os.path.join(emb_dir, "passage_embeddings.npy")
            if os.path.exists(emb):
                st = os.stat(emb)
                payload["embeddings_file"] = {
                    "size": st.st_size,
                    "mtime": int(st.st_mtime),
                }
        return stable_hash(payload)

    def _config_hash(self, algo_config: Dict[str, Any]) -> str:
        payload = {
            "algorithm_config": {
                # repeat only affects timing, never the artifact
                k: v
                for k, v in algo_config.items()
                if k not in ("persistence", "repeat")
            },
            "dataset_options": self.config.dataset_options,
            "topk": self.config.topk,
            "n_queries": self.config.n_queries,
            "query_batch_size": self.config.query_batch_size,
        }
        return stable_hash(payload)

    def _resolve_persist_dir(
        self, algo_name: str, p: Dict[str, Any], config_hash: str
    ) -> str:
        base = p.get("artifact_dir") or os.path.join(self.output_dir, "artifacts")
        if p["path_policy"] == "versioned":
            return os.path.join(base, f"{algo_name}_{config_hash[:12]}")
        if p["path_policy"] != "fixed":
            raise ValueError(f"invalid path_policy {p['path_policy']!r}")
        return os.path.join(base, algo_name)

    # -- main loop -------------------------------------------------------
    def run(self) -> Dict[str, Dict[str, Any]]:
        if self.dataset is None:
            self.load_dataset()
        queries, gt = self._select_query_subset()
        evaluator = Evaluator(gt, k_values=[min(self.config.topk, 100)])

        if not self.algorithms:
            dim = int(self.dataset.train_vectors.shape[1])
            for name, cfg in self.config.algorithms.items():
                try:
                    self.register_algorithm(
                        name, algorithm_from_config(name, cfg, dim, self.devices)
                    )
                except Exception as exc:
                    logger.error("failed to construct %s: %s", name, exc)
                    self.results[name] = {"algorithm": name, "error": str(exc)}

        for name, algo in self.algorithms.items():
            algo_config = self.config.algorithms.get(name, {})
            try:
                metrics, indices, query_times = self._run_single_algorithm(
                    name, algo, algo_config, queries
                )
                if metrics.get("status") != "build_only":
                    quality = evaluator.evaluate(name, indices, query_times)
                    metrics.update(quality)
                    # the ops-vs-recall plot reads the op counters too
                    evaluator.results[name] = metrics
                    metrics["recall"] = metrics.get(
                        f"recall@{min(100, self.config.topk)}",
                        metrics.get("recall@10"),
                    )
                self.results[name] = metrics
                self._save_algorithm_results(name)
            except Exception as exc:
                logger.exception("algorithm %s failed", name)
                self.results[name] = {"algorithm": name, "error": str(exc)}
        self._save_combined_results()
        self._generate_plots(evaluator)
        return self.results

    def _run_single_algorithm(
        self,
        name: str,
        algorithm: BaseAlgorithm,
        algo_config: Dict[str, Any],
        queries: np.ndarray,
    ) -> Tuple[Dict[str, Any], np.ndarray, np.ndarray]:
        assert self.dataset is not None
        train = self.dataset.train_vectors
        k = min(self.config.topk, train.shape[0])

        p = self._extract_persistence_config(algo_config)
        persistence_enabled = bool(p.get("enabled"))
        mode = p["mode"]
        fingerprint = config_hash = persist_dir = None
        context: Dict[str, Any] = {}
        if persistence_enabled:
            fingerprint = self._dataset_fingerprint(name, algo_config)
            config_hash = self._config_hash(algo_config)
            persist_dir = self._resolve_persist_dir(name, p, config_hash)
            context = {
                "dataset_fingerprint": fingerprint,
                "config_hash": config_hash,
            }

        def build() -> float:
            start = time.perf_counter()
            algorithm.build_index(train)
            synchronize(self.device)
            return time.perf_counter() - start

        build_time = 0.0
        index_load_time = 0.0
        index_source = "built"
        if persistence_enabled and mode == "retrieve_only":
            if not os.path.isdir(persist_dir):
                if p["fail_if_missing"]:
                    raise FileNotFoundError(
                        f"persisted index missing for {name}: {persist_dir}"
                    )
                logger.warning("%s: persisted index missing, rebuilding", name)
                build_time = build()
            else:
                start = time.perf_counter()
                algorithm.load_index(persist_dir, context)
                synchronize(self.device)
                index_load_time = time.perf_counter() - start
                index_source = "loaded"
        else:
            build_time = build()
            if persistence_enabled and mode in ("build_only", "build_and_retrieve"):
                if p.get("force_rebuild") or not os.path.isdir(persist_dir):
                    algorithm.save_index(persist_dir, context)

        memory_mb = algorithm.index_memory_bytes() / (1024.0 * 1024.0)
        base_metrics: Dict[str, Any] = {
            "algorithm": name,
            "parameters": algorithm.get_parameters(),
            "dataset": self.config.dataset,
            "n_train": int(train.shape[0]),
            "n_test": int(queries.shape[0]),
            "dimensions": int(train.shape[1]),
            "topk": self.config.topk,
            "build_time_s": float(build_time),
            "index_memory_mb": float(memory_mb),
            "index_load_time_s": float(index_load_time),
            "index_source": index_source,
            "persistence_mode": mode if persistence_enabled else None,
            "persist_dir": persist_dir if persistence_enabled else None,
            "dataset_fingerprint": fingerprint if persistence_enabled else None,
            "config_hash": config_hash if persistence_enabled else None,
            "timestamp": datetime.now().isoformat(),
        }

        if persistence_enabled and mode == "build_only":
            base_metrics["status"] = "build_only"
            return base_metrics, np.zeros((0, k), np.int64), np.zeros(0)

        indices, query_times, warmup_s, total_time = self._timed_search(
            algorithm, queries, k, repeat=algo_config.get("repeat")
        )
        mean_ms = (
            (total_time / max(len(queries), 1)) * 1000.0 if len(queries) else 0.0
        )
        ops = algorithm.get_operations()
        base_metrics.update(
            {
                "qps": float(len(queries) / total_time) if total_time > 0 else 0.0,
                "mean_query_time_ms": float(mean_ms),
                "total_query_time_s": float(total_time),
                "warmup_time_s": float(warmup_s),
                "operations": ops,
            }
        )
        if ops.get("ndis"):
            base_metrics["operations_per_query"] = ops["ndis"] / max(len(queries), 1)
        return base_metrics, indices, query_times

    def _timed_search(
        self,
        algorithm: BaseAlgorithm,
        queries: np.ndarray,
        k: int,
        repeat: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, float, float]:
        """Batched timing loop: one untimed warm-up batch, then ``repeat``
        passes over all batches (per-algorithm override of
        ``config.repeat``); returns (ids, per-query seconds, warm-up
        seconds, seconds per pass).

        Every batch runs through the algorithm's ``device_kernel``; each
        pass ends with a synchronise and the ids' copy to host inside the
        clock. A failure raises.
        """
        n = queries.shape[0]
        batch = self.config.query_batch_size or n
        indices = np.full((n, k), -1, dtype=np.int64)
        query_times = np.zeros(n, dtype=np.float64)

        warmup_start = time.perf_counter()
        algorithm.batch_search(queries[: min(batch, n)], k)
        warmup_s = time.perf_counter() - warmup_start
        algorithm.reset_operations()

        if repeat is None:
            repeat = getattr(self.config, "repeat", 1)
        repeats = max(1, int(repeat or 1))
        q_dev = torch.as_tensor(
            np.ascontiguousarray(queries, dtype=np.float32), device=self.device
        )
        synchronize(self.device)
        t0 = time.perf_counter()
        for _ in range(repeats):
            ids = [
                algorithm.device_kernel(q_dev[s : s + batch], k)[1]
                for s in range(0, n, batch)
            ]
            synchronize(self.device)
            ids_host = torch.cat(ids).cpu().numpy()
        total = (time.perf_counter() - t0) / repeats
        indices[:, : ids_host.shape[1]] = ids_host
        query_times[:] = total / max(n, 1)
        algorithm.record_stream_ops(n)
        return indices, query_times, warmup_s, total

    # -- outputs ---------------------------------------------------------
    def _save_algorithm_results(self, name: str) -> None:
        path = os.path.join(self.output_dir, f"{name}_results.json")
        with open(path, "w") as f:
            json.dump(self.results[name], f, indent=2, default=str)

    def _save_combined_results(self) -> None:
        path = os.path.join(
            self.output_dir, f"{self.config.output_prefix}_all_results.json"
        )
        with open(path, "w") as f:
            json.dump(self.results, f, indent=2, default=str)
        self.config.save(os.path.join(self.output_dir, "config_used.yaml"))

    def _generate_plots(self, evaluator: Evaluator) -> None:
        try:
            evaluator.plot_recall_vs_qps(
                os.path.join(self.output_dir, "recall_vs_qps.png")
            )
            if "glove" in self.config.dataset:
                evaluator.plot_operations_vs_recall(
                    os.path.join(self.output_dir, "operations_vs_recall.png")
                )
        except Exception as exc:  # plots must never kill a run
            logger.warning("plot generation failed: %s", exc)
