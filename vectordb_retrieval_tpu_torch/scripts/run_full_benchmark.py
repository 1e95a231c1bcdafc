"""Full benchmark CLI: every dataset and algorithm of a YAML config through
the ``BenchmarkRunner``, or a default config written out.

    python -m vectordb_retrieval_tpu_torch.scripts.run_full_benchmark \
        --config configs/benchmark_config.yaml [--output-dir DIR] [--device cpu]
    python -m vectordb_retrieval_tpu_torch.scripts.run_full_benchmark \
        --create-config my_config.yaml

``--device`` defaults to the CUDA card and fails without one; ``cpu`` runs
on the host. A failed row or dataset keeps its error in the result JSON,
and the exit code is 0 once every dataset has run.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

DEFAULT_CONFIG = """\
# Vector retrieval benchmark configuration (PyTorch / CUDA port)
indexers:
  brute_force_l2: {type: BruteForceIndexer, metric: l2}
  graph_l2: {type: GraphIndexer, M: 16, efConstruction: 200, efSearch: 100, metric: l2}
  ivf_l2: {type: FactoryIndexer, index_key: "IVF100,Flat", metric: l2, nprobe: 10}
  ivf_pq_l2: {type: FactoryIndexer, index_key: "IVF256,PQ16", metric: l2, nprobe: 24}
  ivf_sq8_l2: {type: FactoryIndexer, index_key: "IVF256,SQ8", metric: l2, nprobe: 24}
  pq_l2: {type: FactoryIndexer, index_key: "PQ16", metric: l2}
  lsh_l2: {type: LSHIndexer, metric: l2, num_tables: 12, hash_size: 18, bucket_width: 4.0}
searchers:
  linear_l2: {type: LinearSearcher, metric: l2}
  ann_l2: {type: ANNSearcher, metric: l2, nprobe: 10}
  ann_l2_highprobe: {type: ANNSearcher, metric: l2, nprobe: 24}
  lsh_search_l2: {type: LSHSearcher, metric: l2, candidate_multiplier: 8.0, fallback_to_bruteforce: true}
algorithms:
  exact: {indexer_ref: brute_force_l2, searcher_ref: linear_l2, metric: l2}
  hnsw: {indexer_ref: graph_l2, searcher_ref: ann_l2, metric: l2}
  ivf_flat: {indexer_ref: ivf_l2, searcher_ref: ann_l2, metric: l2}
  ivf_pq: {indexer_ref: ivf_pq_l2, searcher_ref: ann_l2_highprobe, metric: l2}
  ivf_sq8: {indexer_ref: ivf_sq8_l2, searcher_ref: ann_l2_highprobe, metric: l2}
  pq: {indexer_ref: pq_l2, searcher_ref: ann_l2_highprobe, metric: l2}
  covertree: {type: CoverTreeV2_2, metric: l2}
  lsh: {indexer_ref: lsh_l2, searcher_ref: lsh_search_l2, metric: l2}
datasets:
  - name: random
    metric: l2
    n_queries: 256
    topk: 20
    dataset_options: {dimensions: 64, train_size: 20000, test_size: 512, ground_truth_k: 200, seed: 7}
output_dir: benchmark_results
data_dir: data
n_queries: 1000
query_batch_size: 128
output_prefix: benchmark
seed: 42
topk: 200
"""


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Run the full benchmark suite")
    parser.add_argument("--config", type=str, help="YAML config path")
    parser.add_argument("--output-dir", type=str, default=None)
    parser.add_argument(
        "--create-config",
        type=str,
        default=None,
        metavar="PATH",
        help="write a default config to PATH and exit",
    )
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = parser.parse_args(argv)

    if args.create_config:
        with open(args.create_config, "w") as f:
            f.write(DEFAULT_CONFIG)
        print(f"wrote default config to {args.create_config}")
        return 0

    if not args.config:
        parser.error("--config is required (or use --create-config)")

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
    )

    from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner

    runner = BenchmarkRunner(args.config, output_dir=args.output_dir, device=args.device)
    runner.run()
    print(f"results written to {runner.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
