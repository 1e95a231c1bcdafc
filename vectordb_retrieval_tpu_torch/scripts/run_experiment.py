"""Registry-based single-experiment runner.

    python -m vectordb_retrieval_tpu_torch.scripts.run_experiment \
        --config configs/default.yaml [--output-dir results] [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--output-dir", default="results")
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = parser.parse_args(argv)

    from vectordb_retrieval_tpu_torch.bench.config import ExperimentConfig
    from vectordb_retrieval_tpu_torch.bench.experiment import ExperimentRunner

    config = ExperimentConfig.from_yaml(args.config)
    runner = ExperimentRunner(config, output_dir=args.output_dir, device=args.device)
    runner.load_dataset()
    runner.run()
    print(f"results in {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
