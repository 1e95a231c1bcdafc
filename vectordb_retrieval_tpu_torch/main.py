"""Single-experiment entry point: one config's dataset, every algorithm of
it, one result line per row.

    python -m vectordb_retrieval_tpu_torch.main --config configs/default.yaml \
        [--output-dir results] [--verbose] [--device cpu]

``--device`` defaults to the CUDA card and fails without one; ``cpu`` runs
on the host. A row that fails prints its error and keeps it in its result
JSON; the exit code is 0 once every row has run.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Run a single experiment")
    parser.add_argument("--config", default="configs/default.yaml")
    parser.add_argument("--output-dir", default="results")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
    )

    from vectordb_retrieval_tpu_torch.bench.config import ExperimentConfig
    from vectordb_retrieval_tpu_torch.bench.experiment import ExperimentRunner

    config = ExperimentConfig.from_yaml(args.config)
    runner = ExperimentRunner(config, output_dir=args.output_dir, device=args.device)
    runner.load_dataset()
    results = runner.run()
    for name, m in results.items():
        if "error" in m:
            print(f"{name}: ERROR {m['error']}")
        else:
            print(
                f"{name}: recall={m.get('recall')} qps={m.get('qps'):.1f} "
                f"build={m.get('build_time_s', 0):.2f}s"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
