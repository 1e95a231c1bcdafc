"""The readings that set the correctness limits: the program, its control
and planted faults, run through the harness one seed after another in one
process.

* the **program**: the port, as a benchmark run drives it;
* the **control**: the plain reference put in the program's place and
  computed at the workload's ``control.precision``, a precision below the
  configuration's float32 (:class:`Control`); it has to come out not
  correct;
* a **fault** planted in the program's answers where they are produced
  (:data:`FAULTS`); each has to come out not correct.

    python -m retrieval_bench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 3 --which program,control,alter_answer,half_batch

prints one JSON line a run (``which``, ``seed``, ``correct``, the readings,
``qps``), and appends it to ``--out`` where given. The limits in
``workloads/<cell>.json`` sit between the program's largest reading over a
dozen seeds and the smallest reading of the control (PERF.md gives both).
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from retrieval_bench import harness, reference


class Control:
    """The reference's index and search in the program's place, at
    precision ``fmt``, behind the program's ``build_index`` /
    ``batch_search``."""

    def __init__(self, cell: Dict[str, Any], device, fmt: str):
        self.workload = cell["workload"]
        self.metric = cell["config"]["metric"]
        self.device = device
        self.fmt = fmt
        self.guarantee = harness.load_module("guarantees", self.workload["guarantee"])

    def build_index(self, corpus: np.ndarray) -> None:
        x = reference.prepare(corpus, self.metric, self.device, self.fmt)
        self.index = self.guarantee.build(x, self.workload, self.fmt)

    def batch_search(self, queries: np.ndarray, k: int):
        q = reference.prepare(queries, self.metric, self.device, self.fmt)
        d, i = self.guarantee.search(self.index, q, k, self.metric, self.fmt)
        return d.float().cpu().numpy(), i.cpu().numpy()


class Faulty:
    """The program with one fault planted where its answers are produced."""

    def __init__(self, inner, fault: str, n: int):
        self.inner, self.fault, self.n = inner, fault, n

    def build_index(self, corpus: np.ndarray) -> None:
        self.inner.build_index(corpus)

    def batch_search(self, queries: np.ndarray, k: int):
        if self.fault == "half_batch":  # half the batch left out, the rest copied over it
            half = queries.shape[0] // 2
            d, i = self.inner.batch_search(queries[:half], k)
            return np.concatenate([d, d])[: queries.shape[0]], np.concatenate([i, i])[: queries.shape[0]]
        d, i = self.inner.batch_search(queries, k)
        i = i.copy()
        i[0, 0] = (i[0, 0] + self.n // 2) % self.n  # one answer altered
        return d, i


FAULTS = ("alter_answer", "half_batch")


def factory(which: str):
    """The ``harness.run`` factory of ``which``: None for the program."""
    if which == "program":
        return None
    if which == "control":
        return lambda cell, dev: Control(cell, dev, cell["workload"]["control"]["precision"])
    if which in FAULTS:
        return lambda cell, dev: Faulty(harness.program(cell, dev), which, cell["config"]["n"])
    raise ValueError(f"unknown run {which!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--which", default="program,control")
    ap.add_argument("--out", help="a JSON-lines file to append each run's line to")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("retrieval_bench.control: no CUDA card", file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for which in args.which.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            out = harness.run(args.workload, seed, args.seconds, False, device="cuda",
                              t_start=t0, factory=factory(which))
            line = {
                "workload": args.workload, "which": which, "seed": seed,
                "correct": out["correct"], "readings": out["info"]["readings"],
                "qps": out["metrics"].get("qps", {}).get("value"),
                "setup_s": out["info"]["setup_s"], "reference_s": out["info"]["reference_s"],
                "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                "errors": out["info"]["errors"],
            }
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
