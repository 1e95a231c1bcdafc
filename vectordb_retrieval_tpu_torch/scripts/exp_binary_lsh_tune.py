"""Binary-LSH (reference ``faiss_lsh``, FAISS IndexLSH + rerank) candidate
frontier: recall@k and QPS against the rerank candidate multiplier.

At k=20 a multiplier of 16 (320 candidates) lands random at 0.64 recall
against the reference's published 0.9672 @ 2,087 QPS (BASELINE.md:47).
This probe finds the smallest multiplier clearing the reference recall per
dataset; the Hamming scan is corpus-bound, so QPS is flat in the
multiplier until the rerank dominates. The counterpart of the JAX
package's ``scripts/exp_binary_lsh_tune.py``: the same arguments,
datasets, printed lines and JSON document; its record is
``benchmark_results/round5_binary_lsh_tune/recall_frontier.json``.

Each pass searches every query on ``--device`` and stops the clock after a
sync with the ids on the host (``utils/timing``); one untimed pass first.

    python -m vectordb_retrieval_tpu_torch.scripts.exp_binary_lsh_tune \
        [--dataset random|glove50_surrogate|msmarco_surrogate] \
        [--num-bits 256] [--mults 16,32,64,128,256] [--iters 8] [--out F] \
        [--data-dir data] [--device cpu]

``--device`` defaults to the CUDA card and fails without one. The corpus
is cached under ``--data-dir``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.models.lsh import BinaryLSHIndexer, binary_lsh_search
from vectordb_retrieval_tpu_torch.utils.device import resolve_device
from vectordb_retrieval_tpu_torch.utils.timing import Timer, block

OPTS = {
    "random": {"dimensions": 64, "train_size": 20000, "test_size": 256,
               "ground_truth_k": 200, "seed": 7},
    "glove50_surrogate": {"test_size": 256, "train_limit": 20000,
                          "ground_truth_k": 200, "seed": 11},
    "msmarco_surrogate": {"train_limit": 100000, "test_size": 256,
                          "ground_truth_k": 200},
}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="random", choices=sorted(OPTS))
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--num-bits", type=int, default=256)
    p.add_argument("--mults", default="16,32,64,128,256")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--out", default="")
    p.add_argument("--data-dir", default="data")
    p.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = p.parse_args(argv)
    mults = [float(m) for m in args.mults.split(",")]
    device = resolve_device(args.device)

    metric = "cosine" if args.dataset.startswith("msmarco") else "l2"
    ds = Dataset(
        args.dataset, data_dir=args.data_dir, options=dict(OPTS[args.dataset]),
        device=device,
    ).load()
    x = np.asarray(ds.train_vectors)
    q = np.asarray(ds.test_vectors, np.float32)
    gt = np.asarray(ds.ground_truth[:, : args.k])

    art = BinaryLSHIndexer(num_bits=args.num_bits, metric=metric, device=device).build(
        x, x.shape[1]
    )
    qd = torch.as_tensor(q, device=device)

    def one_pass(mult: float) -> np.ndarray:
        _, ids = binary_lsh_search(art, qd, args.k, metric, mult)
        return block(ids).cpu().numpy()

    rows = {}
    for mult in mults:
        one_pass(mult)  # warm-up, outside the clock
        with Timer() as t:
            for _ in range(args.iters):
                ids = one_pass(mult)
        dt = t.elapsed / args.iters
        rec = float(recall_at_k(gt, ids, args.k))
        qps = q.shape[0] / dt
        rows[str(int(mult))] = {"recall": round(rec, 4), "qps": round(qps)}
        print(f"mult {mult:>5.0f}: recall {rec:.4f}  {qps:>9,.0f} QPS", flush=True)

    doc = {"dataset": args.dataset, "k": args.k, "num_bits": args.num_bits,
           "rows": rows}
    print(json.dumps(doc))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
