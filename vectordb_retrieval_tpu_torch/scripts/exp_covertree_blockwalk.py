"""Cover tree at 1M: the node-level stream walk against the block-granular
walk (``ops/covertree.covertree_blockwalk_search``), on the SIFT1M
surrogate.

Builds one tree on the surrogate, times both descents through the model's
``device_kernel`` (the search users call, the exact search of the rows
whose certificate failed included), and reports recall against the
dataset's ground truth. It bears on ``descent="auto"``
(``models/covertree.CoverTree.uses_blockwalk``), which takes the block
walk on the card.

The counterpart of the JAX package's ``scripts/exp_covertree_blockwalk.py``:
the same options (plus ``--data-dir``, whose ``sift1m_synth`` holds the
surrogate ``scripts.make_sift1m_surrogate`` writes, and ``--device``), the
same build and printed lines, then one ``check`` line
(``scripts/probes.print_check``): each walk's recall, ms a pass and share
of queries whose certificate failed (answered by exact search). Timing:
the JAX script scans ``--iters`` passes in one ``jit`` (each pass's
queries shifted by a zero carry); here one untimed pass, then ``--iters``
passes on the device with one synchronise and one copy of the last ids to
the host inside the clock (``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_covertree_blockwalk \\
        [--k 100] [--iters 16] [--b 256] [--descents blockwalk,stream] \\
        [--data-dir data] [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.models.covertree import CoverTree
from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--descents", default="blockwalk,stream")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds = Dataset(
        "sift1m", data_dir=args.data_dir,
        options={"subdir": "sift1m_synth", "test_size": args.b,
                 "ground_truth_k": args.k},
        device=device,
    ).load()
    x = np.asarray(ds.train_vectors)
    q = np.asarray(ds.test_vectors[: args.b], np.float32)
    gt = np.asarray(ds.ground_truth[: args.b, : args.k])

    algo = CoverTree(dimension=x.shape[1], metric="l2", device=device)
    t0 = time.time()
    algo.build_index(x)
    print(f"build {time.time()-t0:.1f}s nodes={algo.artifact.metadata['n_nodes']}",
          flush=True)

    qd = torch.as_tensor(q, device=device)
    walks = {}
    for descent in args.descents.split(","):
        algo.descent = descent
        ids_np, dt = timed_passes(lambda qb: algo.device_kernel(qb, args.k), qd,
                                  args.iters, device)
        dt /= args.iters
        hits = sum(
            len(set(ids_np[i].tolist()) & set(gt[i].tolist()))
            for i in range(args.b)
        )
        rec = hits / float(args.b * args.k)
        print(
            f"{descent:10s} {dt*1e3:8.2f} ms/pass "
            f"({args.b/dt:9.0f} QPS)  recall@{args.k}={rec:.4f}",
            flush=True,
        )
        overflow = algo._search(qd, args.k).overflow
        walks[descent] = {"recall": rec, "ms_per_pass": dt * 1e3,
                          "overflow": float(overflow.float().mean())}
    print_check(walks=walks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
