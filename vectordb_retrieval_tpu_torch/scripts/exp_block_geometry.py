"""Sweep block-graph search geometry at msmarco shape (100k x 384d cosine).

The reference's committed hnsw msmarco row is 0.9857 recall @ 7,872 QPS
(reference benchmark_20260305_070532/benchmark_summary.md:44). This probe
sweeps (block_size, spill, slab dtype) builds and (efb, expand, iters)
geometries directly on built indexes; the JAX package's sweep set the
shipped ``spill`` default and ``models/graph.block_geometry``. The
counterpart of the JAX package's ``scripts/exp_block_geometry.py``: the
same sweep, knobs and printed lines.

Knobs, environment variables as in the JAX script (the same command line
means the same sweep): ``SPILLS`` (default ``0,0.1,0.2``), ``BLOCKS``
(rows a block, ``256``), ``SLABS`` (``f32``; ``bf16`` halves the wave
bytes), ``DEGREE`` (``32``, capped at the block count less one) and
``GEOMS`` (``efb:expand:iters,...``, default six geometries of efb 32,
expand 8, iters 4-18). A spilled layout dedups ids in the top-k; a
geometry that would probe every block (``expand * iters >= n_blocks``) is
skipped.

Timing: the JAX script times a ``lax.scan`` of 3 repeats inside one
``jit``; here the beam runs once untimed, then 3 times on the device, with
one synchronise and one copy of the last ids to the host inside the clock
(``bench/experiment._timed_search``'s protocol).

    [SPILLS=0,0.1] [SLABS=f32,bf16] [GEOMS=32:8:9] \
    python -m vectordb_retrieval_tpu_torch.scripts.exp_block_geometry \
        [--data-dir data] [--device cpu]

``--device`` defaults to the CUDA card and fails without one. The corpus is
cached under ``--data-dir``.
"""

from __future__ import annotations

import argparse
import itertools
import os
from typing import List, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.ops import graph as gops
from vectordb_retrieval_tpu_torch.scripts.probes import timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

K = 20
B = 512
REPEATS = 3
GEOMS = [(32, 8, 4), (32, 8, 6), (32, 8, 9), (32, 8, 11), (32, 8, 14), (32, 8, 18)]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default="data")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds = Dataset(
        "msmarco_surrogate",
        data_dir=args.data_dir,
        options={"train_limit": 100_000, "test_size": B, "ground_truth_k": 200},
        device=device,
    ).load()
    x = np.asarray(ds.train_vectors, dtype=np.float32)
    q = np.asarray(ds.test_vectors, dtype=np.float32)
    gt = np.asarray(ds.ground_truth)
    # cosine: normalise once (as GraphIndexer's block build does)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    n = x.shape[0]
    xd = torch.as_tensor(x, device=device)
    qd = torch.as_tensor(q, device=device)

    spills = tuple(float(s) for s in os.environ.get("SPILLS", "0,0.1,0.2").split(","))
    blocks = tuple(int(s) for s in os.environ.get("BLOCKS", "256").split(","))
    slabs = tuple(os.environ.get("SLABS", "f32").split(","))
    geoms = GEOMS
    if os.environ.get("GEOMS"):
        geoms = [tuple(int(v) for v in g.split(":")) for g in os.environ["GEOMS"].split(",")]
    for block, spill, slab in itertools.product(blocks, spills, slabs):
        n_blocks = -(-n // block)
        degree = max(4, min(int(os.environ.get("DEGREE", "32")), n_blocks - 1))
        parts = gops.build_block_graph(
            xd, n_blocks, degree, seed=42, spill=spill, slab_dtype=slab,
        )
        slot_ids = parts[2]
        print(
            f"built block={block} spill={spill} slab={slab} "
            f"n_blocks={slot_ids.shape[0]} degree={degree}",
            flush=True,
        )
        for efb, expand, iters in geoms:
            if expand * iters >= n_blocks:
                continue

            def search(qb, efb=efb, expand=expand, iters=iters):
                return gops.block_graph_search(
                    qb, *parts, k=K, efb=efb, expand=expand, iters=iters,
                    metric="cosine", dedup=spill > 0,
                )

            ids, elapsed = timed_passes(search, qd, REPEATS, device)
            rec = recall_at_k(gt, ids, K)
            qps = REPEATS * B / elapsed
            print(
                f"block={block} spill={spill} slab={slab} efb={efb} "
                f"expand={expand} iters={iters} probes={expand * iters} "
                f"recall={rec:.4f} qps={qps:.0f}",
                flush=True,
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
