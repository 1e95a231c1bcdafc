#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line and raising (exit code != 0) on failure:

  1. device      - fail at once without CUDA; the card's name and power limit
  2. build       - compile every CUDA kernel of the port from ``csrc/``
  3. kernels     - each kernel against its plain PyTorch version on the card
  4. main path   - the port's BenchmarkRunner (exact row: BruteForceIndexer +
                   LinearSearcher) on 100k x 384 random data, l2 and cosine;
                   ground truth, timed batched search, recall@20 == 1.0, the
                   kernel's launch counts, and a float64 spot check of the
                   ground truth
  5. throughput  - exact search QPS at the flagship shape (100k x 384, l2,
                   top-20, batches of 256) and at 1M x 128 (w = 32), with the
                   kernel's time beside its plain version, one library call
                   and the bound of the card
  6. the kernels line, the nvidia-smi line, and last the result line.

Imports nothing of JAX. Writes its YAML and the runner's outputs under
``_smoke_out/`` of the checkout (git-ignored).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "_smoke_out")

# H100 SXM published peaks (NVIDIA data sheet, 700 W): FP32 outside the
# tensor cores and HBM3 bandwidth. The bound of a kernel is the larger of
# its operations over the first and its bytes over the second.
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# Kernel vs plain version: both are f32 sums of <= 384 products, taken in
# another order (the kernel's 16-deep FFMA chain vs cuBLAS's), so they
# differ by a few f32 roundings of the largest partial sums; 1e-5 of the
# largest |score| bounds that with a wide margin.
KERNEL_REL_TOL = 1e-5
# Ground truth vs float64: f32 rounding of a 384-term distance sum.
GT_REL_TOL = 1e-5

BATCH = 256
TOPK = 20
SEED = 7

_LINES = []


def emit(obj) -> None:
    line = json.dumps(obj)
    _LINES.append(line)
    print(line, flush=True)


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, from CUDA events around ``reps``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---- 1. device ---------------------------------------------------------


def phase_device():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({
        "phase": "device", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": card,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    return card


# ---- 2. build ----------------------------------------------------------


def phase_build() -> None:
    from vectordb_retrieval_tpu_torch.ops import kernels

    secs = kernels.build()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in kernels.BUILD_LOG.items()
    }
    emit({"phase": "build", "kernels": list(kernels.KERNEL_SOURCES),
          "seconds": secs, "ptxas": ptxas})


# ---- 3. kernel vs plain version ----------------------------------------


# (B, N, d, w, share of dead slots); N is padded to S % w == 0 with dead
# (+inf pen) rows, so (7, 1000, 17, 16) has a partly dead last block
K1_SHAPES = (
    (256, 100_000, 384, 8, 0.0),
    (256, 1_000_000, 128, 32, 0.0),
    (7, 1_000, 17, 16, 0.0),
    (24, 8_192, 96, 16, 0.1),
)


def _k1_inputs(b, n, d, w, dead, pen_kind, seed):
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    g = torch.Generator(device="cuda").manual_seed(seed)
    s = kernels.dist_blockmin_pad_rows(n, w)
    q = torch.randn((b, d), generator=g, device="cuda")
    x = torch.zeros((s, d), device="cuda")
    x[:n] = torch.randn((n, d), generator=g, device="cuda")
    pen = (x * x).sum(-1) if pen_kind == "l2" else torch.zeros(s, device="cuda")
    pen[n:] = float("inf")
    if dead:
        pen[torch.rand(s, generator=g, device="cuda") < dead] = float("inf")
        pen[: 3 * w] = float("inf")  # three whole dead blocks -> +inf minima
    return q, x, pen.reshape(s // w, w).contiguous()


def phase_kernels() -> float:
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    worst = 0.0
    for i, (b, n, d, w, dead) in enumerate(K1_SHAPES):
        for pen_kind in ("l2", "zero"):
            q, x, pen = _k1_inputs(b, n, d, w, dead, pen_kind, SEED + i)
            got = kernels.dist_blockmin(q, x, pen, w=w)
            want = kernels.dist_blockmin_reference(q, x, pen, w=w)
            torch.cuda.synchronize()
            inf_got, inf_want = torch.isinf(got), torch.isinf(want)
            if not torch.equal(inf_got, inf_want):
                raise AssertionError(f"dist_blockmin {(b, n, d, w)}: +inf positions differ")
            if torch.isnan(got).any():
                raise AssertionError(f"dist_blockmin {(b, n, d, w)}: NaN in output")
            fin = ~inf_want
            err = float((got - want)[fin].abs().max()) if fin.any() else 0.0
            scale = float(want[fin].abs().max()) if fin.any() else 0.0
            ok = err <= KERNEL_REL_TOL * scale
            emit({"phase": "kernel_check", "kernel": "dist_blockmin",
                  "shape": [b, n, d, w], "pen": pen_kind, "dead": dead,
                  "dead_blocks": int(inf_want[0].sum()),
                  "max_abs_err": err, "max_abs_plain": scale,
                  "tol": KERNEL_REL_TOL * scale, "ok": ok})
            if not ok:
                raise AssertionError(f"dist_blockmin {(b, n, d, w)} {pen_kind}: err {err}")
            worst = max(worst, err)
    return worst


# ---- 4. main path ------------------------------------------------------


def _runner_config(metric: str) -> dict:
    return {
        "indexers": {"brute_force": {"type": "BruteForceIndexer"}},
        "searchers": {"linear": {"type": "LinearSearcher"}},
        "algorithms": {
            "exact": {"indexer_ref": "brute_force", "searcher_ref": "linear"}
        },
        "datasets": [{
            "name": "random",
            "metric": metric,
            "dataset_options": {
                "dimensions": 384, "train_size": 100_000, "test_size": 2048,
                "ground_truth_k": 100, "seed": SEED, "use_cache": False,
            },
        }],
        "topk": TOPK,
        "n_queries": 2048,
        "query_batch_size": BATCH,
        "output_dir": os.path.join(OUT_DIR, "runs"),
        "data_dir": os.path.join(OUT_DIR, "data"),
        "output_prefix": f"exact_{metric}",
        "seed": 42,
    }


def _check_gt_float64(train, queries, gt_ids, metric, n_check=64):
    """The ground truth's top-20 distances against float64 difference-form
    distance rows on the card, compared as sorted values (tie-aware)."""
    import torch

    x = torch.as_tensor(train, device="cuda", dtype=torch.float64)
    q = torch.as_tensor(queries[:n_check], device="cuda", dtype=torch.float64)
    if metric == "cosine":
        x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
        q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    ids = torch.as_tensor(gt_ids[:n_check, :TOPK], device="cuda")
    worst = 0.0
    for s in range(0, n_check, 8):
        rows = ((x[None, :, :] - q[s : s + 8, None, :]) ** 2).sum(-1)  # [8, N]
        true = rows.topk(TOPK, dim=1, largest=False).values
        got = torch.gather(rows, 1, ids[s : s + 8]).sort(dim=1).values
        rel = float(((got - true).abs() / true.abs().amax(1, keepdim=True)).max())
        worst = max(worst, rel)
    del x
    torch.cuda.empty_cache()
    return worst


def phase_main_path(card: str) -> int:
    import torch
    import yaml

    from vectordb_retrieval_tpu_torch.bench import experiment
    from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner
    from vectordb_retrieval_tpu_torch.data import datasets
    from vectordb_retrieval_tpu_torch.ops import kernels

    gt_calls, search_calls = [], []
    orig_gt = datasets.compute_ground_truth
    orig_search = experiment.ExperimentRunner._timed_search

    def counted_gt(train, queries, k, metric="l2", *args, **kwargs):
        before = kernels.LAUNCHES["dist_blockmin"]
        ids = orig_gt(train, queries, k, metric, *args, **kwargs)
        gt_calls.append({
            "launches": kernels.LAUNCHES["dist_blockmin"] - before,
            "train": train, "queries": queries, "ids": ids, "metric": metric,
        })
        return ids

    def counted_search(self, *args, **kwargs):
        before = kernels.LAUNCHES["dist_blockmin"]
        out = orig_search(self, *args, **kwargs)
        search_calls.append(kernels.LAUNCHES["dist_blockmin"] - before)
        return out

    total = 0
    os.makedirs(OUT_DIR, exist_ok=True)
    datasets.compute_ground_truth = counted_gt
    experiment.ExperimentRunner._timed_search = counted_search
    try:
        for metric in ("l2", "cosine"):
            gt_calls.clear()
            search_calls.clear()
            path = os.path.join(OUT_DIR, f"exact_{metric}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(_runner_config(metric), f)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            results = BenchmarkRunner(path).run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = kernels.LAUNCHES["dist_blockmin"]

            ds = results["random"]
            if "error" in ds:
                raise AssertionError(f"{metric}: dataset error {ds['error']}")
            for name, row in ds.items():
                if isinstance(row, dict) and "error" in row:
                    raise AssertionError(f"{metric}: row {name} error {row['error']}")
            row = ds["exact"]
            if row.get(f"recall@{TOPK}") != 1.0:
                raise AssertionError(f"{metric}: recall@{TOPK} = {row.get(f'recall@{TOPK}')}")
            if len(gt_calls) != 1 or gt_calls[0]["launches"] < 1:
                raise AssertionError(f"{metric}: ground truth did not launch dist_blockmin")
            if len(search_calls) != 1 or search_calls[0] < 1:
                raise AssertionError(f"{metric}: timed search did not launch dist_blockmin")
            gt = gt_calls[0]
            ids = gt["ids"]
            n_train = gt["train"].shape[0]
            if ids.shape != (2048, 100) or ids.min() < 0 or ids.max() >= n_train:
                raise AssertionError(f"{metric}: ground truth ids malformed {ids.shape}")
            rel = _check_gt_float64(gt["train"], gt["queries"], ids, gt["metric"])
            if rel > GT_REL_TOL:
                raise AssertionError(f"{metric}: ground truth vs float64 rel err {rel}")
            emit({
                "phase": "main_path", "metric": metric, "card": card,
                "recall@20": row[f"recall@{TOPK}"], "qps": row["qps"],
                "build_time_s": row["build_time_s"],
                "index_memory_mb": row["index_memory_mb"],
                "warmup_time_s": row["warmup_time_s"],
                "runner_seconds": seconds,
                "launches": {"dist_blockmin": launches},
                "launches_ground_truth": gt["launches"],
                "launches_timed_search": search_calls[0],
                "gt_float64_max_rel_err": rel, "gt_float64_tol": GT_REL_TOL,
            })
            total += launches
    finally:
        datasets.compute_ground_truth = orig_gt
        experiment.ExperimentRunner._timed_search = orig_search
    return total


# ---- 5. throughput -----------------------------------------------------


def phase_throughput(card: str, n: int, d: int, batches: int) -> dict:
    import torch

    from vectordb_retrieval_tpu_torch.ops import distances as dops
    from vectordb_retrieval_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    db = torch.as_tensor(rng.standard_normal((n, d), dtype=np.float32), device=dev)
    sqn = dops.sq_norms(db)
    qs = torch.as_tensor(
        rng.standard_normal((batches, BATCH, d), dtype=np.float32), device=dev
    )

    def search(qb):
        return dops.exact_search(qb, db, TOPK, metric="l2", db_sqnorms=sqn, device=dev)

    search(qs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [search(qs[i])[1] for i in range(batches)]
    torch.cuda.synchronize()
    ids_host = torch.stack(ids).cpu().numpy()
    elapsed = time.perf_counter() - t0
    if ids_host.shape != (batches, BATCH, TOPK):
        raise AssertionError(f"throughput ids shape {ids_host.shape}")
    if ids_host.min() < 0 or ids_host.max() >= n:
        raise AssertionError("throughput ids out of range")

    # stage 1 alone at the main path's inputs
    w = dops.blockmin_width(n)
    s = kernels.dist_blockmin_pad_rows(n, w)
    if s != n:
        raise AssertionError(f"throughput shapes need n % w == 0 (n={n}, w={w})")
    q = qs[0].contiguous()
    pen = sqn.reshape(-1, w)
    kernel_ms = time_ms(lambda: kernels.dist_blockmin(q, db, pen, w=w))
    plain_ms = time_ms(lambda: kernels.dist_blockmin_reference(q, db, pen, w=w))
    library_ms = time_ms(lambda: torch.matmul(q, db.T))
    # where one batch's device time goes: stage 1, stage 2, the rest
    bmins = kernels.dist_blockmin(q, db, pen, w=w)
    nb = min(TOPK + dops._BLOCKMIN_SLACK, bmins.shape[1])
    select_ms = time_ms(lambda: dops._select_blocks(bmins, nb))
    batch_ms = time_ms(lambda: search(q))
    flops = 2.0 * BATCH * s * d + 2.0 * BATCH * s  # products, pen add, min
    nbytes = 4.0 * (BATCH * d + s * d + s + BATCH * (s // w))
    flop_ms = flops / FP32_PEAK_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {
        "phase": "throughput", "shape": [n, d], "metric": "l2", "topk": TOPK,
        "batch": BATCH, "batches": batches, "w": w, "card": card,
        "qps": batches * BATCH / elapsed, "seconds": elapsed,
        "ms_per_batch": elapsed / batches * 1e3,
        "dist_blockmin_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "flops": flops, "bytes": nbytes,
        "batch_device_ms": batch_ms, "select_blocks_ms": select_ms,
        "rescore_and_rest_ms": batch_ms - kernel_ms - select_ms,
    }
    emit(out)
    del db, qs, ids
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # outside a checkout of the repo this fails before anything is printed
    sys.path.insert(0, REPO)
    import vectordb_retrieval_tpu_torch  # noqa: F401

    card = phase_device()
    phase_build()
    max_err = phase_kernels()
    launches = phase_main_path(card)
    flagship = phase_throughput(card, 100_000, 384, 96)
    phase_throughput(card, 1_000_000, 128, 96)
    emit({"kernels": [{
        "name": "dist_blockmin",
        "route": "cuda",
        "source": "vectordb_retrieval_tpu_torch/csrc/dist_blockmin.cu",
        "replaces": "vectordb_retrieval_tpu/ops/pallas_kernels.py:220",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": flagship["dist_blockmin_ms"],
        "plain_ms": flagship["plain_ms"],
        "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"],
        "library_ms": flagship["library_ms"],
        "shape": [BATCH, 100_000, 384, flagship["w"]],
    }]})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "w") as f:
        f.write("\n".join(_LINES) + "\n")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
