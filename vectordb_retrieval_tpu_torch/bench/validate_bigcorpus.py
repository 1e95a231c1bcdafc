"""Out-of-core corpus validation: peak host RSS stays below the corpus size.

Builds a 4M x 128 corpus through the out-of-core path: chunked generation
straight into a ``BigStore`` (``random`` with ``storage: memmap``), streamed
ground truth, the streaming ``IVF1024,SQ8`` build (sample-trained
quantizers, chunked assign and encode, only the codes kept), then one
search of the queries. Counterpart of ``scripts/validate_bigcorpus.py``,
with the same arguments and defaults; it runs on the CUDA card unless
``--device cpu`` is given.

    python -m vectordb_retrieval_tpu_torch.bench.validate_bigcorpus \\
        [--rows 4000000] [--coding SQ8] [--device cpu] [--data-dir DIR] [--keep]

Prints one JSON line: RSS accounting, seconds by phase, recall and the
kernels' launch counts. Resident memory is sampled by phase (``VmRSS``
every 5 ms; the peak also takes ``data/storage.peak_rss_bytes``), so run
it in a fresh process started by a small one: linux carries a parent's
resident size into a child's ``ru_maxrss``.

The bound is on what the corpus path adds to the runtime's own footprint:
``rss_growth_mb``, the peak less the peak of start-up (the interpreter,
torch and its CUDA libraries, the CUDA context, cuBLAS and the kernels'
libraries, all loaded before any data), must stay below the corpus size
(``rss_growth_under_corpus``). ``rss_under_corpus`` is the JAX script's
absolute test, peak RSS below the corpus size; on a host whose kernel
counts every mapped page of the CUDA libraries as resident the start-up
alone exceeds a 2 GB corpus, which ``rss_by_phase_mb`` shows. Exit code 0
when ``rss_growth_under_corpus`` holds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--nprobe", type=int, default=128)
    ap.add_argument(
        "--coding", default="SQ8", choices=["Flat", "SQ8", "PQ16", "PQ32"],
        help="list payload; SQ8/PQ stream-build without ever holding the "
        "raw corpus on host or device",
    )
    ap.add_argument("--data-dir", default=os.path.join(tempfile.gettempdir(), "bigcorpus_val"))
    ap.add_argument("--keep", action="store_true", help="keep the corpus and its cache")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for the host")
    return ap.parse_args(argv)


def dataset_options(args: argparse.Namespace) -> dict:
    """The ``random`` dataset's options (also its cache key: a second load
    with the same options reuses the corpus, its store and ground truth)."""
    return {
        "train_size": args.rows, "dimensions": args.dim,
        "test_size": args.queries, "ground_truth_k": args.k,
        "storage": "memmap", "use_cache": True, "seed": args.seed,
    }


def _vm_rss() -> int:
    """Current resident set size (bytes) from ``/proc/self/status``; 0
    where there is none."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class RSSMonitor:
    """Peak resident set size of each named phase: ``VmRSS`` sampled every
    ``period`` seconds by a daemon thread, and at every phase change."""

    def __init__(self, period: float = 0.005):
        self.period = period
        self.phase = "imports"
        self.peaks = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _sample(self) -> None:
        rss = _vm_rss()
        with self._lock:
            self.peaks[self.phase] = max(self.peaks.get(self.phase, 0), rss)

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self._sample()

    def enter(self, phase: str) -> None:
        self._sample()
        with self._lock:
            self.phase = phase
        self._sample()

    def close(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=5)
        self._sample()
        return dict(self.peaks)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
    from vectordb_retrieval_tpu_torch.data import datasets
    from vectordb_retrieval_tpu_torch.data.storage import peak_rss_bytes
    from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
    from vectordb_retrieval_tpu_torch.ops import kernels
    from vectordb_retrieval_tpu_torch.utils.compat import trim_host_heap
    from vectordb_retrieval_tpu_torch.utils.device import resolve_device, synchronize

    mon = RSSMonitor()
    dev = resolve_device(args.device)
    mon.enter("runtime")
    if dev.type == "cuda":  # the CUDA context, cuBLAS and the kernels' libraries
        kernels.build()
        a = torch.ones((256, 256), device=dev)
        float((a @ a).sum())
    kernels.reset_launch_counts()
    corpus_bytes = args.rows * args.dim * 4
    mon.enter("generate")
    runtime = max(mon.peaks.values())
    print(f"corpus {args.rows}x{args.dim} = {corpus_bytes / 2**20:.0f} MB; "
          f"start-up RSS {runtime / 2**20:.0f} MB", file=sys.stderr)

    # the ground truth's share of the dataset's load
    gt_seconds = []
    compute_gt = datasets.compute_ground_truth

    def timed_gt(*a, **kw):
        mon.enter("ground_truth")
        t = time.perf_counter()
        out = compute_gt(*a, **kw)
        gt_seconds.append(time.perf_counter() - t)
        return out

    t0 = time.perf_counter()
    datasets.compute_ground_truth = timed_gt
    try:
        ds = datasets.Dataset(
            "random", data_dir=args.data_dir, options=dataset_options(args), device=dev,
        ).load()
    finally:
        datasets.compute_ground_truth = compute_gt
    t_data = time.perf_counter() - t0
    if not isinstance(ds.train_vectors, np.memmap):
        raise RuntimeError("storage: memmap did not give a memmap corpus")
    trim_host_heap()  # phase boundary: return freed staging arenas
    print(f"dataset+GT {t_data:.1f}s, peak RSS {max(mon.peaks.values()) / 2**20:.0f} MB",
          file=sys.stderr)

    mon.enter("build")
    t0 = time.perf_counter()
    algo = CompositeAlgorithm(
        dimension=args.dim,
        indexer={"type": "IVFIndexer", "index_type": f"IVF{args.nlist},{args.coding}"},
        searcher={"type": "ANNSearcher", "nprobe": args.nprobe},
        metric="l2", device=dev,
    )
    algo.build_index(ds.train_vectors)
    synchronize(dev)
    t_build = time.perf_counter() - t0
    trim_host_heap()

    mon.enter("search")
    searches = []
    for _ in range(2):  # the first call loads the search's kernels
        t0 = time.perf_counter()
        _, ids = algo.batch_search(ds.test_vectors, args.k)
        searches.append(time.perf_counter() - t0)
    recall = recall_at_k(ds.ground_truth[:, : args.k], ids, args.k)
    peaks = mon.close()
    rss_peak = max(max(peaks.values()), peak_rss_bytes() or 0)
    growth = rss_peak - runtime

    ok = growth < corpus_bytes
    meta = algo.artifact.metadata
    result = {
        "metric": "bigcorpus_rss_validation",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "rows": args.rows,
        "dim": args.dim,
        "coding": args.coding,
        "corpus_mb": round(corpus_bytes / 2**20, 1),
        "peak_rss_mb": round(rss_peak / 2**20, 1),
        "startup_rss_mb": round(runtime / 2**20, 1),
        "rss_growth_mb": round(growth / 2**20, 1),
        "rss_by_phase_mb": {k: round(v / 2**20, 1) for k, v in peaks.items()},
        "rss_under_corpus": bool(rss_peak < corpus_bytes),
        "rss_growth_under_corpus": bool(ok),
        "dataset_gt_s": t_data,
        "ground_truth_s": sum(gt_seconds) if gt_seconds else None,
        "generate_s": t_data - sum(gt_seconds) if gt_seconds else None,
        "ivf_build_s": t_build,
        "build_seconds": dict(getattr(algo.indexer, "build_seconds", {})),
        "built_streaming": bool(meta.get("built_streaming")),
        "index_kind": algo.artifact.kind,
        "n_buckets": meta.get("n_buckets"),
        "bucket_len": meta.get("max_list_len"),
        "search_s": searches[0],
        "search_warm_s": searches[1],
        "search_qps": args.queries / max(searches[1], 1e-9),
        f"recall@{args.k}": float(recall),
        "launches": dict(kernels.LAUNCHES),
    }
    print(json.dumps(result), flush=True)
    if not args.keep:
        shutil.rmtree(args.data_dir, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
