"""One run of one cell: data from the seed, the index built, the window
measured, the answers judged against the plain reference.

Everything that belongs to one configuration, one workload or one
per-layer metric lives in a file of its own, found by name:

* ``configs/<config>.json``: the corpus (generator, ``data_seed``, size,
  metric, pool);
* ``generators/<generator>.py``: ``generate(seed, n, queries, pool_seed,
  **options)``;
* ``workloads/<cell>.json``: the index spec, batch, ``k``, the guarantee,
  the control's precision and the limits of the comparison;
* ``guarantees/<guarantee>.py``: ``build`` / ``search``, the reference's
  index and answers under that guarantee (``fmt`` lowers their precision);
* ``layer_metrics/<metric>.py``: ``read(records, cell)``, one per-layer
  metric from the traced stretch.

The system under test is the port, ``vectordb_retrieval_tpu_torch``,
driven through its public entry: ``get_algorithm_instance`` with the
workload's spec, ``build_index`` in set-up and ``batch_search`` in the
window. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from retrieval_bench import reference, trace

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# after the build, the cell's one batch shape is warmed by at least this
# many requests over at least this many seconds (clocks, allocator, caches)
WARM_REQUESTS = 10
WARM_SECONDS = 1.0
# the most memory set-up touches for the window's answers (more go to
# fresh arrays)
STORE_BYTES = 8 << 30
# the traced stretch of a --trace 1 window: it starts this many seconds
# into the window and lasts this long (both shrink to fit a short window)
TRACE_LEAD_S = 1.0
TRACE_STRETCH_S = 2.0
UNITS = {"qps": "queries/s", "batch_p95_ms": "ms", "recall": "fraction",
         "build_s": "s", "setup_s": "s"}
FORBIDDEN = ("jax", "jaxlib", "flax", "vectordb_retrieval_tpu")


def load_json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark, loaded by path (a name may
    hold dots)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"retrieval_bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str) -> Dict[str, Any]:
    """The workload ``name`` with its configuration and the card's peaks."""
    workload = load_json("workloads", f"{name}.json")
    return {
        "name": name,
        "workload": workload,
        "config": load_json("configs", f"{workload['config']}.json"),
        "peaks": load_json("peaks.json"),
    }


def benchmark() -> Dict[str, Any]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def metric_names(cell: str, traced: bool) -> List[str]:
    """The metrics BENCHMARK.json asks of ``cell`` in this kind of run."""
    bench = benchmark()
    entries = bench["per_layer"] if traced else bench["end_to_end"]
    return [m["name"] for m in entries
            if "workloads" not in m or cell in m["workloads"]]


def chips(cell: str) -> int:
    for w in benchmark()["workloads"]:
        if w["name"] == cell:
            return int(w["chips"])
    return 1


def make_data(config: Dict[str, Any], seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The corpus of ``config`` (one deployment's data: drawn from its
    ``data_seed``, the same in every run) and the query pool drawn from
    ``seed`` over the same clusters: every seed brings the same corpus and
    as many queries of the same distribution."""
    gen = load_module("generators", config["generator"])
    return gen.generate(config["data_seed"], config["n"], config["pool"],
                        pool_seed=seed % 2**63, **config.get("generator_options", {}))


def program(cell: Dict[str, Any], device) -> Any:
    """The system under test: the port's algorithm for the workload's spec."""
    from vectordb_retrieval_tpu_torch.models import get_algorithm_instance

    spec = dict(cell["workload"]["algorithm"])
    kind = spec.pop("type")
    return get_algorithm_instance(kind, dimension=cell["config"]["d"], device=device, **spec)


def prepare_program(device) -> None:
    """Load the port's CUDA kernels (built into its own fixed cache inside
    the checkout on a checkout's first run), so no build falls in a timed
    stretch."""
    if torch.device(device).type == "cuda":
        from vectordb_retrieval_tpu_torch.ops import kernels

        kernels.build()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class AnswerStore:
    """The window's answers, each copied as returned into storage that
    set-up allocated and touched for ``capacity`` requests (more go to
    fresh arrays), so that keeping them costs the loop one copy and no
    allocation: the program's own arrays are freed as a caller's would be.
    A malformed answer is kept as returned, for the judge to count."""

    def __init__(self, batch: int, k: int, capacity: int, id_dtype=np.int32):
        self.shape = (batch, k)
        self.dists = np.ones((capacity,) + self.shape, dtype=np.float32)
        self.ids = np.ones((capacity,) + self.shape, dtype=id_dtype)
        self.kept: List[Tuple[int, Any, Any]] = []

    def keep(self, offset: int, d, i) -> None:
        j = len(self.kept)
        if j < len(self.dists) and np.shape(d) == self.shape and np.shape(i) == self.shape:
            self.dists[j], self.ids[j] = d, i
            d, i = self.dists[j], self.ids[j]
        else:
            d, i = np.array(d, copy=True), np.array(i, copy=True)
        self.kept.append((offset, d, i))


def _activities(dev) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def judge(cell: Dict[str, Any], corpus: np.ndarray, pool: np.ndarray,
          answers: List[Tuple[int, np.ndarray, np.ndarray]], dev) -> Dict[str, float]:
    """The reference's readings of the window's answers: the exact top-k
    (for recall) and the workload's guarantee, both worked out anew from
    the raw corpus and pool."""
    wl, cfg = cell["workload"], cell["config"]
    metric, k = cfg["metric"], int(wl["k"])
    x = reference.prepare(corpus, metric, dev)
    q = reference.prepare(pool, metric, dev)
    exact_d, _ = reference.exact_topk(q, x, k, metric)
    if wl["guarantee"] == "exact":
        expected = exact_d
    else:
        guarantee = load_module("guarantees", wl["guarantee"])
        expected, _ = guarantee.search(guarantee.build(x, wl), q, k, metric)
    return reference.judge(answers, int(wl["batch"]), k, x, q, metric, expected, exact_d)


def run(
    name: str,
    seed: int,
    seconds: float,
    traced: bool,
    device="cuda",
    t_start: Optional[float] = None,
    cell: Optional[Dict[str, Any]] = None,
    factory: Optional[Callable[[Dict[str, Any], Any], Any]] = None,
) -> Dict[str, Any]:
    """One run of cell ``name``: the result line's fields, with ``checks``
    (each compared number beside its limit) last and ``info`` besides.

    ``cell`` replaces the files' cell (tests run small sizes on the CPU);
    ``factory(cell, device)`` replaces the program (the control, or a
    program with a planted fault). ``t_start``: when the process started."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or load_cell(name)
    wl, cfg = cell["workload"], cell["config"]
    batch, k = int(wl["batch"]), int(wl["k"])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    corpus, pool = make_data(cfg, seed)
    prepare_program(dev)
    algo = (factory or program)(cell, dev)
    sync(dev)
    t0 = time.perf_counter()
    algo.build_index(corpus)
    sync(dev)
    build_s = time.perf_counter() - t0

    # the pool with its first batch appended: request r is one contiguous
    # slice, the rows (r * batch + [0, batch)) of the pool, wrapping round
    n_pool = pool.shape[0]
    pool_ext = np.ascontiguousarray(np.concatenate([pool, pool[:batch]]))
    t_warm, r, warm_lat = time.perf_counter(), 0, []
    while r < WARM_REQUESTS or time.perf_counter() - t_warm < WARM_SECONDS:
        s = (r * batch) % n_pool
        t1 = time.perf_counter()
        algo.batch_search(pool_ext[s:s + batch], k)
        warm_lat.append(time.perf_counter() - t1)
        r += 1
    id_dtype = np.int32 if cfg["n"] < 2**31 else np.int64
    per_request = batch * k * (4 + np.dtype(id_dtype).itemsize)
    store = AnswerStore(batch, k, min(int(seconds / float(np.median(warm_lat)) * 1.25) + 64,
                                      STORE_BYTES // per_request), id_dtype)
    prof = None
    if traced:  # the profiler's own start-up, outside the window
        warm = torch.profiler.profile(activities=_activities(dev))
        warm.start()
        algo.batch_search(pool_ext[:batch], k)
        warm.stop()
        prof = torch.profiler.profile(activities=_activities(dev))
    sync(dev)
    setup_s = time.perf_counter() - t_start

    latencies: List[float] = []
    ends: List[float] = []  # when each request ended, from the window's start
    failed, errors = 0, []
    lead = min(TRACE_LEAD_S, seconds / 3)
    w0 = time.perf_counter()
    deadline = w0 + seconds
    trace_on, trace_off = w0 + lead, w0 + lead + min(TRACE_STRETCH_S, seconds - lead)
    state = "before"  # the profiler: before, on, off
    t_last = w0
    r = 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if prof is not None:
            if state == "before" and now >= trace_on:
                prof.start()
                state = "on"
            elif state == "on" and now >= trace_off:
                prof.stop()
                state = "off"
        s = (r * batch) % n_pool
        q = pool_ext[s:s + batch]
        t1 = time.perf_counter()
        try:
            if state == "on":
                with torch.profiler.record_function(trace.REQUEST):
                    d, i = algo.batch_search(q, k)
            else:
                d, i = algo.batch_search(q, k)
            store.keep(s, d, i)
        except Exception as exc:  # a failed request is counted, and the loop goes on
            failed += 1
            if len(errors) < 3:
                errors.append(f"{type(exc).__name__}: {exc}")
        t_last = time.perf_counter()
        latencies.append(t_last - t1)
        ends.append(t_last - w0)
        r += 1
    if state == "on":
        prof.stop()
        state = "off"
    window_s = t_last - w0
    sync(dev)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    records = trace.collect(prof) if prof is not None and state == "off" else None

    del algo  # the program's state is freed before the reference runs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    answers = store.kept
    readings = judge(cell, corpus, pool, answers, dev)
    ref_s = time.perf_counter() - t_ref

    limits = wl["limits"]
    correct = r > 0 and failed == 0 and all(readings[c] <= lim for c, lim in limits.items())
    answered = len(answers) * batch
    values = {
        "qps": answered / window_s if window_s > 0 else 0.0,
        "batch_p95_ms": float(np.percentile(latencies, 95)) * 1e3 if latencies else 0.0,
        "recall": readings["recall"],
        "build_s": build_s,
        "setup_s": setup_s,
    }
    out: Dict[str, Any] = {
        "correct": bool(correct),
        "attempted": r,
        "failed": failed,
        "metrics": {},
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    info = {
        "seed": seed, "window_s": window_s, "answered_queries": answered,
        "batch_p50_ms": float(np.percentile(latencies, 50)) * 1e3 if latencies else 0.0,
        "build_s": build_s, "setup_s": setup_s, "reference_s": ref_s,
        "requests_by_quarter": np.histogram(ends, bins=4, range=(0, window_s))[0].tolist()
        if window_s > 0 else [],
        "readings": readings, "errors": errors,
    }
    if dev.type == "cuda":
        info["card"] = power_limit()
    if not traced:
        for m in metric_names(name, False):
            out["metrics"][m] = {"value": values[m], "unit": UNITS[m]}
    elif records is not None and records["requests"]:
        lo, hi = trace.window(records)
        out["device"]["busy_s"] = trace.busy_ns(records, lo, hi) / 1e9
        out["device"]["window_s"] = (hi - lo) / 1e9
        out["breakdown"] = trace.breakdown(records)
        info["traced_requests"] = len(records["requests"])
        info["kernels_s"] = trace.breakdown(records, top=200)["device_ops"]
        for m in metric_names(name, True):
            reader = load_module("layer_metrics", m)
            value = reader.read(records, cell)
            if value is not None:
                out["metrics"][m] = {"value": value, "unit": reader.UNIT}
    out["info"] = info
    out["checks"] = {c: {"value": readings[c], "limit": lim} for c, lim in limits.items()}
    return out

