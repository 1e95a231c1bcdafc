"""Tracing and counted work.

  * :func:`span` marks one stage of the search path for ``torch.profiler``
    (names in :data:`SPANS`); with no profiler running it costs one flag
    check and records nothing;
  * :func:`trace` writes a ``torch.profiler`` Chrome trace (CPU and, where
    there is a card, CUDA activity) around a region: the way to see the
    spans beside the kernels and copies they enqueue;
  * :func:`cost_estimate` counts the operations and bytes of one call from
    the shapes of what it runs, the same on the CPU as on the card, in
    place of a compiler's cost model (the runner's roofline keys,
    ``bench/experiment.py`` ``_roofline``).

The ``ndis`` counter on ``BaseAlgorithm`` (models/base.py) stays the count
of distance evaluations.

Spans. While a profiler runs, ``with span(name):`` records one event named
``name`` with its start and end on the profiler's clock, the clock of the
device's kernels and copies in the same trace. It is an ordinary host
event (``torch._C._profiler._RecordFunctionFast``), not a user
annotation, so the profiler's records list it among the host's operators.
Its parent is the innermost span or operator open around it on the same
thread; its request is whatever span the caller opened around the call
(a benchmark's per-request span), which every span of that call shares.
No span here runs on another thread. An op's span shows for every caller
of that op (ground truth, the cover tree's exact fallback), inside a
``vrt.search`` only where a searcher called it. The spans, in the order a
request opens them:

  * ``vrt.h2d``: the query upload in ``models/base.host_search``, the
    host entry of every searcher and of ``CoverTree``;
  * ``vrt.search``: the device part there (a searcher's
    ``device_kernel``), every search op enqueued;
  * ``vrt.seed``: the block beam's dense entry scan and its first
    frontier (``ops/graph.BlockBeam.seed``), inside ``vrt.search``;
  * ``vrt.wave``: one wave of the block beam (``pop``, ``score``: K2
    ``kernels.slab_dots``, ``merge`` and, on every wave but the last,
    ``push``), ``iters`` of them after ``vrt.seed``, inside ``vrt.search``;
    where ``ops/graph.block_graph_search`` replays its CUDA graphs, these
    two spans hold each graph's launch instead of its ops;
  * ``vrt.probe``: the IVF coarse probe (``ops/ivf._probes``), inside
    ``vrt.search``;
  * ``vrt.rescore``: the exact rescore (K6, ``kernels.block_rescore``) and
    top-k of exact search's blockmin path
    (``ops/distances._exact_search_blockmin``), and the gather, exact
    rescore and top-k of IVF's ``_rescore_blocks`` (over unfiltered bf16
    rows one kernel, ``kernels.ivf_block_rescore``, in place of the
    gather and rescore) and ``_final_rescore`` (one span each), inside
    ``vrt.search``;
  * ``vrt.d2h``: the copies back to NumPy and the padding in
    ``host_search``: the wait for the card and the copies.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

SPANS = ("vrt.h2d", "vrt.search", "vrt.seed", "vrt.wave", "vrt.probe", "vrt.rescore", "vrt.d2h")

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("vrt.search"):`` records the block as an event named
    ``name`` while ``torch.profiler`` runs; otherwise it returns one shared
    null context and records nothing. ``name`` is one of :data:`SPANS`."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    if name not in SPANS:
        raise ValueError(f"unknown span {name!r}: add it to SPANS")
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``with trace("traces/run"):`` profiles the region and writes
    ``log_dir/torch_trace.json`` (Chrome trace format) when it ends: the
    :func:`span` stages on the host's rows above the kernels and copies
    they enqueue on the card's."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "torch_trace.json"))


def _mm(a, b, *_a, **_k) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b, *_a, **_k) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _mv(a, v, *_a, **_k) -> float:
    return 2.0 * a.shape[0] * a.shape[1]


def _dot(a, b, *_a, **_k) -> float:
    return 2.0 * a.shape[0]


# aten matrix products -> their operations (2 per multiply-add) from the
# shapes of the two factors; the add of addmm/baddbmm/addmv is not counted,
# as torch.utils.flop_counter does not count it
_PRODUCTS: Dict[Any, Callable[..., float]] = {
    aten.mm: _mm,
    aten.addmm: lambda bias, a, b, *r, **k: _mm(a, b),
    aten.bmm: _bmm,
    aten.baddbmm: lambda bias, a, b, *r, **k: _bmm(a, b),
    aten.mv: _mv,
    aten.addmv: lambda bias, a, v, *r, **k: _mv(a, v),
    aten.dot: _dot,
    aten.vdot: _dot,
}


def _tensor_bytes(tree: Any) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    return 0


class _AtenWork(TorchDispatchMode):
    """Operations of the aten matrix products and bytes of every aten op's
    tensor inputs and outputs, for the ops that run outside the kernel
    wrappers (the wrappers count their own work, ``ops/kernels.py``).
    Views move no bytes and ``empty*`` writes none: neither is counted."""

    def __init__(self, inside_wrapper: Callable[[], bool]) -> None:
        super().__init__()
        self.inside_wrapper = inside_wrapper
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.inside_wrapper():
            return out
        packet = func.overloadpacket
        if func.is_view or packet.__name__.startswith("empty"):
            return out
        self.ops += 1
        if packet in _PRODUCTS:
            self.flops += _PRODUCTS[packet](*args, **kwargs)
        ins = {k: v for k, v in kwargs.items() if k != "out"}
        self.bytes += _tensor_bytes(args) + _tensor_bytes(ins) + _tensor_bytes(out)
        return out


def cost_estimate(fn: Callable, *args: Any, **kwargs: Any) -> Dict[str, float]:
    """Counted work of one ``fn(*args, **kwargs)`` call: ``{"flops",
    "bytes_accessed"}``, or ``{}`` where nothing was counted.

    ``flops`` sums the operations of every kernel wrapper call
    (``ops/kernels.py``: the products' multiply-adds, two each, and the
    epilogue's adds and minima) and of every aten matrix product that runs
    outside the wrappers (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
    ``addmv``, ``dot``; ``torch.matmul`` and ``einsum`` reach these).
    Elementwise ops, reductions, sorts and top-k add no flops.
    ``bytes_accessed`` sums each wrapper call's inputs read once and outputs
    written once, and every other aten op's tensor inputs and outputs:
    logical bytes summed over ops, with no cache, fusion or reuse taken
    into account. Counts come from shapes (and, for a slab product, the
    distinct slabs its ids select), so the CPU and the card count the same
    work for the same call path.
    """
    # imported here: the search ops import span from this module
    from vectordb_retrieval_tpu_torch.ops import kernels

    with kernels.count_work() as work, _AtenWork(kernels.inside_wrapper) as ops:
        fn(*args, **kwargs)
    if not (work["calls"] or ops.ops):
        return {}
    return {"flops": work["flops"] + ops.flops,
            "bytes_accessed": work["bytes"] + ops.bytes}


def flops_estimate(fn: Callable, *args: Any, **kwargs: Any) -> Optional[float]:
    """``cost_estimate(fn, ...)["flops"]``; None where nothing was counted."""
    return cost_estimate(fn, *args, **kwargs).get("flops")

