"""The program's own spans in a traced stretch, for the span readers in
``layer_metrics/``.

The port marks the stages of its search path with spans named ``vrt.*``
(``vectordb_retrieval_tpu_torch/utils/profiling.py``: ``SPANS``). They are
ordinary host events on the profiler's clock, so :func:`trace.collect`
lists them under ``records["host_ops"]`` beside the host's operators and
the CUDA runtime's calls. Every reading here is clipped to the traced
``rb.request`` spans and divided by their count: a mean per request. A
program without a span gives None for it, never 0.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Sequence, Tuple

from retrieval_bench.trace import Interval, union

# the CUDA API calls that put work on the card, as the profiler names
# them (a CUPTI name may carry a version suffix, "_v11060")
LAUNCH_CALLS = re.compile(
    r"^(?:cudaLaunchKernel|cuLaunchKernel|cudaLaunchKernelExC|cudaMemcpyAsync|cudaMemsetAsync)"
    r"(?:_v\d+)?$"
)


def _clip(reqs: List[Interval], starts: List[int], s: int, e: int) -> List[Tuple[int, int]]:
    """The pieces of ``[s, e]`` that lie inside a request of ``reqs``
    (sorted by start, ``starts`` their starts)."""
    out = []
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    while i < len(reqs) and reqs[i][1] < e:
        lo, hi = max(s, reqs[i][1]), min(e, reqs[i][2])
        if hi > lo:
            out.append((lo, hi))
        i += 1
    return out


def pieces(rec: Dict[str, List[Interval]], name: str) -> Optional[List[Tuple[int, int]]]:
    """Every span ``name`` clipped to the traced requests, as ``(start,
    end)`` pieces; None where the stretch holds no such span inside a
    request."""
    reqs = rec["requests"]
    if not reqs:
        return None
    starts = [r[1] for r in reqs]
    out: List[Tuple[int, int]] = []
    for n, s, e in rec["host_ops"]:
        if n == name:
            out += _clip(reqs, starts, s, e)
    return out or None


def wall_ms(rec: Dict[str, List[Interval]], name: str) -> Optional[float]:
    """Wall time of the spans ``name`` a request, in ms (spans of one name
    in one request add up)."""
    spans = pieces(rec, name)
    if spans is None:
        return None
    return sum(e - s for s, e in spans) / len(rec["requests"]) / 1e6


def _busy_in(device: Sequence[Tuple[int, int]], starts: List[int], s: int, e: int) -> int:
    """Nanoseconds of ``[s, e]`` covered by the merged ``device`` pieces."""
    busy = 0
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    while i < len(device) and device[i][0] < e:
        busy += max(0, min(e, device[i][1]) - max(s, device[i][0]))
        i += 1
    return busy


def idle_ms(rec: Dict[str, List[Interval]], name: str) -> Optional[float]:
    """Device idle inside the spans ``name`` a request, in ms: each span's
    interval less the union of the kernels and copies running in it."""
    spans = pieces(rec, name)
    if spans is None:
        return None
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    device = union(rec["kernels"] + rec["copies"], lo, hi)
    starts = [s for s, _ in device]
    idle = sum((e - s) - _busy_in(device, starts, s, e) for s, e in spans)
    return idle / len(rec["requests"]) / 1e6


def calls_in(rec: Dict[str, List[Interval]], name: str) -> Optional[float]:
    """The calls that put a kernel, a copy or a memset on the card
    (:data:`LAUNCH_CALLS`) that start inside the spans ``name``, a
    request."""
    spans = pieces(rec, name)
    if spans is None:
        return None
    spans.sort()
    starts = [s for s, _ in spans]
    count = 0
    for n, s, _ in rec["host_ops"]:
        if not LAUNCH_CALLS.match(n):
            continue
        j = bisect.bisect_right(starts, s) - 1
        if j >= 0 and s < spans[j][1]:
            count += 1
    return count / len(rec["requests"])
