"""Records of a traced stretch of the window, taken from ``torch.profiler``.

:func:`collect` turns the profiler's events into plain lists of intervals
in nanoseconds on the profiler's clock: device kernels, device copies
(memcpy and memset), the benchmark's own ``rb.request`` spans, one per
call into the program, and the host's operator spans. The per-layer
readers (``layer_metrics/``) and :func:`breakdown` read only these lists.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

REQUEST = "rb.request"

Interval = Tuple[str, int, int]


def collect(prof) -> Dict[str, List[Interval]]:
    """``{"kernels", "copies", "requests", "host_ops"}`` of a stopped
    ``torch.profiler.profile``, each a list of ``(name, start_ns, end_ns)``
    sorted by start."""
    out: Dict[str, List[Interval]] = {"kernels": [], "copies": [], "requests": [], "host_ops": []}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, end = int(ev.start_ns()), int(ev.end_ns())
        on_device = str(ev.device_type()).endswith("CUDA")
        annotation = bool(getattr(ev, "is_user_annotation", lambda: False)())
        if on_device:
            if annotation or name == REQUEST:
                continue
            key = "copies" if name.startswith(("Memcpy", "Memset")) else "kernels"
            out[key].append((name, start, end))
        elif name == REQUEST:
            out["requests"].append((name, start, end))
        elif not annotation:
            out["host_ops"].append((name, start, end))
    for key in out:
        out[key].sort(key=lambda t: t[1])
    return out


def window(rec: Dict[str, List[Interval]]) -> Tuple[int, int]:
    """The traced window: from the first request's start to the last's end."""
    reqs = rec["requests"]
    return reqs[0][1], max(e for _, _, e in reqs)


def union(intervals: Sequence[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """Merged ``(start, end)`` pieces of ``intervals`` clipped to ``[lo, hi]``."""
    pieces: List[Tuple[int, int]] = []
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if pieces and s <= pieces[-1][1]:
            pieces[-1] = (pieces[-1][0], max(pieces[-1][1], e))
        else:
            pieces.append((s, e))
    return pieces


def busy_ns(rec: Dict[str, List[Interval]], lo: int, hi: int) -> int:
    """Nanoseconds of ``[lo, hi]`` in which a kernel or a copy ran."""
    return sum(e - s for s, e in union(rec["kernels"] + rec["copies"], lo, hi))


def _open_op(host_ops: List[Interval], starts: List[int], t: int) -> Optional[str]:
    """The innermost host operator open at ``t`` (the latest started that
    has not ended), or None."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and t - host_ops[i][1] <= 50_000_000:  # no op here lasts 50 ms
        if host_ops[i][2] >= t:
            return host_ops[i][0]
        i -= 1
    return None


def breakdown(rec: Dict[str, List[Interval]], top: int = 10) -> Dict[str, list]:
    """The device operations that took most time in the window, by name,
    and its longest idle gaps (cut where a request starts or ends), each
    labelled by where the host was: inside a request (and the innermost
    operator open there) or between requests."""
    lo, hi = window(rec)
    totals: Dict[str, int] = {}
    for name, s, e in rec["kernels"] + rec["copies"]:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            totals[name] = totals.get(name, 0) + d
    ops = sorted(totals.items(), key=lambda t: -t[1])[:top]
    pieces = union(rec["kernels"] + rec["copies"], lo, hi)
    edges = [lo] + [p for pc in pieces for p in pc] + [hi]
    cuts = sorted({t for _, s, e in rec["requests"] for t in (s, e)})
    gaps = []
    for i in range(0, len(edges), 2):  # each idle gap, cut where a request starts or ends
        a, b = edges[i], edges[i + 1]
        inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
        bounds = [a] + inner + [b]
        gaps += [(s, e) for s, e in zip(bounds, bounds[1:]) if e > s]
    gaps.sort(key=lambda g: g[0] - g[1])
    req_starts = [s for _, s, _ in rec["requests"]]
    op_starts = [s for _, s, _ in rec["host_ops"]]
    labelled = []
    for s, e in gaps[:top]:
        mid = (s + e) // 2
        j = bisect.bisect_right(req_starts, mid) - 1
        inside = j >= 0 and rec["requests"][j][2] >= mid
        op = _open_op(rec["host_ops"], op_starts, mid)
        where = REQUEST if inside else "between requests"
        labelled.append([f"{where} / {op}" if op else where, (e - s) / 1e9])
    return {"device_ops": [[n, v / 1e9] for n, v in ops], "idle_gaps": labelled}


def per_request_ns(rec: Dict[str, List[Interval]], pattern=None) -> Optional[float]:
    """Kernel nanoseconds in the window, over the requests in it; only the
    kernels whose name matches ``pattern`` (a compiled regex) if given.
    None where no such kernel ran."""
    if not rec["requests"]:
        return None
    lo, hi = window(rec)
    total, seen = 0, False
    for name, s, e in rec["kernels"]:
        if pattern is not None and not pattern.search(name):
            continue
        d = min(e, hi) - max(s, lo)
        if d > 0:
            total += d
            seen = True
    return total / len(rec["requests"]) if seen else None


def host_ns_per_request(rec: Dict[str, List[Interval]]) -> Optional[float]:
    """Mean over the requests of their wall time less the device's busy
    time inside them."""
    if not rec["requests"]:
        return None
    lo, hi = window(rec)
    pieces = union(rec["kernels"] + rec["copies"], lo, hi)
    starts = [s for s, _ in pieces]
    total = 0
    for _, s, e in rec["requests"]:
        busy = 0
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(pieces) and pieces[i][0] < e:
            busy += max(0, min(e, pieces[i][1]) - max(s, pieces[i][0]))
            i += 1
        total += (e - s) - busy
    return total / len(rec["requests"])
