"""device_idle_pct: the share of the traced window in which nothing ran on
the card: the complement of the union of its kernel and copy intervals,
in %. Layer: the device. Moves qps."""

from retrieval_bench.trace import busy_ns, window

UNIT = "%"


def read(rec, cell):
    if not rec["requests"]:
        return None
    lo, hi = window(rec)
    if hi <= lo:
        return None
    return 100.0 * (1.0 - busy_ns(rec, lo, hi) / (hi - lo))
