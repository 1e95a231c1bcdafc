"""device_ms_per_batch: all kernel time in the traced window, over its
requests, in ms. Layer: search ops (``ops/distances``, ``ops/ivf``,
``ops/pq``). Moves qps."""

from retrieval_bench.trace import per_request_ns

UNIT = "ms"


def read(rec, cell):
    ns = per_request_ns(rec)
    return None if ns is None else ns / 1e6
