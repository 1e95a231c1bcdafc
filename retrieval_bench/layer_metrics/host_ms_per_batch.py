"""host_ms_per_batch: per request, its wall time (the benchmark's
``rb.request`` span around ``batch_search``) less the card's busy time
inside it, in ms, as a mean over the traced requests: the host's share of
a request (query upload, launches, synchronisation, the copy back).
Layer: models (``batch_search``). Moves qps."""

from retrieval_bench.trace import host_ns_per_request

UNIT = "ms"


def read(rec, cell):
    ns = host_ns_per_request(rec)
    return None if ns is None else ns / 1e6
