"""dispatch_ms_per_batch: the wall time of the program's ``vrt.search``
span (``device_kernel``: every search op enqueued on the card, and any
wait for it inside) a traced request, in ms: the host's time to enqueue
the search. Layer: search ops. Moves qps."""

from retrieval_bench import spans

UNIT = "ms"


def read(rec, cell):
    return spans.wall_ms(rec, "vrt.search")
