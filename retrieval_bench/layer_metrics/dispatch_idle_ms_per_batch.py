"""dispatch_idle_ms_per_batch: device idle inside the program's
``vrt.search`` span a traced request, in ms: the span's interval less the
union of the kernels and copies running in it, the card waiting on the
host's enqueue. Layer: the device. Moves qps."""

from retrieval_bench import spans

UNIT = "ms"


def read(rec, cell):
    return spans.idle_ms(rec, "vrt.search")
