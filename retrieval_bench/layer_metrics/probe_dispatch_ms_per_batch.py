"""probe_dispatch_ms_per_batch: the wall time of the program's
``vrt.probe`` span (IVF's coarse probe, ``ops/ivf._probes``: the probe
table's distances and the top-k of the buckets each query probes) a
traced request, in ms. IVF cells only. Layer: search ops. Moves qps."""

from retrieval_bench import spans

UNIT = "ms"


def read(rec, cell):
    return spans.wall_ms(rec, "vrt.probe")
