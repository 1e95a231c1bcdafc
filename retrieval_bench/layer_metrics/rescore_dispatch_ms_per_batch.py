"""rescore_dispatch_ms_per_batch: the wall time of the program's
``vrt.rescore`` spans (the gather, exact rescore and top-k of exact
search's blockmin path, and of IVF's block rescore and final exact
rescore: one span each, two a request where both run), summed a traced
request, in ms. Layer: search ops. Moves qps."""

from retrieval_bench import spans

UNIT = "ms"


def read(rec, cell):
    return spans.wall_ms(rec, "vrt.rescore")
