"""h2d_ms_per_batch: the wall time of the program's ``vrt.h2d`` span (the
query upload of ``device_batch_search``: host float32 rows to a device
tensor, from pageable memory) a traced request, in ms. Layer: models
(``batch_search``). Moves qps."""

from retrieval_bench import spans

UNIT = "ms"


def read(rec, cell):
    return spans.wall_ms(rec, "vrt.h2d")
