"""d2h_ms_per_batch: the wall time of the program's ``vrt.d2h`` span (the
answers' copies to NumPy and their padding in ``batch_search``: the wait
for the card to finish the search, then the copies) a traced request, in
ms. Layer: models (``batch_search``). Moves qps."""

from retrieval_bench import spans

UNIT = "ms"


def read(rec, cell):
    return spans.wall_ms(rec, "vrt.d2h")
