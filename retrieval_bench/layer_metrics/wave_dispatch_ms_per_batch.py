"""wave_dispatch_ms_per_batch: the wall time of the program's ``vrt.wave``
spans (each wave of the block beam: pop, K2, merge and push, ``ops/graph.
BlockBeam``), all waves of a traced request together, in ms. Block-graph
cells only. Layer: search ops. Moves qps."""

from retrieval_bench import spans

UNIT = "ms"


def read(rec, cell):
    return spans.wall_ms(rec, "vrt.wave")
