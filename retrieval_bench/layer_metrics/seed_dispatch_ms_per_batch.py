"""seed_dispatch_ms_per_batch: the wall time of the program's ``vrt.seed``
span (the block beam's dense entry scan and first frontier, ``ops/graph.
BlockBeam.seed``) a traced request, in ms. Block-graph cells only.
Layer: search ops. Moves qps."""

from retrieval_bench import spans

UNIT = "ms"


def read(rec, cell):
    return spans.wall_ms(rec, "vrt.seed")
