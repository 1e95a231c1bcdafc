"""k2_roofline_pct: the least time the block beam's slab scoring needs,
over K2's measured time, per request, in %.

Each wave of the block beam (``ops/graph.BlockBeam.score``) computes, for
each of the B queries, the dots with the L rows of each of the W slabs it
popped: ``[B, W, L]`` f32 dots. Whatever implements it, it has to do ``2 B
W L d`` operations, read the f32 queries once and write the f32 dots once.
The wave count, W and L come from the cell's efSearch and the
configuration's ``n`` and ``d`` through a copy of the port's block rules
(:func:`geometry`). Its least time is the larger of the operations over
the card's highest dense rate (989 TFLOP/s, bf16 on the tensor cores) and
those bytes over the card's HBM bandwidth (3.35 TB/s); the bytes dominate.

This is a floor, and the share reads low: the slabs a wave reads are left
out, because how many distinct slabs it pops is not known from shapes (at
most every slab, at least one). So the share never exceeds 100 %.
Measured: K2's kernels (the pattern of ``k2_ms_per_batch``) over the
traced requests. Block-graph cells only. Layer: kernels. Moves qps.
"""

import re

from retrieval_bench.trace import per_request_ns

UNIT = "%"

PATTERN = re.compile(r"\bslab_(?:prep|scan|scatter|dots_tc)_kernel\b")
GRAPH_INDEXERS = ("GraphIndexer", "HNSWIndexer")


def geometry(n: int, d: int, ef_search: int, block_size: int = 0, slab_bytes: int = 2):
    """``(waves, W, L)`` of one search: the block count and block length of
    ``models/graph.GraphIndexer._block_geom`` and ``ops/graph._chop``, then
    the probes of ``models/graph.block_geometry``."""
    block = block_size or (256 if 128 * d * slab_bytes < 65536 else 128)
    n_blocks = max(1, -(-n // block))
    length = max(1, -(-n // n_blocks))
    n_blocks = -(-n // length)
    probes = max(8, min(-(-(ef_search * 245) // length), n_blocks))
    waves = max(1, -(-probes // 96))
    return waves, -(-probes // waves), length


def read(rec, cell):
    indexer = cell["workload"]["algorithm"].get("indexer", {})
    if indexer.get("type") not in GRAPH_INDEXERS:
        return None
    ns = per_request_ns(rec, PATTERN)
    if ns is None:
        return None
    searcher = cell["workload"]["algorithm"].get("searcher", {})
    ef = int(searcher.get("efSearch", indexer.get("efSearch", 100)))
    slab_bytes = 4 if indexer.get("slab_dtype") == "f32" else 2
    waves, w, length = geometry(cell["config"]["n"], cell["config"]["d"], ef,
                                int(indexer.get("block_size", 0)), slab_bytes)
    b, d = cell["workload"]["batch"], cell["config"]["d"]
    peaks = cell["peaks"]
    least_s = waves * max(2.0 * b * w * length * d / peaks["bf16_dense_flops"],
                          4.0 * (b * d + b * w * length) / peaks["hbm_bytes_per_s"])
    return 100.0 * least_s / (ns / 1e9)
