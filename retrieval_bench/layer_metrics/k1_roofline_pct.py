"""k1_roofline_pct: the least time exact search's first pass needs, over
K1's measured time, per request, in %.

The first pass of exact search (``ops/distances._exact_search_blockmin``)
computes, for each of the B queries, the distance to each of the N rows of
d dimensions (block minima follow). Whatever implements it, it has to do
``2 B N d`` operations and read the database once at its stored width
(f32: 4 bytes a value) and the queries once (f32). Its least time is the
larger of the operations over the card's highest dense rate (989 TFLOP/s,
bf16 on the tensor cores) and those bytes over the card's HBM bandwidth
(3.35 TB/s). The work is counted for the function, not for the route a
kernel takes (K1 f32 does three TF32 products), and against the card's
highest rate, so no route reads over 100 %. Measured: the K1 kernels of
the traced window (the pattern of ``k1_ms_per_batch``) over its requests.
Exact cells only: elsewhere K1 serves another function.
Layer: kernels. Moves qps.
"""

import re

from retrieval_bench.trace import per_request_ns

UNIT = "%"

PATTERN = re.compile(r"blockmin_tc_kernel<\s*\(?(?:vrt::btc::)?Mode(?:\)\s*|::)(?:0|1|2|BF16|U8|F32)\b")
STORED_BYTES = 4  # the flat index keeps the rows in f32


def read(rec, cell):
    if cell["workload"]["guarantee"] != "exact":
        return None
    ns = per_request_ns(rec, PATTERN)
    if ns is None:
        return None
    b = cell["workload"]["batch"]
    n, d = cell["config"]["n"], cell["config"]["d"]
    peaks = cell["peaks"]
    least_s = max(
        2.0 * b * n * d / peaks["bf16_dense_flops"],
        STORED_BYTES * (n * d + b * d) / peaks["hbm_bytes_per_s"],
    )
    return 100.0 * least_s / (ns / 1e9)
