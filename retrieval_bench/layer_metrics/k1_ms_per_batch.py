"""k1_ms_per_batch: the device time of kernel K1 (``ops/kernels.
dist_blockmin``: the f32, bf16 and u8 modes of ``blockmin_tc_kernel`` in
``csrc/dist_blockmin_tc.cu``) in the traced window, over its requests, in
ms. K3 (ASSIGN) and K4 (L2) run the same template in other modes and are
not counted. Layer: kernels. Moves qps."""

import re

from retrieval_bench.trace import per_request_ns

UNIT = "ms"

# the template's Mode enum: BF16 = 0, U8 = 1, F32 = 2 (L2 = 3, ASSIGN = 4),
# as the demangler prints it (a cast) or by name
PATTERN = re.compile(r"blockmin_tc_kernel<\s*\(?(?:vrt::btc::)?Mode(?:\)\s*|::)(?:0|1|2|BF16|U8|F32)\b")


def read(rec, cell):
    ns = per_request_ns(rec, PATTERN)
    return None if ns is None else ns / 1e6
