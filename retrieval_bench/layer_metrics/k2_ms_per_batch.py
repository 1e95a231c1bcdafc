"""k2_ms_per_batch: the device time of kernel K2 (``ops/kernels.
slab_dots``, ``csrc/slab_dots.cu``: its grouping kernels
``slab_prep_kernel``, ``slab_scan_kernel`` and ``slab_scatter_kernel``,
then its product ``slab_dots_tc_kernel``) in the traced window, over its
requests, in ms: the block beam's slab scoring, every wave of a request.
None where K2 does not run (cells without a block graph).
Layer: kernels. Moves qps."""

import re

from retrieval_bench.trace import per_request_ns

UNIT = "ms"

# K2's four kernels by their demangled names (any template argument or
# namespace), and no other kernel
PATTERN = re.compile(r"\bslab_(?:prep|scan|scatter|dots_tc)_kernel\b")


def read(rec, cell):
    ns = per_request_ns(rec, PATTERN)
    return None if ns is None else ns / 1e6
