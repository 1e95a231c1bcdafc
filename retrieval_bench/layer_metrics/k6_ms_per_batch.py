"""k6_ms_per_batch: the device time of kernel K6 (``ops/kernels.
block_rescore``: ``block_rescore_kernel`` in ``csrc/block_rescore.cu``,
exact search's rescore of its selected blocks) in the traced window, over
its requests, in ms. None where K6 does not run (the IVF cells; a program
without the kernel). Layer: search ops. Moves qps."""

import re

from retrieval_bench.trace import per_request_ns

UNIT = "ms"

# every instantiation of the template (block width, load width, query
# chunks, metric), as the demangler prints it, namespace or not
PATTERN = re.compile(r"\bblock_rescore_kernel<")


def read(rec, cell):
    ns = per_request_ns(rec, PATTERN)
    return None if ns is None else ns / 1e6
