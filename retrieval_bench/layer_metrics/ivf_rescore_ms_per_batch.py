"""ivf_rescore_ms_per_batch: the device time of IVF-Flat's block rescore
over bf16 lists (``ops/kernels.ivf_block_rescore``: ``ivf_block_rescore_kernel``
in ``csrc/block_rescore.cu``, stage 3 of the IVF streams) in the traced
window, over its requests, in ms. None where the kernel does not run (the
exact and graph cells; a program without the kernel). Layer: search ops.
Moves qps."""

import re

from retrieval_bench.trace import per_request_ns

UNIT = "ms"

# every instantiation of the template (row group, step group, load width,
# query chunks, metric), as the demangler prints it, namespace or not
PATTERN = re.compile(r"\bivf_block_rescore_kernel<")


def read(rec, cell):
    ns = per_request_ns(rec, PATTERN)
    return None if ns is None else ns / 1e6
