"""select_ms_per_batch: the device time of the sort and top-k kernels
(block selection, probe selection and the final cuts: ``torch.topk``,
``torch.sort`` / ``argsort`` and the CUB radix sorts beneath them) in the
traced window, over its requests, in ms. Layer: search ops. Moves qps."""

import re

from retrieval_bench.trace import per_request_ns

UNIT = "ms"

# PyTorch's top-k (gatherTopK, radixFindKthValues, the blockwise k-th
# counts of its multi-block path) and sort (bitonic / warp-merge / radix
# in place, segmented sorts) kernels, and CUB's radix sorts
PATTERN = re.compile(
    r"topk|TopK|Kth|kth|radixSelect|[Ss]ort|RadixSort|computeBlockwise|computeDigitCumSum"
)


def read(rec, cell):
    ns = per_request_ns(rec, PATTERN)
    return None if ns is None else ns / 1e6
