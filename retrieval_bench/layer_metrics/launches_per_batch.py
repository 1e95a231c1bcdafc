"""launches_per_batch: the calls that put work on the card
(``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaLaunchKernelExC``,
``cudaMemcpyAsync`` and ``cudaMemsetAsync``, as the profiler names them)
that start inside the program's ``vrt.search`` span, a traced request:
the kernels, copies and memsets the host enqueues for one search. The
port's own kernels count too: K1 launches from the port's library
through ``cudaLaunchKernel``, which the profiler records like PyTorch's.
Attribute and occupancy queries, error checks and synchronisations are
not counted; the upload and the copies back lie outside the span.
Layer: search ops. Moves qps."""

from retrieval_bench import spans

UNIT = "launches"


def read(rec, cell):
    return spans.calls_in(rec, "vrt.search")
