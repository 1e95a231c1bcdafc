"""Host-side helpers shared by the out-of-core paths.

Counterpart of ``trim_host_heap`` in ``vectordb_retrieval_tpu/utils/
compat.py``; that module's JAX-only helpers (platform pinning, the
compilation cache, the TPU probe) have no PyTorch counterpart.
"""

from __future__ import annotations


def trim_host_heap() -> bool:
    """Return freed heap arenas to the OS (glibc ``malloc_trim``).

    Big streaming builds churn GBs of short-lived host buffers; glibc
    keeps the freed arenas resident, so a later phase's allocations stack
    on top of a stale high-water mark. Trimming at phase boundaries keeps
    peak RSS tracking LIVE memory. No-op (False) on non-glibc platforms.
    """
    import ctypes
    import gc

    gc.collect()
    try:
        libc = ctypes.CDLL("libc.so.6")
        return bool(libc.malloc_trim(0))
    except (OSError, AttributeError):
        return False
