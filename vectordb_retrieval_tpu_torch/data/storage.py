"""Host corpus -> device tensor.

Only in-memory corpora are ported so far. Out-of-core inputs (``np.memmap``,
the JAX package's ``BigStore``) and the streaming exact search over them
come with the out-of-core data layer, ROADMAP queue 1 item 9b.
"""

from __future__ import annotations

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device

_OUT_OF_CORE = "out-of-core corpora are ported with the out-of-core data layer, ROADMAP queue 1 item 9b"


def is_out_of_core(vectors) -> bool:
    """True for memmap views and chunked on-disk stores (``as_memmap``)."""
    return isinstance(vectors, np.memmap) or hasattr(vectors, "as_memmap")


def corpus_to_device(vectors, device: DeviceLike = None) -> torch.Tensor:
    """Upload an in-memory corpus (ndarray or tensor) to ``device`` as a
    contiguous f32 tensor."""
    if is_out_of_core(vectors):
        raise NotImplementedError(_OUT_OF_CORE)
    if not isinstance(vectors, torch.Tensor):
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    return torch.as_tensor(
        vectors, dtype=torch.float32, device=resolve_device(device)
    ).contiguous()
