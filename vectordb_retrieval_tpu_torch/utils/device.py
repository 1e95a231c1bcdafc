"""Device resolution for the port's entry points.

Every entry point takes ``device=None``. ``None`` means the CUDA card and
raises when there is none: the port never carries on quietly on the CPU.
Tests and CPU runs pass ``device="cpu"`` explicitly. A device may also be a
list of devices, the devices of a mesh (``parallel/mesh.py``): an entry
point that runs on one device takes the first, and for a mesh ``None``
means every visible card, once each (:func:`resolve_devices`).

Ranking-feeding f32 products must not drop to TF32 (about three decimal
digits), so resolving a device also turns TF32 off for matrix products and
for cuDNN, which defaults to it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

DeviceLike = Optional[Union[str, torch.device, Sequence[Union[str, torch.device]]]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("empty device list")
        device = device[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the host"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:  # concrete index, so it compares equal to a tensor's
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices of a mesh: a list resolves element by element (a device
    may repeat), one device is a list of one, and ``None`` is every visible
    card once each (raising when there is none)."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("empty device list")
        return [resolve_device(d) for d in device]
    if device is None:
        resolve_device(None)  # raises without a card
        return [resolve_device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    return [resolve_device(device)]


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
