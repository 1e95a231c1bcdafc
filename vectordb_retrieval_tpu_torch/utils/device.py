"""Device resolution for the port's entry points.

Every entry point takes ``device=None``. ``None`` means the CUDA card and
raises when there is none: the port never carries on quietly on the CPU.
Tests and CPU runs pass ``device="cpu"`` explicitly.

Ranking-feeding f32 products must not drop to TF32 (about three decimal
digits), so resolving a device also turns TF32 off for matrix products and
for cuDNN, which defaults to it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
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


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
