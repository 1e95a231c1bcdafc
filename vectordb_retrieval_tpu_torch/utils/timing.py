"""Timing helpers that wait for the card.

PyTorch returns from a CUDA call before the card has run it, so a host
clock read right after measures the enqueue. :func:`block` waits for every
card that holds a tensor of its argument, and :func:`time_function` stops
its clock only after it.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Optional, Set

import torch


def _cuda_devices(tree: Any, found: Set[torch.device]) -> None:
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            found.add(tree.device)
    elif isinstance(tree, dict):
        for value in tree.values():
            _cuda_devices(value, found)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            _cuda_devices(value, found)


def block(tree: Any) -> Any:
    """Wait until the work queued on every CUDA device holding a tensor of
    ``tree`` (nested tuples, lists and dicts) is done, one
    ``torch.cuda.synchronize`` per device; return ``tree`` unchanged. A
    tree of CPU tensors returns at once."""
    found: Set[torch.device] = set()
    _cuda_devices(tree, found)
    for dev in sorted(found, key=str):
        torch.cuda.synchronize(dev)
    return tree


class Timer:
    """``with Timer() as t: ...`` then ``t.elapsed`` in seconds (host
    clock; call :func:`block` on the results inside the ``with``)."""

    def __init__(self, name: Optional[str] = None):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed = time.perf_counter() - self._start


def time_function(fn: Callable) -> Callable:
    """Decorator returning ``(result, elapsed_seconds)``; the clock stops
    after :func:`block` on the result."""

    @functools.wraps(fn)
    def wrapped(*args: Any, **kwargs: Any):
        start = time.perf_counter()
        out = block(fn(*args, **kwargs))
        return out, time.perf_counter() - start

    return wrapped
