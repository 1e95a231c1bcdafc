"""Device mesh and row-sharded arrays of the row-sharded family.

Counterpart of ``vectordb_retrieval_tpu/parallel/mesh.py``. The JAX package
drives every device of its mesh from one process (``shard_map``): the
host-side bookkeeping of a sharded index runs once per index, not once per
device. The port keeps that shape:

  * a :class:`Mesh` names a grid of torch devices inside one process along
    its axes (``db`` rows, ``q`` query blocks, ``replica`` copies), and a
    device may appear more than once: four shards on one card are the
    counterpart of the JAX tests' eight virtual CPU devices;
  * ``torch.distributed`` carries only the process axis (``dcn``):
    :func:`init_distributed`, :func:`make_multihost_mesh` and
    :func:`host_local_rows`. Each process holds its own devices of the
    mesh, and the merge gathers candidates across processes;
  * a :class:`ShardedTensor` is a row-sharded array: one tensor per mesh
    coordinate, on that coordinate's device. Coordinates of the other axes
    that name the same device and hold the same shard share one tensor. Its
    host form is the JAX package's global array, so artifacts persist in
    either package's format.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device, resolve_devices

Axis = Union[str, Tuple[str, ...]]
Coord = Tuple[int, ...]
# a process group's collectives fail after this long instead of hanging
_GROUP_TIMEOUT_S = 120


def _names(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """Named axes over a grid of devices of this process.

    ``devices`` is an object array of ``torch.device`` in the mesh's local
    shape; ``shape`` maps each axis to its global size, like
    ``jax.sharding.Mesh.shape``. The process axis (``process_axis``, with
    ``group``, a ``torch.distributed`` process group) has local size 1 and
    global size the group's world: this process holds coordinate ``rank``
    of it.
    """

    def __init__(
        self,
        devices: np.ndarray,
        axis_names: Sequence[str],
        group=None,
        process_axis: Optional[str] = None,
    ):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {devices.shape} for axes {self.axis_names}")
        self.process_axis = process_axis
        self.group = group
        self.rank, self.world = 0, 1
        shape = list(devices.shape)
        if process_axis is not None:
            if devices.shape[self.axis_names.index(process_axis)] != 1:
                raise ValueError(f"process axis {process_axis!r} must have local size 1")
            if group is not None:
                import torch.distributed as dist

                self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
            shape[self.axis_names.index(process_axis)] = self.world
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"

    @property
    def first_device(self) -> torch.device:
        return self.devices.reshape(-1)[0]

    def synchronize(self) -> None:
        """Wait for the queued work of every card of the mesh."""
        for dev in {d for d in self.devices.reshape(-1) if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    def size(self, axis: Axis) -> int:
        """Global size of one axis or the product of a tuple of axes."""
        return int(np.prod([self.shape[a] for a in _names(axis)]))

    def spans_processes(self, axis: Axis) -> bool:
        """Whether ``axis`` takes in the process axis of an initialised
        group (a world of one too: its merge runs the same ``all_gather``)."""
        return self.process_axis in _names(axis) and self.group is not None

    def coords(self) -> List[Coord]:
        return [tuple(int(i) for i in c) for c in np.ndindex(*self.devices.shape)]

    def global_index(self, coord: Coord, axis_name: str) -> int:
        i = coord[self.axis_names.index(axis_name)]
        return i + self.rank if axis_name == self.process_axis else i

    def shard_index(self, coord: Coord, axis: Axis) -> int:
        """The global shard index of a local coordinate along ``axis`` (a
        tuple of axes flattens major to minor, as ``P(("dcn", "db"))``)."""
        s = 0
        for a in _names(axis):
            s = s * self.shape[a] + self.global_index(coord, a)
        return s

    def rings(self, axis: Axis, q_axis: Optional[str] = None) -> List[List[Coord]]:
        """The local coordinates of one ring along ``axis`` per query block:
        the ring at coordinate ``r`` of ``q_axis`` (0 on every other axis)
        for each ``r``, or, without ``q_axis``, the ring at 0. Each ring is
        ordered by shard index."""
        names = _names(axis)
        others = [a for a in self.axis_names if a not in names]
        blocks = range(self.shape[q_axis]) if q_axis is not None else [0]
        out = []
        for r in blocks:
            ring = [c for c in self.coords()
                    if all(c[self.axis_names.index(a)] == (r if a == q_axis else 0)
                           for a in others)]
            out.append(sorted(ring, key=lambda c: self.shard_index(c, axis)))
        return out


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("db",),
    shape: Optional[Sequence[int]] = None,
    devices: DeviceLike = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (``None``: every
    visible card once each; a list may repeat a device, e.g. ``["cpu"] *
    8`` or ``["cuda:0"] * 4``). Default is a 1-D ``("db",)`` mesh; pass
    ``axis_names=("q", "db")`` and a ``shape`` to add query parallelism."""
    devs = resolve_devices(devices)
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, only {len(devs)} available")
    if shape is None:
        shape = (n_devices,) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"shape {tuple(shape)} != {n_devices} devices")
    arr = np.empty(n_devices, dtype=object)
    for i in range(n_devices):
        arr[i] = devs[i]
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> bool:
    """Join the processes of the mesh's process axis.

    ``torch.distributed.init_process_group`` with NCCL when ``device`` is a
    card (``None``: the card) and gloo on the CPU. The arguments default to
    torchrun's environment (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``); a world of one with no address uses an in-process store.
    Idempotent; returns True when more than one process takes part.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=_GROUP_TIMEOUT_S)
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError("a world of more than one process needs a coordinator address")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                rank=process_id, world_size=num_processes, timeout=timeout)
    return dist.get_world_size() > 1


def make_multihost_mesh(
    axis_names: Tuple[str, ...] = ("dcn", "db"),
    devices: DeviceLike = None,
) -> Mesh:
    """Global mesh over all processes: the process axis (``dcn``, the
    initialised process group) outer, this process's ``devices`` inner.
    The database shards over both axes, so the merge is a local gather of
    each process's shards and one ``all_gather`` of k-wide candidate lists
    across processes. Without an initialised group the process axis has
    size 1. Call :func:`init_distributed` first on every process."""
    import torch.distributed as dist

    devs = resolve_devices(devices)
    arr = np.empty((1, len(devs)), dtype=object)
    for i, d in enumerate(devs):
        arr[0, i] = d
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    return Mesh(arr, axis_names, group=group, process_axis=axis_names[0])


def host_local_rows(n: int) -> Tuple[int, int]:
    """Contiguous ``[lo, hi)`` row range this process should load and build
    (a world of one without an initialised process group)."""
    import torch.distributed as dist

    p, i = 1, 0
    if dist.is_available() and dist.is_initialized():
        p, i = dist.get_world_size(), dist.get_rank()
    per = -(-n // p)
    return i * per, min((i + 1) * per, n)


class ShardedTensor:
    """A row-sharded array over ``mesh`` along ``axis``.

    ``tensors`` maps each local mesh coordinate to its shard's tensor on
    that coordinate's device. The global array is the shards stacked
    (``stacked``: ``[P, ...]``, the JAX package's per-shard index stacks) or
    concatenated along rows (``[P * rows, ...]``, its row-sharded corpora).
    """

    def __init__(self, mesh: Mesh, axis: Axis, tensors: Dict[Coord, torch.Tensor], stacked: bool):
        self.mesh, self.axis, self.tensors, self.stacked = mesh, axis, tensors, stacked

    @classmethod
    def place(cls, array, mesh: Mesh, axis: Axis = "db", stacked: bool = True) -> "ShardedTensor":
        """Split ``array`` (numpy or a tensor, ``[P, ...]`` when ``stacked``,
        else rows a multiple of ``P``) over ``mesh`` along ``axis``; each
        shard moves once to each distinct device that holds it."""
        t = array if isinstance(array, torch.Tensor) else torch.as_tensor(np.ascontiguousarray(array))
        p = mesh.size(axis)
        if stacked and t.shape[0] != p:
            raise ValueError(f"stacked array of {t.shape[0]} shards over {p}")
        if not stacked and t.shape[0] % p:
            raise ValueError(f"{t.shape[0]} rows do not split over {p} shards")
        per = t.shape[0] // p
        made: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        tensors = {}
        for c in mesh.coords():
            s, dev = mesh.shard_index(c, axis), mesh.devices[c]
            if (s, dev) not in made:
                part = t[s] if stacked else t[s * per : (s + 1) * per]
                made[(s, dev)] = part.to(dev).contiguous()
            tensors[c] = made[(s, dev)]
        return cls(mesh, axis, tensors, stacked)

    def shard(self, coord: Coord) -> torch.Tensor:
        return self.tensors[coord]

    def _unique(self) -> List[Tuple[int, torch.Tensor]]:
        seen, out = set(), []
        for c, t in self.tensors.items():
            if id(t) not in seen:
                seen.add(id(t))
                out.append((self.mesh.shard_index(c, self.axis), t))
        return out

    def copies(self, s: int) -> List[torch.Tensor]:
        """Every distinct tensor holding shard ``s`` (replicas on other
        devices, or unshared ones): the tensors a write must reach."""
        return [t for i, t in self._unique() if i == s]

    def apply(self, fn: Callable[[int, torch.Tensor], torch.Tensor]) -> "ShardedTensor":
        """A new array of ``fn(shard index, tensor)`` for each distinct
        tensor, shared where the old ones were."""
        new = {id(t): fn(s, t) for s, t in self._unique()}
        return ShardedTensor(self.mesh, self.axis,
                             {c: new[id(t)] for c, t in self.tensors.items()}, self.stacked)

    @property
    def n_shards(self) -> int:
        return self.mesh.size(self.axis)

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.tensors.values())).dtype

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        return tuple(next(iter(self.tensors.values())).shape)

    @property
    def shape(self) -> Tuple[int, ...]:
        per = self.shard_shape
        if self.stacked:
            return (self.n_shards,) + per
        return (self.n_shards * per[0],) + per[1:]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def device_nbytes(self) -> int:
        return sum(int(t.numel() * t.element_size()) for _, t in self._unique())

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        """The global array on the host (one process's mesh only)."""
        if self.mesh.world > 1 and self.mesh.process_axis in _names(self.axis):
            raise ValueError("a sharded array spanning processes has no host copy here")
        parts = {}
        for s, t in self._unique():
            parts.setdefault(s, t)
        host = [parts[s].detach().cpu().numpy() for s in range(self.n_shards)]
        out = np.stack(host) if self.stacked else np.concatenate(host)
        return out if dtype is None else out.astype(dtype)


class Laps:
    """Seconds of a build by part, each part closed with the mesh's cards
    drained (``build_seconds`` of the sharded builds)."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.seconds, self._t = mesh, {}, time.perf_counter()

    def __call__(self, part: str) -> None:
        self.mesh.synchronize()
        now = time.perf_counter()
        self.seconds[part] = self.seconds.get(part, 0.0) + now - self._t
        self._t = now


def place_stacks(stacks: Dict[str, np.ndarray], mesh: Mesh, axis: Axis = "db") -> Dict[str, ShardedTensor]:
    """Each ``[P, ...]`` host stack of a sharded index placed over ``mesh``."""
    return {key: ShardedTensor.place(val, mesh, axis) for key, val in stacks.items()}
