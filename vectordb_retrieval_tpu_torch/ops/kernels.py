"""Hand-written CUDA kernels of the port, their plain versions and wrappers.

Current kernels:
  * :func:`dist_blockmin` — fused distance + per-block minimum, f32 payloads
    (exact-search stage 1). Replaces the TPU kernel
    ``vectordb_retrieval_tpu/ops/pallas_kernels.py`` ``dist_blockmin_pallas``
    in its f32 mode. CUDA C++ source: ``csrc/dist_blockmin.cu``.

Each wrapper routes by the device of its tensors: a CUDA tensor goes to the
kernel (or the wrapper raises), a CPU tensor goes to the plain PyTorch
version beside it. Nothing falls back from one to the other.

Kernels are compiled from ``csrc/`` with ``nvcc`` for ``sm_90a`` at first
use, into ``_build/<hash of source and flags>/``, and loaded with
``ctypes`` through a plain C interface. Every launch adds one to
``LAUNCHES[name]``; nothing else touches the counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

KERNEL_SOURCES = ("dist_blockmin",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# launches per kernel, counted by the wrappers where they launch
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_SOURCES}
# compiler output (registers, spills, shared memory) of the builds this
# process made; empty for libraries found already built
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], f"lib{name}.so")


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "dist_blockmin":
        lib.vrt_dist_blockmin_f32.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.vrt_dist_blockmin_f32.restype = ci
    lib.vrt_cuda_error_string.argtypes = [ci]
    lib.vrt_cuda_error_string.restype = ctypes.c_char_p


def build(names: Iterable[str] = KERNEL_SOURCES) -> float:
    """Compile (where not already built) and load the named kernels.

    One ``nvcc`` process per source, all started together. Returns the
    wall-clock seconds spent.
    """
    t0 = time.perf_counter()
    todo = [n for n in names if n not in _LIBS]
    procs = {}
    for name in todo:
        path = _lib_path(name)
        if os.path.exists(path):
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        procs[name] = (
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, path,
        )
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name in todo:
        lib = ctypes.CDLL(_lib_path(name))
        _bind(name, lib)
        _LIBS[name] = lib
    return time.perf_counter() - t0


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build((name,))
    return _LIBS[name]


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        msg = _LIBS[name].vrt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


# ---- K1: fused distance + per-block minimum (f32 payloads) -------------


def dist_blockmin_pad_rows(n: int, w: int) -> int:
    """Rows the payload must be padded to (pad with ``pen = +inf`` rows).

    The CUDA kernel masks ragged tiles itself, so only ``S % w == 0`` is
    needed: every block of ``w`` rows is whole.
    """
    return -(-n // w) * w


_MAX_GRID_Y = 65535  # query tiles of 128 run along gridDim.y


def _default_chunk_rows(b: int) -> int:
    # the [B, chunk] score block of the plain version stays near 256 MB
    return max(4096, (1 << 26) // max(b, 1))


def dist_blockmin_reference(
    queries: torch.Tensor,
    payload: torch.Tensor,
    pen: torch.Tensor,
    w: int = 8,
    chunk_rows: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`dist_blockmin` (same contract).

    ``pen - 2 * (q @ payload.T)`` in f32, then the min over each ``w``
    consecutive rows, in row chunks of at most ``chunk_rows`` so the full
    ``[B, S]`` score matrix is never held at once.
    """
    b, s = queries.shape[0], payload.shape[0]
    chunk = chunk_rows or _default_chunk_rows(b)
    chunk = max(w, (chunk // w) * w)
    pen_flat = pen.reshape(-1)
    outs = []
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        sc = pen_flat[c0:c1] - 2.0 * (queries @ payload[c0:c1].T)
        outs.append(sc.reshape(b, (c1 - c0) // w, w).amin(dim=-1))
    if not outs:
        return torch.empty((b, 0), dtype=torch.float32, device=payload.device)
    return torch.cat(outs, dim=1)


def _check_dist_blockmin(
    queries: torch.Tensor, payload: torch.Tensor, pen: torch.Tensor, w: int
) -> None:
    if payload.dtype in (torch.bfloat16, torch.uint8):
        raise NotImplementedError(
            f"dist_blockmin: {payload.dtype} payloads (the bf16/u8 modes) are "
            "ported with the IVF slice, ROADMAP queue 1 item 4"
        )
    for t, what in ((queries, "queries"), (payload, "payload"), (pen, "pen")):
        if t.dtype != torch.float32:
            raise TypeError(f"dist_blockmin: {what} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"dist_blockmin: {what} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"dist_blockmin: {what} must be contiguous")
        if t.device != payload.device:
            raise ValueError(
                f"dist_blockmin: {what} on {t.device}, payload on {payload.device}"
            )
    if w < 1 or w > 128 or w & (w - 1):
        raise ValueError(f"dist_blockmin: w={w} must be a power of two <= 128")
    s, d = payload.shape
    if queries.shape[1] != d:
        raise ValueError(
            f"dist_blockmin: queries have d={queries.shape[1]}, payload d={d}"
        )
    if s % w:
        raise ValueError(
            f"dist_blockmin: S={s} must be a multiple of w={w} "
            "(pad with +inf-pen rows, dist_blockmin_pad_rows)"
        )
    if tuple(pen.shape) != (s // w, w):
        raise ValueError(
            f"dist_blockmin: pen shape {tuple(pen.shape)} != (S/w, w) = {(s // w, w)}"
        )
    if payload.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dist_blockmin: unsupported device {payload.device}")


def dist_blockmin(
    queries: torch.Tensor,  # [B, d] f32
    payload: torch.Tensor,  # [S, d] f32, S % w == 0
    pen: torch.Tensor,  # [S/w, w] f32 per-slot constant; +inf = dead slot
    w: int = 8,
    chunk_rows: Optional[int] = None,
) -> torch.Tensor:
    """Shifted per-block minima ``[B, S/w]``:
    ``out[q, g] = min_{j<w}(pen[g, j] - 2 * dot(payload[g*w+j], queries[q]))``.

    Per-query constants (``||q||^2``) are omitted: top-k block selection
    does not need them and the selected candidates are rescored exactly.
    ``pen`` holds ``||x||^2`` for l2, 0 for ip/cosine and +inf for dead or
    padding slots; a block whose slots are all dead yields +inf.

    CUDA tensors launch the kernel of ``csrc/dist_blockmin.cu`` (FP32 FFMA,
    bound by FP32 throughput at B = 256; see the source note) on the current
    stream. CPU tensors take :func:`dist_blockmin_reference`, with
    ``chunk_rows`` bounding its score block.
    """
    _check_dist_blockmin(queries, payload, pen, w)
    if payload.device.type == "cpu":
        return dist_blockmin_reference(queries, payload, pen, w, chunk_rows)
    b, s = queries.shape[0], payload.shape[0]
    out = torch.empty((b, s // w), dtype=torch.float32, device=payload.device)
    if b == 0 or s == 0:
        return out
    if b > _MAX_GRID_Y * 128 or s >= 2**31:
        raise ValueError(f"dist_blockmin: B={b}, S={s} exceed the launch grid")
    lib = _lib("dist_blockmin")
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vrt_dist_blockmin_f32(
            queries.data_ptr(), payload.data_ptr(), pen.data_ptr(),
            out.data_ptr(), b, s, payload.shape[1], w, stream,
        )
    _check_launch("dist_blockmin", rc)
    LAUNCHES["dist_blockmin"] += 1
    return out
