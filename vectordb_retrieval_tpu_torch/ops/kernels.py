"""Hand-written CUDA kernels of the port, their plain versions and wrappers.

Kernels (each replaces one TPU kernel of
``vectordb_retrieval_tpu/ops/pallas_kernels.py``):
  * :func:`dist_blockmin` — fused distance + per-block minimum over f32,
    bf16 or u8 payloads (exact-search stage 1; the IVF-Flat and IVF-SQ8
    fused probed stream; the cover tree's block walk). Replaces
    ``dist_blockmin_pallas`` in all three of its modes. CUDA C++ source:
    ``csrc/dist_blockmin_tc.cu``, on the tensor cores with ``wgmma`` (f32
    by 3xTF32, bf16 and u8 by one bf16 product);
    :func:`dist_blockmin_pair` applies two pens to one bf16/u8 product in
    one launch.
  * :func:`assign` — nearest-centroid (argmin, min) for k-means fitting and
    IVF list assignment. Replaces ``assign_pallas``. CUDA C++ source:
    ``csrc/assign.cu``.
  * :func:`slab_dots` — dot products of each query with the member slabs of
    the blocks its graph beam popped (the block beam's wave probe). Replaces
    ``slab_dots_manual`` and ``slab_dots_pallas``, which share one contract.
    CUDA C++ source: ``csrc/slab_dots.cu``.
  * :func:`blockmin` — full-L2 per-block minima over interleaved blocks of
    2048-row tiles (the first blockmin exact search's fused stage 1; no
    search path calls it, :func:`dist_blockmin` superseded it). Replaces
    ``blockmin_pallas``. CUDA C++ source: ``csrc/blockmin.cu``, on the
    tensor cores by 3xTF32 (the main loop of K1's f32 mode).

Each wrapper routes by the device of its tensors: a CUDA tensor goes to the
kernel (or the wrapper raises), a CPU tensor goes to the plain PyTorch
version beside it. Nothing falls back from one to the other.

Kernels are compiled from ``csrc/`` (each source includes one of the
headers there: the tensor-core kernel ``blockmin_tc.cuh``, on the helpers
of ``wgmma.cuh``, for K1 and K4; the FFMA tile ``ffma_tile.cuh`` for K2 and
K3) with ``nvcc`` for ``sm_90a`` at first use, into
``_build/<hash of source, every header and flags>/``, and loaded with
``ctypes`` through a plain C interface. Every launch adds one to
``LAUNCHES[name]`` (one name per kernel mode); nothing else touches the
counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

KERNEL_SOURCES = ("dist_blockmin_tc", "assign", "slab_dots", "blockmin")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# dist_blockmin's payload dtype -> (launch-count name, source, C entry point)
_DBM_MODES = {
    torch.float32: ("dist_blockmin", "dist_blockmin_tc", "vrt_dist_blockmin_f32"),
    torch.bfloat16: ("dist_blockmin_bf16", "dist_blockmin_tc", "vrt_dist_blockmin_bf16"),
    torch.uint8: ("dist_blockmin_u8", "dist_blockmin_tc", "vrt_dist_blockmin_u8"),
}
# dist_blockmin_pair's payload dtype -> C entry point (in dist_blockmin_tc)
_PAIR_ENTRIES = {
    torch.bfloat16: "vrt_dist_blockmin_pair_bf16",
    torch.uint8: "vrt_dist_blockmin_pair_u8",
}
# slab_dots' slab dtype -> C entry point (one launch count for both)
_SLAB_MODES = {
    torch.float32: "vrt_slab_dots_f32",
    torch.bfloat16: "vrt_slab_dots_bf16",
}
KERNELS = tuple(name for name, _, _ in _DBM_MODES.values()) + ("assign", "slab_dots", "blockmin")

# launches per kernel mode, counted by the wrappers where they launch
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
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
    # keyed by the source, every header of csrc/ and the flags
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for src in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], f"lib{name}.so")


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # C entry point -> argument types (every entry point returns an int)
    sigs = {fn: [vp] * 4 + [ci] * 4 + [vp]
            for _, source, fn in _DBM_MODES.values() if source == name}
    if name == "dist_blockmin_tc":
        sigs.update({fn: [vp] * 6 + [ci] * 4 + [vp] for fn in _PAIR_ENTRIES.values()})
    elif name == "assign":
        sigs["vrt_assign_f32"] = [vp] * 5 + [ci] * 3 + [vp]
    elif name == "slab_dots":
        sigs.update({fn: [vp] * 4 + [ci] * 5 + [vp] for fn in _SLAB_MODES.values()})
    elif name == "blockmin":
        sigs["vrt_blockmin_f32"] = [vp] * 4 + [ci] * 5 + [vp]
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ci
    lib.vrt_cuda_error_string.argtypes = [ci]
    lib.vrt_cuda_error_string.restype = ctypes.c_char_p


def build(names: Iterable[str] = KERNEL_SOURCES) -> float:
    """Compile (where not already built) and load the named kernel sources.

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


def _check_launch(source: str, name: str, rc: int) -> None:
    if rc != 0:
        msg = _LIBS[source].vrt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def _check_2d(fn: str, what: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"{fn}: {what} must be 2-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {what} must be contiguous")
    if t.device != like.device:
        raise ValueError(f"{fn}: {what} on {t.device}, expected {like.device}")


def _check_device(fn: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {t.device}")


# ---- the 3xTF32 split of K1's f32 mode and K4 ----------------------------


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)`` of an f32 tensor as the tensor-core kernels split
    each staged value (``csrc/blockmin_tc.cuh``, ``cvt.rna.tf32.f32``):
    ``big = rna(x)``, ``small = rna(x - big)``, where ``rna`` keeps 10
    mantissa bits, rounding to nearest with ties away from zero (the low 13
    bits of each piece are zero). ``big + small`` is ``x`` to the rounding
    of ``small`` (~2^-22 relative); products of pieces are exact in f32, so
    ``small_q big_x + big_q small_x + big_q big_x`` is the kernels' product.
    The kernels split in shared memory; no search path calls this."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        # on the magnitude bits: + half of the dropped field, carry, clear
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    big = rna(x)
    return big, rna(x - big)


# ---- K1: fused distance + per-block minimum ------------------------------


def dist_blockmin_pad_rows(n: int, w: int) -> int:
    """Rows the payload must be padded to (pad with ``pen = +inf`` rows).

    The CUDA kernel masks ragged tiles itself, so only ``S % w == 0`` is
    needed: every block of ``w`` rows is whole.
    """
    return -(-n // w) * w


def _default_chunk_rows(b: int) -> int:
    # the [B, chunk] score block of the plain version stays near 256 MB
    return max(4096, (1 << 26) // max(b, 1))


def _kernel_queries(queries: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """The queries the kernel reads: f32 for f32 payloads, else bf16
    (rounded to nearest even from f32, as the TPU kernel casts them)."""
    if payload.dtype == torch.float32:
        return queries
    return queries.to(torch.bfloat16).contiguous()


def _blockmin_plain(queries, payload, pens, w, chunk_rows):
    """``pen - 2 * (q @ payload.T)`` per pen, min over each ``w`` rows; one
    product per row chunk serves every pen."""
    b, s = queries.shape[0], payload.shape[0]
    chunk = chunk_rows or _default_chunk_rows(b)
    chunk = max(w, (chunk // w) * w)
    q = _kernel_queries(queries, payload).float()
    flats = [pen.reshape(-1) for pen in pens]
    outs = [[] for _ in pens]
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        dots2 = 2.0 * (q @ payload[c0:c1].float().T)
        for out, flat in zip(outs, flats):
            out.append((flat[c0:c1] - dots2).reshape(b, (c1 - c0) // w, w).amin(dim=-1))
    if s == 0:
        return [torch.empty((b, 0), dtype=torch.float32, device=payload.device) for _ in pens]
    return [torch.cat(out, dim=1) for out in outs]


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
    ``[B, S]`` score matrix is never held at once. bf16 and u8 payloads
    are widened to f32 (exactly) and dotted with the bf16-rounded queries.
    """
    return _blockmin_plain(queries, payload, (pen,), w, chunk_rows)[0]


def dist_blockmin_pair_reference(
    queries: torch.Tensor,
    payload: torch.Tensor,
    pen_a: torch.Tensor,
    pen_b: torch.Tensor,
    w: int = 8,
    chunk_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`dist_blockmin_pair`: one product per
    row chunk, both pens' minima from it (each equal to
    :func:`dist_blockmin_reference` with that pen)."""
    out_a, out_b = _blockmin_plain(queries, payload, (pen_a, pen_b), w, chunk_rows)
    return out_a, out_b


def _check_dist_blockmin(
    queries: torch.Tensor, payload: torch.Tensor, pen: torch.Tensor, w: int,
    fn: str = "dist_blockmin",
) -> None:
    if payload.dtype not in _DBM_MODES:
        raise TypeError(
            f"{fn}: payload must be float32, bfloat16 or uint8, got {payload.dtype}"
        )
    q_ok = (torch.float32,) if payload.dtype == torch.float32 else (
        torch.float32, torch.bfloat16)
    if queries.dtype not in q_ok:
        raise TypeError(
            f"{fn}: queries for a {payload.dtype} payload must be one of "
            f"{q_ok}, got {queries.dtype}"
        )
    if pen.dtype != torch.float32:
        raise TypeError(f"{fn}: pen must be float32, got {pen.dtype}")
    for t, what in ((queries, "queries"), (payload, "payload"), (pen, "pen")):
        _check_2d(fn, what, t, payload)
    if w < 1 or w > 128 or w & (w - 1):
        raise ValueError(f"{fn}: w={w} must be a power of two <= 128")
    s, d = payload.shape
    if queries.shape[1] != d:
        raise ValueError(f"{fn}: queries have d={queries.shape[1]}, payload d={d}")
    if s % w:
        raise ValueError(
            f"{fn}: S={s} must be a multiple of w={w} "
            "(pad with +inf-pen rows, dist_blockmin_pad_rows)"
        )
    if tuple(pen.shape) != (s // w, w):
        raise ValueError(
            f"{fn}: pen shape {tuple(pen.shape)} != (S/w, w) = {(s // w, w)}"
        )
    _check_device(fn, payload)


def _launch_dist_blockmin(queries, payload, pens, w):
    """One K1 launch for one pen or (tensor-core modes) two; returns the
    outputs and counts the launch once under the payload's mode."""
    b, s = queries.shape[0], payload.shape[0]
    outs = [torch.empty((b, s // w), dtype=torch.float32, device=payload.device)
            for _ in pens]
    if b == 0 or s == 0:
        return outs
    count_as, source, entry = _DBM_MODES[payload.dtype]
    if len(pens) == 2:
        entry = _PAIR_ENTRIES[payload.dtype]
    # the kernel's grid is persistent (a card's worth of blocks)
    if b >= 2**31 or s >= 2**31:
        raise ValueError(f"{count_as}: B={b}, S={s} exceed the launch grid")
    q = _kernel_queries(queries, payload)
    lib = _lib(source)
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            q.data_ptr(), payload.data_ptr(), *(p.data_ptr() for p in pens),
            *(o.data_ptr() for o in outs), b, s, payload.shape[1], w, stream,
        )
    _check_launch(source, count_as, rc)
    LAUNCHES[count_as] += 1
    return outs


def dist_blockmin(
    queries: torch.Tensor,  # [B, d] f32 (bf16 also taken for bf16/u8 payloads)
    payload: torch.Tensor,  # [S, d] f32 | bf16 | u8, S % w == 0
    pen: torch.Tensor,  # [S/w, w] f32 per-slot constant; +inf = dead slot
    w: int = 8,
    chunk_rows: Optional[int] = None,
) -> torch.Tensor:
    """Shifted per-block minima ``[B, S/w]``:
    ``out[q, g] = min_{j<w}(pen[g, j] - 2 * dot(payload[g*w+j], queries[q]))``.

    Per-query constants (``||q||^2``, SQ8's ``q.vmin``) are omitted: top-k
    block selection does not need them and the selected candidates are
    rescored exactly. ``pen`` holds ``||x||^2`` for l2, 0 for ip/cosine and
    +inf for dead or padding slots; a block whose slots are all dead yields
    +inf. The payload's dtype picks the mode: f32 (f32 queries), bf16 or
    u8 (queries cast to bf16 here when given as f32).

    CUDA tensors launch, on the current stream, the kernel of
    ``csrc/dist_blockmin_tc.cu`` (wgmma on the tensor cores; f32 by 3xTF32,
    see :func:`split_tf32` and the source notes) and count under
    ``LAUNCHES['dist_blockmin' | 'dist_blockmin_bf16' | 'dist_blockmin_u8']``. CPU tensors take :func:`dist_blockmin_reference`,
    with ``chunk_rows`` bounding its score block.
    """
    _check_dist_blockmin(queries, payload, pen, w)
    if payload.device.type == "cpu":
        return dist_blockmin_reference(queries, payload, pen, w, chunk_rows)
    return _launch_dist_blockmin(queries, payload, (pen,), w)[0]


def dist_blockmin_pair(
    queries: torch.Tensor,  # [B, d] f32 | bf16
    payload: torch.Tensor,  # [S, d] bf16 | u8, S % w == 0
    pen_a: torch.Tensor,  # [S/w, w] f32
    pen_b: torch.Tensor,  # [S/w, w] f32
    w: int = 8,
    chunk_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dist_blockmin(.., pen_a, w), dist_blockmin(.., pen_b, w))`` from one
    product: the cover tree's pens of all and of real nodes over one slab.

    bf16 and u8 payloads only (the tensor-core modes). CUDA tensors launch
    the kernel of ``csrc/dist_blockmin_tc.cu`` once, whose epilogue applies
    both pens to one accumulator and writes both outputs, and count once
    under ``LAUNCHES['dist_blockmin_bf16' | 'dist_blockmin_u8']``. CPU
    tensors take :func:`dist_blockmin_pair_reference`.
    """
    fn = "dist_blockmin_pair"
    if payload.dtype not in _PAIR_ENTRIES:
        raise TypeError(f"{fn}: payload must be bfloat16 or uint8, got {payload.dtype}")
    for pen in (pen_a, pen_b):
        _check_dist_blockmin(queries, payload, pen, w, fn)
    if payload.device.type == "cpu":
        return dist_blockmin_pair_reference(queries, payload, pen_a, pen_b, w, chunk_rows)
    out_a, out_b = _launch_dist_blockmin(queries, payload, (pen_a, pen_b), w)
    return out_a, out_b


# ---- K3: nearest-centroid assignment -------------------------------------


def _default_assign_chunk(k: int) -> int:
    # the [chunk, K] distance block of the plain version stays near 256 MB
    return max(1024, (1 << 26) // max(k, 1))


def assign_reference(
    points: torch.Tensor,
    centroids: torch.Tensor,
    chunk_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`assign` (same contract): per row
    chunk, ``||p||^2 + ||c||^2 - 2 p.c`` then ``argmin`` (first minimum)
    and ``min`` — the JAX package's ``_chunk_l2`` assignment."""
    n = points.shape[0]
    chunk = chunk_rows or _default_assign_chunk(centroids.shape[0])
    cn = torch.sum(centroids * centroids, dim=-1)
    ids, mins = [], []
    for c0 in range(0, n, chunk):
        pc = points[c0 : c0 + chunk]
        pn = torch.sum(pc * pc, dim=-1)
        dist = pn[:, None] + cn[None, :] - 2.0 * (pc @ centroids.T)
        ids.append(torch.argmin(dist, dim=1))  # first minimum, as jnp.argmin
        mins.append(torch.amin(dist, dim=1))
    if not ids:
        return (torch.empty((0,), dtype=torch.int64, device=points.device),
                torch.empty((0,), dtype=torch.float32, device=points.device))
    return torch.cat(ids), torch.cat(mins)


def assign(
    points: torch.Tensor,  # [N, d] f32
    centroids: torch.Tensor,  # [K, d] f32
    chunk_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid per point: ``(ids int64 [N], min_dist f32 [N])``
    under ``||p||^2 + ||c||^2 - 2 p.c``; equal distances resolve to the
    lowest centroid id.

    CUDA tensors launch the kernel of ``csrc/assign.cu`` (FP32 FFMA GEMM
    with an argmin/min epilogue; the [N, K] matrix is never written) and
    count under ``LAUNCHES['assign']``. CPU tensors take
    :func:`assign_reference`, with ``chunk_rows`` bounding its block.
    """
    fn = "assign"
    for t, what in ((points, "points"), (centroids, "centroids")):
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {what} must be float32, got {t.dtype}")
        _check_2d(fn, what, t, points)
    if centroids.shape[1] != points.shape[1]:
        raise ValueError(
            f"{fn}: points have d={points.shape[1]}, centroids d={centroids.shape[1]}"
        )
    if centroids.shape[0] < 1:
        raise ValueError(f"{fn}: need at least one centroid")
    _check_device(fn, points)
    if points.device.type == "cpu":
        return assign_reference(points, centroids, chunk_rows)
    n, d = points.shape
    k = centroids.shape[0]
    ids = torch.empty((n,), dtype=torch.int64, device=points.device)
    mins = torch.empty((n,), dtype=torch.float32, device=points.device)
    if n == 0:
        return ids, mins
    if n >= 2**31 or k >= 2**31:
        raise ValueError(f"{fn}: N={n}, K={k} exceed the launch grid")
    cn = torch.sum(centroids * centroids, dim=-1)
    lib = _lib("assign")
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vrt_assign_f32(
            points.data_ptr(), centroids.data_ptr(), cn.data_ptr(),
            ids.data_ptr(), mins.data_ptr(), n, k, d, stream,
        )
    _check_launch("assign", "assign", rc)
    LAUNCHES["assign"] += 1
    return ids, mins


# ---- K2: block-slab dot products -----------------------------------------

# the [B, w, L, d] f32 gather of the plain version stays near this
_SLAB_PLAIN_BYTES = 256 << 20


def slab_dots_reference(
    queries: torch.Tensor,
    list_vecs: torch.Tensor,
    sel: torch.Tensor,
    chunk_bytes: int = _SLAB_PLAIN_BYTES,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`slab_dots` (same contract):
    ``einsum("bwld,bd->bwl", list_vecs[sel].float(), queries)`` in chunks
    of popped slabs, so the gathered ``[B, w, L, d]`` f32 copy stays near
    ``chunk_bytes`` — what the JAX package computes off the TPU."""
    b, w = sel.shape
    _, length, d = list_vecs.shape
    per_slab = max(b * length * d * 4, 1)
    step = max(1, min(w, chunk_bytes // per_slab))
    idx = sel.long()
    q = queries.float()
    outs = [
        torch.einsum("bwld,bd->bwl", list_vecs[idx[:, c0 : c0 + step]].float(), q)
        for c0 in range(0, w, step)
    ]
    if not outs:
        return torch.empty((b, 0, length), dtype=torch.float32, device=queries.device)
    return torch.cat(outs, dim=1)


def _check_slab_dots(queries: torch.Tensor, list_vecs: torch.Tensor, sel: torch.Tensor) -> None:
    fn = "slab_dots"
    if queries.dtype != torch.float32:
        raise TypeError(f"{fn}: queries must be float32, got {queries.dtype}")
    if list_vecs.dtype not in _SLAB_MODES:
        raise TypeError(
            f"{fn}: list_vecs must be float32 or bfloat16, got {list_vecs.dtype}"
        )
    if sel.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{fn}: sel must be int32 or int64, got {sel.dtype}")
    if queries.dim() != 2 or list_vecs.dim() != 3 or sel.dim() != 2:
        raise ValueError(
            f"{fn}: expected queries [B, d], list_vecs [Nb, L, d], sel [B, W]; got "
            f"{tuple(queries.shape)}, {tuple(list_vecs.shape)}, {tuple(sel.shape)}"
        )
    if queries.shape[1] != list_vecs.shape[2]:
        raise ValueError(
            f"{fn}: queries have d={queries.shape[1]}, list_vecs d={list_vecs.shape[2]}"
        )
    if sel.shape[0] != queries.shape[0]:
        raise ValueError(f"{fn}: sel has {sel.shape[0]} rows, queries {queries.shape[0]}")
    for t, what in ((queries, "queries"), (list_vecs, "list_vecs"), (sel, "sel")):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {what} must be contiguous")
        if t.device != list_vecs.device:
            raise ValueError(f"{fn}: {what} on {t.device}, expected {list_vecs.device}")
    _check_device(fn, list_vecs)


def slab_dots(
    queries: torch.Tensor,  # [B, d] f32
    list_vecs: torch.Tensor,  # [Nb, L, d] f32 | bf16 member slabs
    sel: torch.Tensor,  # [B, W] int32 | int64 block ids, clamped to [0, Nb)
) -> torch.Tensor:
    """``dots[b, w, :] = list_vecs[sel[b, w]] @ queries[b]``, ``[B, W, L]`` f32.

    Stored bf16 values are widened to f32 exactly and multiplied by the f32
    query (the f32 query against the stored values). ``sel`` must already
    be clamped to ``[0, Nb)``: the kernel does not read an id outside it
    and writes NaN for it instead; repeated ids are fine.

    CUDA tensors launch the kernel of ``csrc/slab_dots.cu`` on the current
    stream and count under ``LAUNCHES['slab_dots']``. CPU tensors take
    :func:`slab_dots_reference`.
    """
    _check_slab_dots(queries, list_vecs, sel)
    if list_vecs.device.type == "cpu":
        return slab_dots_reference(queries, list_vecs, sel)
    b, w = sel.shape
    nb, length, d = list_vecs.shape
    out = torch.empty((b, w, length), dtype=torch.float32, device=list_vecs.device)
    if out.numel() == 0:
        return out
    if b >= 2**31 or w >= 2**31 or nb >= 2**31 or length * d >= 2**31:
        raise ValueError(f"slab_dots: B={b}, W={w}, Nb={nb}, L*d={length * d} exceed int32")
    idx = sel.to(torch.int32).contiguous()
    lib = _lib("slab_dots")
    with torch.cuda.device(list_vecs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, _SLAB_MODES[list_vecs.dtype])(
            queries.data_ptr(), list_vecs.data_ptr(), idx.data_ptr(),
            out.data_ptr(), b, w, length, d, nb, stream,
        )
    _check_launch("slab_dots", "slab_dots", rc)
    LAUNCHES["slab_dots"] += 1
    return out


# ---- K4: full-L2 per-block minima over interleaved blocks ----------------

# rows per tile of the interleaved layout (the TPU kernel's _BM_TILE)
BLOCKMIN_TILE = 2048


def blockmin_tile(n: int) -> int:
    """Rows per tile for an ``n``-row database: ``min(2048, n)``."""
    return min(BLOCKMIN_TILE, n)


def blockmin_reference(
    queries: torch.Tensor,
    database: torch.Tensor,
    w: int = 8,
    chunk_rows: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`blockmin` (same contract): per tile,
    ``||q||^2 + ||x||^2 - 2 q.x`` in f32, then the minimum over the ``w``
    interleaved members of each block (a ``[B, w, seg]`` view of the tile's
    columns), in whole tiles of at most ``chunk_rows`` rows at a time."""
    b, n = queries.shape[0], database.shape[0]
    tile = blockmin_tile(n)
    seg = tile // w
    chunk = max(tile, ((chunk_rows or _default_chunk_rows(b)) // tile) * tile)
    qn = torch.sum(queries * queries, dim=1)
    outs = []
    for c0 in range(0, n, chunk):
        x = database[c0 : c0 + chunk]
        xn = torch.sum(x * x, dim=1)
        dist = qn[:, None] + xn[None, :] - 2.0 * (queries @ x.T)
        outs.append(dist.reshape(b, -1, w, seg).amin(dim=2).reshape(b, -1))
    if not outs:
        return torch.empty((b, 0), dtype=torch.float32, device=database.device)
    return torch.cat(outs, dim=1)


def _check_blockmin(queries: torch.Tensor, database: torch.Tensor, w: int) -> None:
    fn = "blockmin"
    for t, what in ((queries, "queries"), (database, "database")):
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {what} must be float32, got {t.dtype}")
        _check_2d(fn, what, t, database)
    if queries.shape[1] != database.shape[1]:
        raise ValueError(
            f"{fn}: queries have d={queries.shape[1]}, database d={database.shape[1]}"
        )
    if w < 1 or w & (w - 1):
        raise ValueError(f"{fn}: w={w} must be a power of two")
    n = database.shape[0]
    if n < 1:
        raise ValueError(f"{fn}: need at least one database row")
    tile = blockmin_tile(n)
    if n % tile or tile % w:
        raise ValueError(
            f"{fn}: N={n} must be a multiple of the tile {tile} and the tile of "
            f"w={w} (pad with large-valued rows)"
        )
    _check_device(fn, database)


def blockmin(
    queries: torch.Tensor,  # [B, d] f32
    database: torch.Tensor,  # [N, d] f32, N % min(2048, N) == 0
    w: int = 8,
    chunk_rows: Optional[int] = None,
) -> torch.Tensor:
    """Per-block minima of the full squared L2 distance, ``[B, N/w]`` f32.

    Blocks are interleaved within each tile of ``TILE = min(2048, N)`` rows:
    block ``g`` holds rows ``(g // seg) * TILE + g % seg + i * seg`` for
    ``i < w``, ``seg = TILE / w``. ``||x||^2`` comes from the rows read;
    callers pad the database to a whole number of tiles with large-valued
    rows, which never win a minimum.

    CUDA tensors launch the kernel of ``csrc/blockmin.cu`` (wgmma, 3xTF32)
    on the current stream and count under ``LAUNCHES['blockmin']``. CPU tensors
    take :func:`blockmin_reference`, with ``chunk_rows`` bounding its block.
    """
    _check_blockmin(queries, database, w)
    if database.device.type == "cpu":
        return blockmin_reference(queries, database, w, chunk_rows)
    b, d = queries.shape
    n = database.shape[0]
    out = torch.empty((b, n // w), dtype=torch.float32, device=database.device)
    if b == 0:
        return out
    if b >= 2**31 or n >= 2**31:
        raise ValueError(f"blockmin: B={b}, N={n} exceed the launch grid")
    qn = torch.sum(queries * queries, dim=1)
    lib = _lib("blockmin")
    with torch.cuda.device(database.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vrt_blockmin_f32(
            queries.data_ptr(), database.data_ptr(), qn.data_ptr(),
            out.data_ptr(), b, n, d, w, blockmin_tile(n), stream,
        )
    _check_launch("blockmin", "blockmin", rc)
    LAUNCHES["blockmin"] += 1
    return out
