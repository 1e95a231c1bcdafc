"""Hand-written CUDA kernels of the port, their plain versions and wrappers.

Kernels (each replaces one TPU kernel of
``vectordb_retrieval_tpu/ops/pallas_kernels.py``, but K5, whose TPU kernel
lives in a tuning probe, and K6 and the IVF rescore, which replace plain
``jnp`` ops):
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
    ``csrc/assign.cu``, on the tensor cores by 3xTF32 (the ASSIGN mode of
    K1's main loop).
  * :func:`slab_dots` — dot products of each query with the member slabs of
    the blocks its graph beam popped (the block beam's wave probe). Replaces
    ``slab_dots_manual`` and ``slab_dots_pallas``, which share one contract.
    CUDA C++ source: ``csrc/slab_dots.cu``: the pairs grouped by popped slab
    on the card (:func:`slab_work_items` is that grouping's plain version),
    each slab read once and multiplied by its queries with ``wgmma``.
  * :func:`blockmin` — full-L2 per-block minima over interleaved blocks of
    2048-row tiles (the first blockmin exact search's fused stage 1; no
    search path calls it, :func:`dist_blockmin` superseded it). Replaces
    ``blockmin_pallas``. CUDA C++ source: ``csrc/blockmin.cu``, on the
    tensor cores by 3xTF32 (the main loop of K1's f32 mode).
  * :func:`matmul_floor` — K1 f32 without its epilogue: the product of each
    ``w``-block's first row with every query, ``[S/w, B]``. Replaces the
    tuning probe's ``matmul_floor`` (``scripts/exp_dbm_tune.py``), which
    times K1's main loop alone. CUDA C++ source: ``csrc/matmul_floor.cu``
    (K1 f32's 3xTF32 products of every row in Hopper's own idiom: TMA into
    an ``mbarrier`` ring fed by a producer warp, the payload as ``wgmma``'s
    A operand from registers, the queries split once a call), so its time
    is the card's floor for K1 f32's main loop.
  * :func:`block_rescore` — the exact rescore of the blocks exact search's
    stage 2 selected: each selected ``w``-row block's elementwise f32
    distances to its query, with the global row ids, padding rows masked.
    Replaces no Pallas kernel: the JAX package does this step as plain
    ``jnp`` ops (``vectordb_retrieval_tpu/ops/distances.py``, stage 3 of
    ``_exact_search_blockmin``). CUDA C++ source: ``csrc/block_rescore.cu``
    (one warp a (query, block) pair, 16-byte loads, a butterfly over the
    rows' partial sums; on the CUDA cores: the step is bound by the bytes
    of the selected blocks).
  * :func:`ivf_block_rescore` — the same step for IVF over bf16 rows
    (IVF-Flat's bf16 lists, IVF-PQ's resident reconstructions): each
    selected block's rows read straight from the bucketed list payload,
    widened exactly to f32 and rescored elementwise, with the slots' row
    ids; dead slots and never-probed pairs masked. Replaces no
    Pallas kernel: the JAX package does this step as plain ``jnp`` ops
    (``vectordb_retrieval_tpu/ops/ivf.py``, stage 3 of
    ``_ivf_probed_blockmin`` and ``_ivf_blockmin``). CUDA C++ source: its
    own kernel beside K6's in ``csrc/block_rescore.cu`` (K6's design, with
    2 to 8 bf16 rows a warp load).

Each wrapper routes by the device of its tensors: a CUDA tensor goes to the
kernel (or the wrapper raises), a CPU tensor goes to the plain PyTorch
version beside it. Nothing falls back from one to the other.

Kernels are compiled from ``csrc/`` (K1, K3 and K4 run the main loop of
the tensor-core kernel ``blockmin_tc.cuh``, K2 its loaders, all on the
helpers of ``wgmma.cuh``; K5 runs on those of ``tma.cuh``; K6 and the
IVF rescore stand alone, in one source) with ``nvcc``
for ``sm_90a`` at first use, into ``_build/<hash of source, every header
and flags>/``, and loaded with ``ctypes`` through a plain C interface.
Every launch adds one to ``LAUNCHES[name]`` (one name per kernel mode);
nothing else touches the counts.

Counted work: while a :func:`count_work` scope is open, every wrapper call
adds the operations and bytes of the function it computes to the scope,
before it branches to the plain version or the kernel, so the CPU and the
card count the same work for the same inputs. Operations are the
products' multiply-adds (two each) plus one per add and per minimum of the
epilogue for every candidate; bytes are each input read once and each
output written once (the queries at the width the kernel reads them). What
a wrapper does inside itself (the plain version, casts, norms, splits) is
not counted again: :func:`inside_wrapper` is true while it runs.
``utils/profiling.cost_estimate`` sums these counts with the aten ops that
run outside the wrappers.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

KERNEL_SOURCES = ("dist_blockmin_tc", "assign", "slab_dots", "blockmin", "matmul_floor",
                  "block_rescore")
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
KERNELS = tuple(name for name, _, _ in _DBM_MODES.values()) + (
    "assign", "slab_dots", "blockmin", "matmul_floor", "block_rescore", "ivf_block_rescore")

# launches per kernel mode, counted by the wrappers where they launch
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# compiler output (registers, spills, shared memory) of the builds this
# process made; empty for libraries found already built
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}

# the work counts open now (count_work), and the wrapper calls running now
_WORK: List[Dict[str, float]] = []
_DEPTH = [0]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def count_work() -> Iterator[Dict[str, float]]:
    """Open a count of the wrappers' work: ``{"flops", "bytes", "calls"}``,
    summed over every wrapper call made until the scope closes (scopes
    nest; each counts every call made while it is open). Nothing is counted
    while no scope is open, so the timed paths pay nothing for it; under a
    scope :func:`slab_dots` reads its distinct slabs, which waits for the
    device."""
    work = {"flops": 0.0, "bytes": 0.0, "calls": 0}
    _WORK.append(work)
    try:
        yield work
    finally:
        _WORK.remove(work)


def inside_wrapper() -> bool:
    """True while a wrapper call runs (its own ops are its counted work)."""
    return _DEPTH[0] > 0


@contextlib.contextmanager
def _counted(work_of: Callable[[], Tuple[float, float]]) -> Iterator[None]:
    """A wrapper call: ``work_of()`` gives its ``(operations, bytes)``,
    computed only while a count is open."""
    _DEPTH[0] += 1
    try:
        if _WORK:
            flops, nbytes = work_of()
            for work in _WORK:
                work["flops"] += flops
                work["bytes"] += nbytes
                work["calls"] += 1
        yield
    finally:
        _DEPTH[0] -= 1


def dist_blockmin_work(b: int, s: int, d: int, w: int, payload_dtype: torch.dtype,
                       pens: int = 1) -> Tuple[float, float]:
    """``(operations, bytes)`` of one :func:`dist_blockmin` call (``pens =
    2``: :func:`dist_blockmin_pair`): ``2 B S d`` for the product plus a pen
    add and a minimum for each pen and candidate; the queries (f32 in the
    f32 mode, bf16 otherwise), the payload, each pen and each ``[B, S/w]``
    output once."""
    q_bytes = 4 if payload_dtype == torch.float32 else 2
    flops = 2.0 * b * s * d + 2.0 * pens * b * s
    nbytes = (q_bytes * b * d + payload_dtype.itemsize * s * d
              + pens * (4.0 * s + 4.0 * b * (s // w)))
    return flops, float(nbytes)


def assign_work(n: int, k: int, d: int) -> Tuple[float, float]:
    """``(operations, bytes)`` of one :func:`assign` call: ``2 N K d`` for
    the product plus the two norm adds and the minimum of every pair; the
    points and centroids read once, int64 ids and f32 minima written."""
    return 2.0 * n * k * d + 3.0 * n * k, 4.0 * (n * d + k * d) + 12.0 * n


def blockmin_work(b: int, n: int, d: int, w: int) -> Tuple[float, float]:
    """``(operations, bytes)`` of one :func:`blockmin` call: ``2 B N d``
    for the product plus the two norm adds and the minimum of every pair;
    queries and database read once, the ``[B, N/w]`` minima written."""
    return 2.0 * b * n * d + 3.0 * b * n, 4.0 * (b * d + n * d + b * (n // w))


def slab_dots_work(b: int, w: int, length: int, d: int, slab_bytes: int,
                   sel_bytes: int, distinct_slabs: int) -> Tuple[float, float]:
    """``(operations, bytes)`` of one :func:`slab_dots` call: ``2 B W L d``
    for the products; the slabs the ids select read once each (ids outside
    ``[0, Nb)`` read none), the queries and ids read, the ``[B, W, L]`` f32
    dots written."""
    nbytes = (distinct_slabs * length * d * slab_bytes + 4.0 * b * d
              + sel_bytes * b * w + 4.0 * b * w * length)
    return 2.0 * b * w * length * d, float(nbytes)


def matmul_floor_work(b: int, s: int, d: int, w: int) -> Tuple[float, float]:
    """``(operations, bytes)`` of the function one :func:`matmul_floor`
    call computes: ``2 B (S/w) d`` for the dot products of each
    ``w``-block's first row with every query; the queries and those ``S/w``
    rows read once, the ``[S/w, B]`` output written once. The kernel itself
    multiplies every row at K1 f32's shapes (``6 B S d`` TF32 operations):
    that is the loop it is the floor of, not work the function needs."""
    g = s // w
    return 2.0 * b * g * d, 4.0 * (b * d + g * d + g * b)


def block_rescore_work(b: int, nb: int, w: int, d: int, distinct_blocks: int,
                       metric: str) -> Tuple[float, float]:
    """``(operations, bytes)`` of one :func:`block_rescore` call: for each
    of the ``B nb w d`` elements, a difference, a product and an add (l2)
    or a product and an add (ip); the distinct selected blocks read once
    each, the queries and the int64 ids read, the ``[B, nb w]`` f32 scores and int64 row ids written."""
    per_element = 3.0 if metric == "l2" else 2.0
    nbytes = (4.0 * distinct_blocks * w * d + 4.0 * b * d + 8.0 * b * nb
              + 12.0 * b * nb * w)
    return per_element * b * nb * w * d, nbytes


def ivf_block_rescore_work(b: int, nb: int, w: int, d: int, probed_pairs: int,
                           distinct_blocks: int, metric: str) -> Tuple[float, float]:
    """``(operations, bytes)`` of one :func:`ivf_block_rescore` call: for
    each of the ``w d`` elements of each probed pair's block, a difference,
    a product and an add (l2) or a product and an add (ip); the distinct
    blocks of the probed pairs read once each (bf16 rows and their int32
    slot ids), the queries, the int64 block ids and f32 block minima read,
    the ``[B, nb w]`` f32 scores and int64 row ids written."""
    per_element = 3.0 if metric == "l2" else 2.0
    nbytes = (distinct_blocks * w * (2.0 * d + 4.0) + 4.0 * b * d + 12.0 * b * nb
              + 12.0 * b * nb * w)
    return per_element * probed_pairs * w * d, nbytes


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
        sigs.update({fn: [vp] * 6 + [ci] * 5 + [vp] for fn in _SLAB_MODES.values()})
        lib.vrt_slab_dots_scratch_words.argtypes = [ci, ci]
        lib.vrt_slab_dots_scratch_words.restype = ctypes.c_longlong
    elif name == "blockmin":
        sigs["vrt_blockmin_f32"] = [vp] * 4 + [ci] * 5 + [vp]
    elif name == "matmul_floor":
        sigs["vrt_matmul_floor_f32"] = [vp] * 4 + [ci] * 4 + [vp]
        lib.vrt_matmul_floor_scratch_floats.argtypes = [ci, ci]
        lib.vrt_matmul_floor_scratch_floats.restype = ctypes.c_longlong
    elif name == "block_rescore":
        sigs["vrt_block_rescore_f32"] = [vp] * 5 + [ci] * 7 + [vp]
        sigs["vrt_ivf_block_rescore_bf16"] = [vp] * 7 + [ci] * 6 + [vp]
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
    The kernels split in shared memory (K5: the payload in registers, the
    queries in a launch of their own); no search path calls this."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        # on the magnitude bits: + half of the dropped field, carry, clear
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    big = rna(x)
    return big, rna(x - big)


def split_bf16x3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(hi, mid, lo)`` bf16 pieces of an f32 tensor as K2's prep kernel
    splits each query value (``csrc/slab_dots.cu``): ``hi = bf16(x)``,
    ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)``, each rounded to
    nearest even, each difference exact in f32. ``hi + mid + lo`` is ``x``
    to 2^-24 relative; a piece times a bf16 value is exact in f32, so three
    bf16 products give the f32 query against bf16 slabs. The kernel splits
    on the card; no search path calls this."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


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
    (b, d), s = queries.shape, payload.shape[0]
    with _counted(lambda: dist_blockmin_work(b, s, d, w, payload.dtype)):
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
    (b, d), s = queries.shape, payload.shape[0]
    with _counted(lambda: dist_blockmin_work(b, s, d, w, payload.dtype, pens=2)):
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

    CUDA tensors launch the kernel of ``csrc/assign.cu`` (a 3xTF32
    ``wgmma`` GEMM with an argmin/min epilogue; the [N, K] matrix is never
    written) and count under ``LAUNCHES['assign']``. CPU tensors take
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
    (n, d), k = points.shape, centroids.shape[0]
    with _counted(lambda: assign_work(n, k, d)):
        if points.device.type == "cpu":
            return assign_reference(points, centroids, chunk_rows)
        return _launch_assign(points, centroids)


def _launch_assign(points: torch.Tensor, centroids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n, d = points.shape
    k = centroids.shape[0]
    ids = torch.empty((n,), dtype=torch.int64, device=points.device)
    mins = torch.empty((n,), dtype=torch.float32, device=points.device)
    if n == 0:
        return ids, mins
    if n >= 2**31 or k >= 2**31:
        raise ValueError(f"assign: N={n}, K={k} exceed the launch grid")
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


# pairs a K2 work item holds (NQ of csrc/slab_dots.cu: two warpgroups of 64)
SLAB_ITEM_PAIRS = 128


def slab_max_items(pairs: int, nb: int) -> int:
    """The static bound on K2's work items, ``ceil(pairs / 128) + Nb``.
    Each of the ``Nb + 1`` buckets (the out-of-range ids' included) makes
    its whole items and at most one partial item; the whole items plus one
    partial item fit in ``ceil(pairs / 128)``, so the other partial items
    add at most ``Nb``. Reached when every bucket holds 1 mod 128 pairs."""
    return -(-pairs // SLAB_ITEM_PAIRS) + nb


def slab_work_items(sel: torch.Tensor, nb: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2's grouping (the prep, scan and scatter kernels of
    ``csrc/slab_dots.cu``): the ``B W`` pairs ``p = b W + w`` bucketed by
    ``sel`` (ids outside ``[0, Nb)`` in bucket ``Nb``), each bucket cut into
    work items of at most 128 pairs. Returns ``(order, items, n_items)``:
    ``order [B W]`` the pairs in bucket order (stable here; the kernels'
    order inside a bucket varies, and no output depends on it), ``items
    [slab_max_items, 3]`` rows ``(slab, first place in order, pairs)`` with
    unused rows ``(Nb + 1, 0, 0)``, and the item count as a 0-dim tensor.
    Torch ops only, none of which waits for the device."""
    flat = sel.reshape(-1).long()
    key = torch.where((flat >= 0) & (flat < nb), flat, nb)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=nb + 1)
    starts = torch.cumsum(counts, 0) - counts
    per = (counts + SLAB_ITEM_PAIRS - 1) // SLAB_ITEM_PAIRS
    ends = torch.cumsum(per, 0)
    idx = torch.arange(slab_max_items(flat.numel(), nb), device=sel.device)
    bucket = torch.searchsorted(ends, idx, right=True)
    used = bucket <= nb
    g = bucket.clamp(max=nb)
    j = idx - (ends[g] - per[g])
    first = torch.where(used, starts[g] + j * SLAB_ITEM_PAIRS, 0)
    count = torch.where(used, (counts[g] - j * SLAB_ITEM_PAIRS).clamp(max=SLAB_ITEM_PAIRS), 0)
    return order, torch.stack([bucket, first, count], dim=1), ends[-1]


def slab_dots(
    queries: torch.Tensor,  # [B, d] f32
    list_vecs: torch.Tensor,  # [Nb, L, d] f32 | bf16 member slabs
    sel: torch.Tensor,  # [B, W] int32 | int64 block ids, clamped to [0, Nb)
) -> torch.Tensor:
    """``dots[b, w, :] = list_vecs[sel[b, w]] @ queries[b]``, ``[B, W, L]`` f32.

    Stored values are multiplied by the f32 query (the f32 query against
    the stored values). ``sel`` must already be clamped to ``[0, Nb)``: the
    kernel does not read an id outside it and writes NaN for it instead;
    repeated ids are fine.

    CUDA tensors launch the kernels of ``csrc/slab_dots.cu`` on the current
    stream, with no host synchronisation: the pairs grouped by popped slab
    (:func:`slab_work_items`), then each slab read once and multiplied by
    the queries that popped it on the tensor cores (bf16 slabs against a
    three-piece bf16 split of the query, f32 slabs by 3xTF32); one count
    under ``LAUNCHES['slab_dots']`` a call. CPU tensors take
    :func:`slab_dots_reference`.
    """
    _check_slab_dots(queries, list_vecs, sel)
    b, w = sel.shape
    nb, length, d = list_vecs.shape

    def work():  # reads the slabs this call's ids select: waits for the device
        distinct = int(torch.unique(sel[(sel >= 0) & (sel < nb)]).numel())
        return slab_dots_work(b, w, length, d, list_vecs.element_size(),
                              sel.element_size(), distinct)

    with _counted(work):
        if list_vecs.device.type == "cpu":
            return slab_dots_reference(queries, list_vecs, sel)
        return _launch_slab_dots(queries, list_vecs, sel)


def _launch_slab_dots(queries: torch.Tensor, list_vecs: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    b, w = sel.shape
    nb, length, d = list_vecs.shape
    out = torch.empty((b, w, length), dtype=torch.float32, device=list_vecs.device)
    if out.numel() == 0:
        return out
    if b * w >= 2**31 or nb >= 2**31 - 1 or length * d >= 2**31 or b * d >= 2**31:
        raise ValueError(f"slab_dots: B={b}, W={w}, Nb={nb}, L*d={length * d} exceed int32")
    idx = sel.to(torch.int32).contiguous()
    lib = _lib("slab_dots")
    dev = list_vecs.device
    scratch = torch.empty((lib.vrt_slab_dots_scratch_words(b * w, nb),), dtype=torch.int32, device=dev)
    n_pieces = 2 if list_vecs.dtype == torch.float32 else 3
    pieces = torch.empty((n_pieces, b, d), dtype=list_vecs.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, _SLAB_MODES[list_vecs.dtype])(
            queries.data_ptr(), list_vecs.data_ptr(), idx.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), pieces.data_ptr(), b, w, length, d, nb, stream,
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
    (b, d), n = queries.shape, database.shape[0]
    with _counted(lambda: blockmin_work(b, n, d, w)):
        if database.device.type == "cpu":
            return blockmin_reference(queries, database, w, chunk_rows)
        return _launch_blockmin(queries, database, w)


def _launch_blockmin(queries: torch.Tensor, database: torch.Tensor, w: int) -> torch.Tensor:
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


# ---- K5: K1 f32's matmul floor ---------------------------------------------


def matmul_floor_reference(queries: torch.Tensor, payload: torch.Tensor, w: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`matmul_floor` (same contract):
    ``payload[::w] @ queries.T``, one f32 product (full f32 where TF32 is
    off, PyTorch's default for matrix products)."""
    return payload[::w] @ queries.T


def _check_matmul_floor(queries: torch.Tensor, payload: torch.Tensor, w: int) -> None:
    fn = "matmul_floor"
    for t, what in ((queries, "queries"), (payload, "payload")):
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {what} must be float32, got {t.dtype}")
        _check_2d(fn, what, t, payload)
    if queries.shape[1] != payload.shape[1]:
        raise ValueError(
            f"{fn}: queries have d={queries.shape[1]}, payload d={payload.shape[1]}"
        )
    if w < 1 or w > 128 or w & (w - 1):
        raise ValueError(f"{fn}: w={w} must be a power of two <= 128")
    if payload.shape[0] % w:
        raise ValueError(f"{fn}: S={payload.shape[0]} must be a multiple of w={w}")
    _check_device(fn, payload)


def matmul_floor(
    queries: torch.Tensor,  # [B, d] f32
    payload: torch.Tensor,  # [S, d] f32, S % w == 0
    w: int = 8,
) -> torch.Tensor:
    """``out[g, q] = <payload[g*w], queries[q]>``, ``[S/w, B]`` f32: K1
    f32 with its pen, block minimum and transpose taken out, as the TPU
    probe's floor returns it. Like the probe it multiplies every row, so
    it times the card's floor for K1 f32's main loop; no search path calls
    it.

    CUDA tensors launch ``csrc/matmul_floor.cu`` on the current stream (a
    split of the queries into tf32 pieces in scratch allocated here, then
    the 3xTF32 products of every row, see :func:`split_tf32`; TMA where the
    payload's base and rows are 16-byte aligned, masked loads otherwise)
    and count under ``LAUNCHES['matmul_floor']``. CPU tensors take
    :func:`matmul_floor_reference`.
    """
    _check_matmul_floor(queries, payload, w)
    (b, d), s = queries.shape, payload.shape[0]
    with _counted(lambda: matmul_floor_work(b, s, d, w)):
        if payload.device.type == "cpu":
            return matmul_floor_reference(queries, payload, w)
        return _launch_matmul_floor(queries, payload, w)


def _launch_matmul_floor(queries: torch.Tensor, payload: torch.Tensor, w: int) -> torch.Tensor:
    (b, d), s = queries.shape, payload.shape[0]
    out = torch.empty((s // w, b), dtype=torch.float32, device=payload.device)
    if b == 0 or s == 0:
        return out
    if b >= 2**31 or s >= 2**31:
        raise ValueError(f"matmul_floor: B={b}, S={s} exceed the launch grid")
    lib = _lib("matmul_floor")
    # the queries' tf32 pieces, split once a call
    scratch = torch.empty(lib.vrt_matmul_floor_scratch_floats(b, d), dtype=torch.float32,
                          device=payload.device)
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vrt_matmul_floor_f32(
            queries.data_ptr(), payload.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            b, s, d, w, stream,
        )
    _check_launch("matmul_floor", "matmul_floor", rc)
    LAUNCHES["matmul_floor"] += 1
    return out


# ---- K6: exact rescore of the selected blocks ------------------------------

BLOCK_RESCORE_METRICS = ("l2", "ip")


def block_rescore_reference(
    queries: torch.Tensor,
    payload: torch.Tensor,
    blk: torch.Tensor,
    n: int,
    w: int,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`block_rescore` (same contract): the
    selected blocks gathered whole into a fresh ``[B, nb, w, d]`` copy,
    updated in place (difference and square, or product), summed over
    ``d``; then the row ids and the padding rows' ``+inf`` / ``-1``."""
    b, nb = blk.shape
    dim = payload.shape[1]
    # whole w-row blocks: [B, nb, w, d], a fresh copy, updated in place
    bvecs = payload.reshape(-1, w, dim)[blk]
    if metric == "l2":
        diff = bvecs.sub_(queries[:, None, None, :])
        cd = torch.sum(diff.mul_(diff), dim=-1)
    else:  # ip/cosine: negated dot, elementwise sum
        cd = -torch.sum(bvecs.mul_(queries[:, None, None, :]), dim=-1)
    cand = (
        blk[:, :, None] * w + torch.arange(w, device=payload.device)
    ).reshape(b, nb * w)
    cand = torch.where(cand < n, cand, torch.full_like(cand, -1))
    cd = torch.where(
        cand.reshape(b, nb, w) >= 0, cd, torch.full_like(cd, float("inf"))
    ).reshape(b, nb * w)
    return cd, cand


def _check_block_rescore(queries: torch.Tensor, payload: torch.Tensor, blk: torch.Tensor,
                         n: int, w: int, metric: str) -> None:
    fn = "block_rescore"
    for t, what in ((queries, "queries"), (payload, "payload")):
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {what} must be float32, got {t.dtype}")
    if blk.dtype != torch.int64:
        raise TypeError(f"{fn}: blk must be int64, got {blk.dtype}")
    for t, what in ((queries, "queries"), (payload, "payload"), (blk, "blk")):
        _check_2d(fn, what, t, payload)
    if metric not in BLOCK_RESCORE_METRICS:
        raise ValueError(f"{fn}: metric {metric!r} must be one of {BLOCK_RESCORE_METRICS}")
    if w < 8 or w > 128 or w & (w - 1):
        raise ValueError(f"{fn}: w={w} must be a power of two in [8, 128]")
    s, d = payload.shape
    if queries.shape[1] != d:
        raise ValueError(f"{fn}: queries have d={queries.shape[1]}, payload d={d}")
    if blk.shape[0] != queries.shape[0]:
        raise ValueError(f"{fn}: blk has {blk.shape[0]} rows, queries {queries.shape[0]}")
    if s % w:
        raise ValueError(f"{fn}: S={s} must be a multiple of w={w} (dist_blockmin_pad_rows)")
    if not 0 <= n <= s:
        raise ValueError(f"{fn}: n={n} real rows must lie in [0, S={s}]")
    _check_device(fn, payload)


def block_rescore(
    queries: torch.Tensor,  # [B, d] f32
    payload: torch.Tensor,  # [S, d] f32, S % w == 0, rows >= n padding
    blk: torch.Tensor,  # [B, nb] int64 block ids in [0, S/w)
    n: int,
    w: int,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact scores of every row of each query's selected blocks:
    ``(cd [B, nb w] f32, cand [B, nb w] int64)``, where for block
    ``g = blk[b, i]`` and row ``j < w``, ``cand[b, i w + j] = g w + j`` and
    ``cd[b, i w + j]`` is ``sum((payload[g w + j] - queries[b])^2)`` (l2)
    or ``-sum(payload[g w + j] * queries[b])`` (ip; cosine on normalised
    rows), elementwise in f32, never a matrix product; rows ``>= n`` give
    ``+inf`` and ``-1``. ``w`` is a power of two in ``[8, 128]``.

    CUDA tensors launch the kernel of ``csrc/block_rescore.cu`` on the
    current stream (each selected block read once, only the outputs
    written) and count under ``LAUNCHES['block_rescore']``. CPU tensors
    take :func:`block_rescore_reference`. Every id of ``blk`` lies in
    ``[0, S/w)`` (stage 2 of exact search gives no other): on the CPU
    another raises ``IndexError``; on the card it traps the launch, which
    fails at the next synchronisation (checking it on the host would wait
    for the device).
    """
    _check_block_rescore(queries, payload, blk, n, w, metric)
    b, nb = blk.shape
    s, d = payload.shape

    def work():  # reads the blocks this call's ids select: waits for the device
        distinct = int(torch.unique(blk).numel())
        return block_rescore_work(b, nb, w, d, distinct, metric)

    with _counted(work):
        if payload.device.type == "cpu":
            if blk.numel() and (int(blk.min()) < 0 or int(blk.max()) >= s // w):
                raise IndexError(f"block_rescore: block ids must lie in [0, {s // w})")
            return block_rescore_reference(queries, payload, blk, n, w, metric)
        return _launch_block_rescore(queries, payload, blk, n, w, metric)


def _launch_block_rescore(queries: torch.Tensor, payload: torch.Tensor, blk: torch.Tensor,
                          n: int, w: int, metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    b, nb = blk.shape
    s, d = payload.shape
    dev = payload.device
    cd = torch.empty((b, nb * w), dtype=torch.float32, device=dev)
    cand = torch.empty((b, nb * w), dtype=torch.int64, device=dev)
    if cd.numel() == 0:
        return cd, cand
    if b >= 2**31 or nb >= 2**31 or s >= 2**31 or d >= 2**31:
        raise ValueError(f"block_rescore: B={b}, nb={nb}, S={s}, d={d} exceed int32")
    lib = _lib("block_rescore")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vrt_block_rescore_f32(
            queries.data_ptr(), payload.data_ptr(), blk.data_ptr(), cd.data_ptr(),
            cand.data_ptr(), b, nb, s, d, w, n, int(metric == "l2"), stream,
        )
    _check_launch("block_rescore", "block_rescore", rc)
    LAUNCHES["block_rescore"] += 1
    return cd, cand


# ---- IVF-Flat's stage 3 over bf16 lists --------------------------------------


def ivf_block_rescore_reference(
    queries: torch.Tensor,
    payload: torch.Tensor,
    slot_ids: torch.Tensor,
    blk: torch.Tensor,
    blk_vals: torch.Tensor,
    w: int,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ivf_block_rescore` (same contract),
    IVF's gathered stage-3 chain: the selected blocks gathered whole into
    a fresh ``[B, nb, w, d]`` bf16 copy, widened to a fresh f32 one,
    updated in place (difference and square, or product) and summed over
    ``d``; then the dead slots' and unprobed pairs' ``+inf`` / ``-1``."""
    b, nb = blk.shape
    dim = payload.shape[1]
    cand = slot_ids.reshape(-1, w)[blk].long()  # [B, nb, w]
    v32 = payload.reshape(-1, w, dim)[blk].float()  # [B, nb, w, d], exact
    if metric == "l2":
        v32.sub_(queries[:, None, None, :])
        cd = torch.sum(v32.mul_(v32), dim=-1)
    else:  # ip/cosine: negated dot, elementwise sum
        cd = -torch.sum(v32.mul_(queries[:, None, None, :]), dim=-1)
    live = torch.isfinite(blk_vals)[:, :, None] & (cand >= 0)
    cd = torch.where(live, cd, float("inf")).reshape(b, nb * w)
    return cd, torch.where(live, cand, -1).reshape(b, nb * w)


def _check_ivf_block_rescore(queries: torch.Tensor, payload: torch.Tensor,
                             slot_ids: torch.Tensor, blk: torch.Tensor, blk_vals: torch.Tensor,
                             w: int, metric: str) -> None:
    fn = "ivf_block_rescore"
    for t, what, dtype in ((queries, "queries", torch.float32),
                           (payload, "payload", torch.bfloat16),
                           (slot_ids, "slot_ids", torch.int32),
                           (blk, "blk", torch.int64),
                           (blk_vals, "blk_vals", torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {what} must be {dtype}, got {t.dtype}")
    for t, what in ((queries, "queries"), (payload, "payload"), (blk, "blk"),
                    (blk_vals, "blk_vals")):
        _check_2d(fn, what, t, payload)
    if slot_ids.dim() != 1 or not slot_ids.is_contiguous() or slot_ids.device != payload.device:
        raise ValueError(f"{fn}: slot_ids must be 1-D, contiguous and on {payload.device}")
    if metric not in BLOCK_RESCORE_METRICS:
        raise ValueError(f"{fn}: metric {metric!r} must be one of {BLOCK_RESCORE_METRICS}")
    if w < 8 or w > 128 or w & (w - 1):
        raise ValueError(f"{fn}: w={w} must be a power of two in [8, 128]")
    s, d = payload.shape
    if queries.shape[1] != d:
        raise ValueError(f"{fn}: queries have d={queries.shape[1]}, payload d={d}")
    if blk.shape[0] != queries.shape[0] or blk_vals.shape != blk.shape:
        raise ValueError(f"{fn}: blk {tuple(blk.shape)} and blk_vals "
                         f"{tuple(blk_vals.shape)} must be [B={queries.shape[0]}, nb]")
    if s % w:
        raise ValueError(f"{fn}: S={s} must be a multiple of w={w}")
    if slot_ids.shape[0] != s:
        raise ValueError(f"{fn}: {slot_ids.shape[0]} slot ids for S={s} slots")
    _check_device(fn, payload)


def ivf_block_rescore(
    queries: torch.Tensor,  # [B, d] f32
    payload: torch.Tensor,  # [S, d] bf16 bucketed lists, S % w == 0
    slot_ids: torch.Tensor,  # [S] int32 row ids, -1 = dead slot
    blk: torch.Tensor,  # [B, nb] int64 block ids in [0, S/w)
    blk_vals: torch.Tensor,  # [B, nb] f32 block minima, non-finite = unprobed
    w: int,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact scores of every slot of each query's selected blocks of bf16
    IVF lists: ``(cd [B, nb w] f32, cand [B, nb w] int64)``, where for
    block ``g = blk[b, i]`` and row ``j < w``, ``cand[b, i w + j] =
    slot_ids[g w + j]`` and, with ``x = payload[g w + j]`` widened exactly
    to f32, ``cd[b, i w + j]`` is ``sum((x - queries[b])^2)`` (l2) or
    ``-sum(x * queries[b])`` (ip; cosine on normalised rows), elementwise
    in f32, never a matrix product. Dead slots and pairs whose
    ``blk_vals`` is not finite (never probed) give ``+inf`` and ``-1``.
    ``w`` is a power of two in ``[8, 128]``.

    CUDA tensors launch the kernel of ``csrc/block_rescore.cu`` on the
    current stream (each pair's block read once, an unprobed pair's not at
    all; only the outputs written) and count under
    ``LAUNCHES['ivf_block_rescore']``. CPU tensors take
    :func:`ivf_block_rescore_reference`. Every id of ``blk`` lies in
    ``[0, S/w)`` (IVF's stage 2 gives no other): on the CPU another raises
    ``IndexError``; on the card it traps the launch.
    """
    _check_ivf_block_rescore(queries, payload, slot_ids, blk, blk_vals, w, metric)
    b, nb = blk.shape
    s, d = payload.shape

    def work():  # reads the blocks this call's probed pairs select: waits for the device
        probed = torch.isfinite(blk_vals)
        distinct = int(torch.unique(blk[probed]).numel())
        return ivf_block_rescore_work(b, nb, w, d, int(probed.sum()), distinct, metric)

    with _counted(work):
        if payload.device.type == "cpu":
            if blk.numel() and (int(blk.min()) < 0 or int(blk.max()) >= s // w):
                raise IndexError(f"ivf_block_rescore: block ids must lie in [0, {s // w})")
            return ivf_block_rescore_reference(queries, payload, slot_ids, blk, blk_vals, w,
                                               metric)
        return _launch_ivf_block_rescore(queries, payload, slot_ids, blk, blk_vals, w, metric)


def _launch_ivf_block_rescore(queries: torch.Tensor, payload: torch.Tensor,
                              slot_ids: torch.Tensor, blk: torch.Tensor, blk_vals: torch.Tensor,
                              w: int, metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    b, nb = blk.shape
    s, d = payload.shape
    dev = payload.device
    cd = torch.empty((b, nb * w), dtype=torch.float32, device=dev)
    cand = torch.empty((b, nb * w), dtype=torch.int64, device=dev)
    if cd.numel() == 0:
        return cd, cand
    if b >= 2**31 or nb >= 2**31 or s >= 2**31 or d >= 2**31:
        raise ValueError(f"ivf_block_rescore: B={b}, nb={nb}, S={s}, d={d} exceed int32")
    lib = _lib("block_rescore")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vrt_ivf_block_rescore_bf16(
            queries.data_ptr(), payload.data_ptr(), slot_ids.data_ptr(), blk.data_ptr(),
            blk_vals.data_ptr(), cd.data_ptr(), cand.data_ptr(), b, nb, s, d, w,
            int(metric == "l2"), stream,
        )
    _check_launch("block_rescore", "ivf_block_rescore", rc)
    LAUNCHES["ivf_block_rescore"] += 1
    return cd, cand
