"""Big-corpus staging: raw on-disk row store, chunked host->device upload
and the fully streaming exact search.

Counterpart of ``vectordb_retrieval_tpu/data/storage.py``, with the same
on-disk format, so either package reads the other's stores:

  * ``BigStore`` is a raw C-order ``.bin`` beside a ``.json`` sidecar
    holding magic, shape and dtype. Writers append chunks, so generators
    never hold the whole corpus; ``read_rows`` reads by offset (no mmap
    page residency) and ``as_memmap`` gives a read-only ``np.memmap``;
  * host RSS stays O(chunk): every chunk reaches the card through two
    pinned staging buffers (:func:`iter_device_chunks`: a ``non_blocking``
    copy and an event each, so a chunk's disk read overlaps the previous
    chunk's copy); :func:`chunked_device_put` allocates the ``[N, d]``
    device tensor once and fills it so;
  * :func:`streamed_exact_search` holds one chunk at a time on the host
    and on the device, for corpora larger than either.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device

# Inputs above this many bytes take the chunked upload path even when they
# are plain ndarrays (bounds the transient host copy ascontiguousarray
# would otherwise make for dtype conversion).
CHUNKED_UPLOAD_BYTES = 1 << 30
DEFAULT_CHUNK_ROWS = 262_144


class BigStore:
    """Raw on-disk ``[N, d]`` row store with bounded-RSS chunk reads.

    ``offset`` is the byte offset of row 0 in the file (0 for a store; the
    data offset of an ``.npy`` or a memmap's rows, :func:`_file_rows`)."""

    MAGIC = "vrt_bigstore_v1"

    def __init__(self, path: str, shape, dtype, _writing: bool = False, offset: int = 0):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.offset = int(offset)
        self._writing = _writing
        self._fh = None

    # -- creation -------------------------------------------------------
    @classmethod
    def create(cls, path: str, dim: int, dtype=np.float32) -> "BigStore":
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        store = cls(path, (0, dim), dtype, _writing=True)
        store._fh = open(path + ".tmp", "wb")
        return store

    def append(self, rows: np.ndarray) -> None:
        if not self._writing:
            raise RuntimeError("store not opened for writing")
        rows = np.ascontiguousarray(rows, dtype=self.dtype)
        if rows.ndim != 2 or rows.shape[1] != self.shape[1]:
            raise ValueError(f"append expects [*, {self.shape[1]}], got {rows.shape}")
        rows.tofile(self._fh)
        self.shape = (self.shape[0] + rows.shape[0], self.shape[1])

    def close(self) -> None:
        if self._writing and self._fh is not None:
            self._fh.close()
            self._fh = None
            os.replace(self.path + ".tmp", self.path)
            with open(self.path + ".json", "w") as f:
                json.dump(
                    {"magic": self.MAGIC, "shape": list(self.shape),
                     "dtype": self.dtype.name},
                    f,
                )
            self._writing = False

    def __enter__(self) -> "BigStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reading --------------------------------------------------------
    @classmethod
    def open(cls, path: str) -> "BigStore":
        with open(path + ".json") as f:
            meta = json.load(f)
        if meta.get("magic") != cls.MAGIC:
            raise ValueError(f"{path}: not a BigStore")
        return cls(path, meta["shape"], meta["dtype"])

    @classmethod
    def exists(cls, path: str) -> bool:
        return os.path.exists(path) and os.path.exists(path + ".json")

    @property
    def nbytes(self) -> int:
        return self.shape[0] * self.shape[1] * self.dtype.itemsize

    def _span(self, start: int, stop: int) -> Tuple[int, int]:
        return max(0, start), max(max(0, start), min(stop, self.shape[0]))

    def read_rows(self, start: int, stop: int) -> np.ndarray:
        """Offset-based read (no mmap): RSS cost is just the returned copy."""
        d = self.shape[1]
        start, stop = self._span(start, stop)
        with open(self.path, "rb") as f:
            f.seek(self.offset + start * d * self.dtype.itemsize)
            out = np.fromfile(f, dtype=self.dtype, count=(stop - start) * d)
        return out.reshape(-1, d)

    def read_into(self, start: int, out: np.ndarray) -> int:
        """Read rows ``start:start + len(out)`` straight into ``out`` (a
        C-contiguous array of the store's dtype, e.g. a pinned staging
        buffer): no intermediate copy. Returns the rows read."""
        d = self.shape[1]
        start, stop = self._span(start, start + out.shape[0])
        want = (stop - start) * d * self.dtype.itemsize
        with open(self.path, "rb") as f:
            f.seek(self.offset + start * d * self.dtype.itemsize)
            got = f.readinto(memoryview(out.reshape(-1).view(np.uint8))[:want])
        if got != want:
            raise IOError(f"{self.path}: short read ({got} of {want} bytes)")
        return stop - start

    def iter_chunks(self, chunk_rows: int = DEFAULT_CHUNK_ROWS) -> Iterator[np.ndarray]:
        """Sequential chunks of ``chunk_rows`` (the last may be shorter),
        through the native prefetching stream reader where it is built
        (``data/native_io.stream_chunks``: disk reads overlap the
        consumer's device work), NumPy offset reads otherwise."""
        from vectordb_retrieval_tpu_torch.data import native_io

        n, d = self.shape
        row_bytes = d * self.dtype.itemsize
        if native_io.available() and n:
            pending = np.zeros((0, d), dtype=self.dtype)
            left = n  # the file may run on past the rows (an .npy prefix)
            for raw in native_io.stream_chunks(
                self.path, chunk_bytes=chunk_rows * row_bytes, offset=self.offset
            ):
                part = raw.view(self.dtype).reshape(-1, d)
                pending = part if pending.size == 0 else np.concatenate([pending, part])
                while pending.shape[0] >= min(chunk_rows, left) > 0:
                    take = min(chunk_rows, left)
                    yield pending[:take]
                    pending, left = pending[take:], left - take
                if left == 0:
                    return
            if pending.shape[0] and left:
                yield pending[:left]
            return
        for start in range(0, n, chunk_rows):
            yield self.read_rows(start, start + chunk_rows)

    def as_memmap(self) -> np.memmap:
        return np.memmap(self.path, dtype=self.dtype, mode="r", shape=self.shape)


CorpusLike = Union[np.ndarray, BigStore]


def _src_shape(src: CorpusLike) -> Tuple[int, ...]:
    return tuple(int(s) for s in src.shape)


def _drop_pages(src) -> None:
    """Drop the file pages a memmap read touched, so resident memory stays
    O(chunk) over a whole pass (linux; a no-op elsewhere)."""
    if isinstance(src, np.memmap):
        try:
            import mmap as _mmap

            src._mmap.madvise(_mmap.MADV_DONTNEED)
        except (AttributeError, ValueError, OSError):
            pass


def _file_rows(src) -> Optional[BigStore]:
    """The rows of a C-contiguous 2-D memmap (a shared or read-only
    mapping) as a :class:`BigStore` view of its file, or None. Rows are
    then read by offset and no page of the mapping is touched: on some
    hosts a fault in a file mapping makes far more of it resident than
    the pages read (on the card's host, ``bench/validate_bigcorpus``
    measured its ground-truth pass over a 2 GB memmap 2.5 GB above
    start-up when it copied chunks out of the mapping)."""
    if not (isinstance(src, np.memmap) and src.ndim == 2 and src.flags.c_contiguous
            and src.mode != "c" and src.filename and getattr(src, "_mmap", None) is not None):
        return None
    import mmap as _mmap

    try:
        mapped = np.frombuffer(src._mmap, dtype=np.uint8)
    except (TypeError, ValueError):  # a closed mapping
        return None
    first = src.offset - src.offset % _mmap.ALLOCATIONGRANULARITY  # file offset of the mapping
    offset = first + (src.ctypes.data - mapped.ctypes.data)
    return BigStore(os.fspath(src.filename), src.shape, src.dtype, offset=offset)


def _reader(src: CorpusLike) -> CorpusLike:
    """The source to read rows from: a store, a memmap's file, or the array."""
    return src if isinstance(src, BigStore) else (_file_rows(src) or src)


def _read_chunk(src: CorpusLike, start: int, stop: int) -> np.ndarray:
    src = _reader(src)
    if isinstance(src, BigStore):
        return np.ascontiguousarray(src.read_rows(start, stop), dtype=np.float32)
    # a copy, never a view of the mapping: the pages are dropped next
    out = np.array(src[start:stop], dtype=np.float32, order="C", copy=True)
    _drop_pages(src)
    return out


def iter_chunks_any(src: CorpusLike, chunk_rows: int) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield ``(start_row, chunk_f32)`` sequentially from any corpus
    source; stores and memmapped files stream through the native prefetch
    reader."""
    src = _reader(src)
    if isinstance(src, BigStore):
        start = 0
        for chunk in src.iter_chunks(chunk_rows):
            yield start, np.ascontiguousarray(chunk, dtype=np.float32)
            start += chunk.shape[0]
        return
    for start in range(0, int(src.shape[0]), chunk_rows):
        yield start, _read_chunk(src, start, start + chunk_rows)


def _fill_staging(src: CorpusLike, start: int, buf: np.ndarray) -> int:
    """Rows ``start:start + len(buf)`` of ``src`` into the f32 staging
    array ``buf``; returns the rows written."""
    if isinstance(src, BigStore) and src.dtype == np.float32:
        return src.read_into(start, buf)
    rows = min(buf.shape[0], int(src.shape[0]) - start)
    if isinstance(src, BigStore):
        buf[:rows] = src.read_rows(start, start + rows)
    else:
        np.copyto(buf[:rows], src[start:start + rows], casting="unsafe")
        _drop_pages(src)
    return rows


def iter_device_chunks(
    src: CorpusLike,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    device: DeviceLike = None,
) -> Iterator[Tuple[int, torch.Tensor]]:
    """Yield ``(start_row, f32 chunk on device)`` sequentially.

    On the card each chunk is read into one of two pinned f32 staging
    buffers and copied with ``non_blocking``; an event per buffer holds
    the next read into it until its copy is done, so a chunk's read
    overlaps the previous chunk's copy and host memory stays at the two
    buffers (a copy from pageable memory would serialise the stream).
    Each yielded chunk is a fresh device tensor the caller may keep.
    """
    dev = resolve_device(device)
    src = _reader(src)
    n, d = _src_shape(src)
    chunk_rows = max(1, min(int(chunk_rows), n))
    if dev.type != "cuda":
        for start, host in iter_chunks_any(src, chunk_rows):
            yield start, torch.from_numpy(host).to(dev)
        return
    staging = [torch.empty((chunk_rows, d), dtype=torch.float32, pin_memory=True)
               for _ in range(2)]
    done = [None, None]
    for i, start in enumerate(range(0, n, chunk_rows)):
        j = i % 2
        if done[j] is not None:
            done[j].synchronize()
        rows = _fill_staging(src, start, staging[j].numpy())
        chunk = torch.empty((rows, d), dtype=torch.float32, device=dev)
        chunk.copy_(staging[j][:rows], non_blocking=True)
        done[j] = torch.cuda.Event()
        done[j].record()
        yield start, chunk


def chunked_device_put(
    src: CorpusLike, chunk_rows: int = DEFAULT_CHUNK_ROWS, device: DeviceLike = None
) -> torch.Tensor:
    """Assemble a ``[N, d]`` f32 tensor on ``device`` from a host source in
    fixed-size chunks (:func:`iter_device_chunks`): the output is
    allocated once, host RSS peaks at the two staging buffers."""
    dev = resolve_device(device)
    n, d = _src_shape(src)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    for start, chunk in iter_device_chunks(src, chunk_rows, dev) if n else ():
        out[start:start + chunk.shape[0]] = chunk
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def is_out_of_core(vectors) -> bool:
    return isinstance(vectors, (BigStore, np.memmap))


def corpus_to_device(vectors, device: DeviceLike = None) -> torch.Tensor:
    """Builders' single entry point: host corpus (tensor, ndarray, memmap
    or BigStore) -> contiguous f32 tensor on ``device``, streaming in
    chunks when the input is out-of-core or large enough that a host-side
    contiguous copy would hurt."""
    dev = resolve_device(device)
    if isinstance(vectors, torch.Tensor):
        return vectors.to(device=dev, dtype=torch.float32).contiguous()
    n, d = _src_shape(vectors)
    if is_out_of_core(vectors) or n * d * 4 > CHUNKED_UPLOAD_BYTES:
        return chunked_device_put(vectors, device=dev)
    return torch.as_tensor(np.ascontiguousarray(vectors, dtype=np.float32), device=dev)


def _chunk_merge_step(best_d, best_i, q, chunk, base: int, metric: str, normalize: bool):
    """Fold one corpus chunk into the running candidates of
    :func:`streamed_exact_search`: score it, take its local top-``kk``
    (l2: rescored cancellation-free with ``rescore_l2``), then merge by
    ``top_k_smallest_by_id`` over global row ids, so equal distances keep
    the lower row, as the JAX package's ``jax.lax.top_k`` keeps them."""
    from vectordb_retrieval_tpu_torch.ops import distances as dops

    c = chunk.shape[0]
    kk = best_d.shape[1]
    if normalize:  # cosine corpora: unit-normalise rows in-step
        chunk = dops.normalize(chunk)
    dist = dops.pairwise_distances(q, chunk, metric)
    local = torch.arange(c, device=chunk.device).expand(q.shape[0], -1)
    cd, pos = dops.top_k_smallest_by_id(dist, local, min(kk, c))
    if metric == "l2":
        cd = dops.rescore_l2(q, chunk, pos)
    gids = torch.where(torch.isfinite(cd), pos + base, -1)
    # -1 (padding of the running set) sorts after every row id
    cat_i = torch.cat([best_i, gids], dim=1)
    key = torch.where(cat_i >= 0, cat_i, (1 << 32) - 1)
    nd, sel = dops.top_k_smallest_by_id(torch.cat([best_d, cd], dim=1), key, kk)
    return nd, torch.gather(cat_i, 1, sel)


def streamed_exact_search(
    queries: np.ndarray,
    src: CorpusLike,
    k: int,
    metric: str = "l2",
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    overfetch: int = 16,
    normalize: bool = False,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN over an out-of-core corpus: O(chunk) host AND device
    memory.

    A host loop uploads one chunk at a time and folds it into the running
    top-``k + overfetch``; each chunk is dropped before the next read. l2
    candidates are rescored with the cancellation-free difference form, so
    results match the resident exact paths to f32 rounding. The chunk is
    never padded (the JAX package pads the ragged tail to one compiled
    shape and masks the pad rows out again), so no pad row can come back.

    Returns ``(dists [B, k], ids [B, k])`` as NumPy arrays (ids int64).
    """
    from vectordb_retrieval_tpu_torch.ops import distances as dops

    dev = resolve_device(device)
    n, _ = _src_shape(src)
    if k > n:
        raise ValueError(f"k={k} exceeds database size {n}")
    q = torch.as_tensor(np.ascontiguousarray(queries, dtype=np.float32), device=dev)
    if normalize:
        q = dops.normalize(q)
    b = q.shape[0]
    kk = min(k + overfetch, n)
    best_d = torch.full((b, kk), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((b, kk), -1, dtype=torch.int64, device=dev)
    for start, chunk in iter_device_chunks(src, chunk_rows, dev):
        best_d, best_i = _chunk_merge_step(best_d, best_i, q, chunk, start, metric, normalize)
        del chunk
    return best_d[:, :k].cpu().numpy(), best_i[:, :k].cpu().numpy()


def peak_rss_bytes() -> Optional[int]:
    """Peak resident set size of this process since it started: the
    ``VmHWM`` line of ``/proc/self/status`` (linux), else ``ru_maxrss``.

    The JAX package reads ``ru_maxrss``, which linux carries over fork and
    exec: a fresh subprocess of a large parent reports at least the parent's
    resident size, so a bound measured in a child process would hold the
    parent's memory against it. ``VmHWM`` starts anew at exec."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except (ImportError, OSError):
        return None
