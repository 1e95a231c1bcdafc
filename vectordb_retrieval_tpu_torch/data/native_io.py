"""ctypes bindings for the native host-IO library (``native/vrt_io.cpp``).

Counterpart of ``vectordb_retrieval_tpu/data/native_io.py``, loading the
same shared library: multithreaded mmap parsing of .fvecs/.ivecs corpora
and a double-buffered prefetching stream reader. This is host IO, not a
device kernel. :func:`available` says whether the library is built;
``data/datasets.read_fvecs`` / ``read_ivecs`` then use it, and parse with
NumPy otherwise, as the JAX package does. :func:`stream_chunks` reads with
plain Python where the library is missing.

Build: ``make -C native`` (g++, no external dependencies).
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Tuple

import numpy as np

_LIB_PATHS = (
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native", "libvrt_io.so"),
)

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    for path in _LIB_PATHS:
        if not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        long_p = ctypes.POINTER(ctypes.c_long)
        lib.vrt_read_fvecs.restype = ctypes.c_int
        lib.vrt_read_fvecs.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long, long_p, long_p,
        ]
        lib.vrt_read_ivecs.restype = ctypes.c_int
        lib.vrt_read_ivecs.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_long, long_p, long_p,
        ]
        lib.vrt_vecs_shape.restype = ctypes.c_int
        lib.vrt_vecs_shape.argtypes = [ctypes.c_char_p, long_p, long_p]
        lib.vrt_stream_open.restype = ctypes.c_void_p
        lib.vrt_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long]
        lib.vrt_stream_next.restype = ctypes.c_long
        lib.vrt_stream_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.vrt_stream_close.restype = None
        lib.vrt_stream_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        break
    return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library not built (make -C native)")
    return lib


def vecs_shape(path: str) -> Tuple[int, int]:
    lib = _require()
    rows = ctypes.c_long()
    dim = ctypes.c_long()
    rc = lib.vrt_vecs_shape(path.encode(), ctypes.byref(rows), ctypes.byref(dim))
    if rc != 0:
        raise IOError(f"vrt_vecs_shape({path}) failed rc={rc}")
    return rows.value, dim.value


def _read_vecs(path: str, limit: Optional[int], dtype, ctype, fn_name: str) -> np.ndarray:
    lib = _require()
    rows, dim = vecs_shape(path)
    if limit is not None:
        rows = min(rows, limit)
    out = np.empty((rows, dim), dtype=dtype)
    got_rows = ctypes.c_long()
    got_dim = ctypes.c_long()
    rc = getattr(lib, fn_name)(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctype)), rows,
        ctypes.byref(got_rows), ctypes.byref(got_dim),
    )
    if rc != 0:
        raise IOError(f"{fn_name}({path}) failed rc={rc}")
    return out[: got_rows.value]


def read_fvecs(path: str, limit: Optional[int] = None) -> np.ndarray:
    """Native .fvecs parse; raises if the library is unavailable."""
    return _read_vecs(path, limit, np.float32, ctypes.c_float, "vrt_read_fvecs")


def read_ivecs(path: str, limit: Optional[int] = None) -> np.ndarray:
    """Native .ivecs parse; raises if the library is unavailable."""
    return _read_vecs(path, limit, np.int32, ctypes.c_int32, "vrt_read_ivecs")


def stream_chunks(
    path: str, chunk_bytes: int = 1 << 24, offset: int = 0
) -> Iterator[np.ndarray]:
    """Yield uint8 chunks of a binary file with background prefetch."""
    lib = _load()
    if lib is None:  # plain-Python fallback
        with open(path, "rb") as f:
            f.seek(offset)
            while True:
                data = f.read(chunk_bytes)
                if not data:
                    return
                yield np.frombuffer(data, dtype=np.uint8)
    handle = lib.vrt_stream_open(path.encode(), offset, chunk_bytes)
    if not handle:
        raise IOError(f"vrt_stream_open({path}) failed")
    buf = np.empty(chunk_bytes, dtype=np.uint8)
    try:
        while True:
            n = lib.vrt_stream_next(
                handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            )
            if n <= 0:
                return
            yield buf[:n].copy()
    finally:
        lib.vrt_stream_close(handle)
