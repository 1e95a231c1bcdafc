"""The port's dist_blockmin against the JAX Pallas kernel (f32 mode).

On CPU tensors the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in interpret mode, as its own tests run it. Tolerance: 2e-3
absolute on finite entries, the JAX test's own bound for its 3-pass bf16
HIGH split (the port computes in full f32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectordb_retrieval_tpu.ops.pallas_kernels import (
    dist_blockmin_pad_rows as jax_pad_rows,
    dist_blockmin_pallas,
)
from vectordb_retrieval_tpu_torch.ops import kernels

torch.set_num_threads(2)

# the three shapes of test_dist_blockmin_modes_match_oracle: (n, d, b, w)
ORACLE_SHAPES = [(4096, 128, 16, 8), (2000, 64, 8, 32), (8192, 96, 24, 16)]


def _inputs(rng, n, d, b, s, pen_kind):
    db = rng.standard_normal((n, d)).astype(np.float32)
    dbp = np.zeros((s, d), np.float32)
    dbp[:n] = db
    pen = np.full((s,), np.inf, np.float32)
    pen[:n] = (db * db).sum(1) if pen_kind == "l2" else 0.0
    q = rng.standard_normal((b, d)).astype(np.float32)
    return q, dbp, pen


@pytest.mark.parametrize("pen_kind", ["l2", "zero"])
@pytest.mark.parametrize("n,d,b,w", ORACLE_SHAPES)
def test_dist_blockmin_matches_pallas_f32(rng, n, d, b, w, pen_kind):
    s = jax_pad_rows(n, w)  # a multiple of 8*w is a multiple of w too
    q, dbp, pen = _inputs(rng, n, d, b, s, pen_kind)
    want = np.asarray(
        dist_blockmin_pallas(
            jnp.asarray(q), jnp.asarray(dbp),
            jnp.asarray(pen).reshape(s // w, w), w=w, interpret=True,
        )
    )
    got = kernels.dist_blockmin(
        torch.from_numpy(q), torch.from_numpy(dbp),
        torch.from_numpy(pen).reshape(s // w, w), w=w,
    ).numpy()
    assert got.shape == want.shape == (b, s // w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 2e-3


@pytest.mark.parametrize("w", [8, 16, 32])
def test_dist_blockmin_port_padding_and_chunks(rng, w):
    """The port pads only to S % w == 0; chunking the plain version's rows
    does not change its result, and blocks with only dead slots are +inf."""
    n, d, b = 1003, 24, 5
    s = kernels.dist_blockmin_pad_rows(n, w)
    assert s % w == 0 and n <= s < n + w
    q, dbp, pen = _inputs(rng, n, d, b, s, "l2")
    pen[:w] = np.inf  # first block entirely dead
    args = (torch.from_numpy(q), torch.from_numpy(dbp),
            torch.from_numpy(pen).reshape(s // w, w))
    full = kernels.dist_blockmin(*args, w=w).numpy()
    chunked = kernels.dist_blockmin(*args, w=w, chunk_rows=3 * w).numpy()
    np.testing.assert_allclose(chunked, full, rtol=1e-6, atol=1e-5)
    ref = (pen[None, :] - 2.0 * (q @ dbp.T)).reshape(b, s // w, w).min(-1)
    np.testing.assert_array_equal(np.isinf(full), np.isinf(ref))
    assert np.isinf(full[:, 0]).all() and np.isfinite(full[:, 1:]).all()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(full[fin], ref[fin], rtol=1e-5, atol=1e-4)


def test_dist_blockmin_launch_count_untouched_on_cpu(rng):
    before = dict(kernels.LAUNCHES)
    q, dbp, pen = _inputs(rng, 64, 8, 2, 64, "l2")
    kernels.dist_blockmin(
        torch.from_numpy(q), torch.from_numpy(dbp),
        torch.from_numpy(pen).reshape(8, 8), w=8,
    )
    assert kernels.LAUNCHES == before


def _bad_call(kind):
    q = torch.zeros((4, 16))
    x = torch.zeros((64, 16))
    pen = torch.zeros((8, 8))
    w = 8
    if kind == "bf16":
        x = x.to(torch.bfloat16)
    elif kind == "u8":
        x = x.to(torch.uint8)
    elif kind == "f64":
        q, x, pen = q.double(), x.double(), pen.double()
    elif kind == "ragged_s":
        x = torch.zeros((60, 16))
        pen = torch.zeros((60 // 8, 8))
    elif kind == "pen_shape":
        pen = torch.zeros((64,)).reshape(4, 16)
    elif kind == "pen_1d":
        pen = torch.zeros((64,))
    elif kind == "dim":
        q = torch.zeros((4, 12))
    elif kind == "noncontig":
        x = torch.zeros((16, 64)).T
    elif kind == "w":  # not a power of two
        w, x, pen = 12, torch.zeros((60, 16)), torch.zeros((5, 12))
    return q, x, pen, w


@pytest.mark.parametrize(
    "kind,exc",
    [
        ("bf16", NotImplementedError),
        ("u8", NotImplementedError),
        ("f64", TypeError),
        ("ragged_s", ValueError),
        ("pen_shape", ValueError),
        ("pen_1d", ValueError),
        ("dim", ValueError),
        ("noncontig", ValueError),
        ("w", ValueError),
    ],
)
def test_dist_blockmin_wrapper_rejects(kind, exc):
    q, x, pen, w = _bad_call(kind)
    with pytest.raises(exc):
        kernels.dist_blockmin(q, x, pen, w=w)


def test_kernel_source_and_build_key():
    """Every kernel's source ships in csrc/; its build directory is keyed
    by the source and the compiler flags."""
    import os

    for name in kernels.KERNEL_SOURCES:
        assert os.path.exists(os.path.join(kernels.CSRC_DIR, f"{name}.cu"))
        path = kernels._lib_path(name)
        assert path.startswith(kernels.BUILD_DIR)
        assert path.endswith(f"lib{name}.so")
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
