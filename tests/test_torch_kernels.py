"""The port's kernels against the JAX Pallas kernels: dist_blockmin in its
f32, bf16 and u8 modes, the k-means assignment, and the graph beam's slab
dot products.

On CPU tensors the port's wrappers run their plain PyTorch versions; the
JAX kernels run in interpret mode, as their own tests run them.
Tolerances: f32 mode 2e-3 absolute on finite entries, the JAX test's own
bound for its 3-pass bf16 HIGH split (the port computes in full f32);
bf16/u8 modes 1e-5 x max|ref| (both sides form exact bf16 products and
differ only in the order of their f32 sums); assignment: agreement
>= 0.999 and minimum distances within 1e-4 relative (the same expansion,
matrix products summed in another order); slab dot products: 1e-5 x
max|ref| on f32 slabs (f32 sums in another order) and 1e-4 x (|ref| + 1) on
bf16 slabs (the JAX kernel's split query is the f32 query to ~2^-16; its
own test allows 1e-3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectordb_retrieval_tpu.ops.kmeans import kmeans_assign as jax_kmeans_assign
from vectordb_retrieval_tpu.ops.pallas_kernels import (
    assign_pallas,
    dist_blockmin_pad_rows as jax_pad_rows,
    dist_blockmin_pallas,
    kmeans_assign_fused,
    slab_dots_manual,
    slab_dots_pallas,
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


def _mode_inputs(rng, n, d, b, w, mode, pen_kind):
    """Payload of a bf16/u8 mode with dead slots and one all-dead block."""
    s = jax_pad_rows(n, w)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if mode == "u8":
        x = rng.integers(0, 256, (s, d)).astype(np.uint8)
        xf = x.astype(np.float32)
    else:
        x = rng.standard_normal((s, d)).astype(np.float32)
        xf = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    pen = (xf * xf).sum(1) if pen_kind == "l2" else np.zeros((s,), np.float32)
    pen[n:] = np.inf
    pen[rng.random(s) < 0.1] = np.inf
    pen[2 * w : 3 * w] = np.inf  # block 2 entirely dead
    return q, x, pen.astype(np.float32).reshape(s // w, w)


@pytest.mark.parametrize("pen_kind", ["l2", "zero"])
@pytest.mark.parametrize("w", [8, 16, 32])
@pytest.mark.parametrize("mode", ["bf16", "u8"])
def test_dist_blockmin_modes_match_pallas(rng, mode, w, pen_kind):
    n, d, b = 1500, 48, 12
    q, x, pen = _mode_inputs(rng, n, d, b, w, mode, pen_kind)
    jx = jnp.asarray(x) if mode == "u8" else jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(
        dist_blockmin_pallas(
            jnp.asarray(q).astype(jnp.bfloat16), jx, jnp.asarray(pen), w=w,
            interpret=True,
        )
    )
    tx = torch.from_numpy(x)
    if mode == "bf16":
        tx = tx.to(torch.bfloat16)  # rounds to nearest even, as astype does
    got = kernels.dist_blockmin(
        torch.from_numpy(q), tx, torch.from_numpy(pen), w=w
    ).numpy()
    assert got.shape == want.shape == (b, pen.shape[0])
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[:, 2]).all()
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-5 * np.abs(want[fin]).max()


def test_dist_blockmin_bf16_queries_are_rounded_once(rng):
    """f32 queries and the same queries pre-rounded to bf16 score alike."""
    q, x, pen = _mode_inputs(rng, 256, 16, 3, 8, "u8", "l2")
    args = (torch.from_numpy(x), torch.from_numpy(pen))
    a = kernels.dist_blockmin(torch.from_numpy(q), *args, w=8)
    b = kernels.dist_blockmin(torch.from_numpy(q).to(torch.bfloat16), *args, w=8)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _assign_case(rng, n, k, d, dup):
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    if dup:
        c[7] = c[2]  # exact duplicates: argmin must keep the lower id
        c[k - 1] = c[0]
    return x, c


@pytest.mark.parametrize(
    "n,k,d,dup",
    [(1000, 64, 32, False), (1030, 16, 16, False), (777, 40, 24, True)],
)
def test_assign_matches_pallas_and_kmeans_assign(rng, n, k, d, dup):
    x, c = _assign_case(rng, n, k, d, dup)
    a_pl, d_pl = (np.asarray(v) for v in assign_pallas(
        jnp.asarray(x), jnp.asarray(c), interpret=True))
    a_xla = np.asarray(jax_kmeans_assign(jnp.asarray(x), jnp.asarray(c)))
    ids, mins = kernels.assign(torch.from_numpy(x), torch.from_numpy(c))
    ids, mins = ids.numpy(), mins.numpy()
    assert ids.shape == mins.shape == (n,) and ids.dtype == np.int64
    assert (ids == a_pl).mean() >= 0.999
    assert (ids == a_xla).mean() >= 0.999
    np.testing.assert_allclose(mins, d_pl, rtol=1e-4, atol=1e-4 * np.abs(d_pl).max())
    if dup:
        assert not np.isin(ids, [7, k - 1]).any()
        assert (ids == 2).any() and (ids == 0).any()


def test_assign_fused_wrapper_agrees_on_ragged_rows(rng):
    x, c = _assign_case(rng, 1030, 16, 16, False)
    a_j, _ = kmeans_assign_fused(jnp.asarray(x), jnp.asarray(c))
    ids, _ = kernels.assign(torch.from_numpy(x), torch.from_numpy(c), chunk_rows=100)
    assert (ids.numpy() == np.asarray(a_j)).mean() >= 0.999
    assert ids.min() >= 0 and ids.max() < 16


def test_assign_launch_count_untouched_on_cpu(rng):
    before = dict(kernels.LAUNCHES)
    x, c = _assign_case(rng, 50, 4, 8, False)
    kernels.assign(torch.from_numpy(x), torch.from_numpy(c))
    assert kernels.LAUNCHES == before
    assert set(kernels.LAUNCHES) == {
        "dist_blockmin", "dist_blockmin_bf16", "dist_blockmin_u8", "assign",
        "slab_dots"}


@pytest.mark.parametrize("kind", ["f64", "int_points", "dim", "noncontig", "empty"])
def test_assign_wrapper_rejects(kind):
    p, c = torch.zeros((10, 4)), torch.zeros((3, 4))
    exc = ValueError
    if kind == "f64":
        p, exc = p.double(), TypeError
    elif kind == "int_points":
        c, exc = c.long(), TypeError
    elif kind == "dim":
        c = torch.zeros((3, 5))
    elif kind == "noncontig":
        p = torch.zeros((4, 10)).T
    elif kind == "empty":
        c = torch.zeros((0, 4))
    with pytest.raises(exc):
        kernels.assign(p, c)


def _bad_call(kind):
    q = torch.zeros((4, 16))
    x = torch.zeros((64, 16))
    pen = torch.zeros((8, 8))
    w = 8
    if kind == "bf16":  # f16 queries are no mode's input
        q, x = q.half(), x.to(torch.bfloat16)
    elif kind == "u8":  # int queries are no mode's input
        q, x = q.long(), x.to(torch.uint8)
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
        ("bf16", TypeError),
        ("u8", TypeError),
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
    by the source, the shared header and the compiler flags."""
    import os

    for name in kernels.KERNEL_SOURCES:
        src = os.path.join(kernels.CSRC_DIR, f"{name}.cu")
        assert os.path.exists(src)
        with open(src) as f:
            assert '#include "ffma_tile.cuh"' in f.read()
        path = kernels._lib_path(name)
        assert path.startswith(kernels.BUILD_DIR)
        assert path.endswith(f"lib{name}.so")
    assert os.path.exists(os.path.join(kernels.CSRC_DIR, "ffma_tile.cuh"))
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_build_key_follows_the_shared_header(tmp_path, monkeypatch):
    """A change to ffma_tile.cuh alone moves every kernel's build key, so a
    stale library is never loaded."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    before = {name: kernels._lib_path(name) for name in kernels.KERNEL_SOURCES}
    with open(csrc / "ffma_tile.cuh", "a") as f:
        f.write("\n// edited\n")
    for name in kernels.KERNEL_SOURCES:
        assert kernels._lib_path(name) != before[name]


# ---- K2: slab dot products ------------------------------------------------

# (B, W, Nb, L, d): the JAX tests' shapes (W = 4 and the W = 5 padding
# case), and L not a multiple of 8 at a narrow d
SLAB_SHAPES = [(16, 4, 12, 8, 128), (8, 5, 7, 8, 128), (6, 5, 9, 12, 40)]


def _slab_case(rng, b, w, nb, length, d, repeat):
    q = rng.standard_normal((b, d)).astype(np.float32)
    lv = rng.standard_normal((nb, length, d)).astype(np.float32)
    sel = rng.integers(0, nb, (b, w)).astype(np.int32)
    sel[0, 0], sel[-1, -1] = 0, nb - 1  # both ends of the id range
    if repeat:  # the same block popped twice in a row, and by two queries
        sel[:, 1] = sel[:, 0]
        sel[1] = sel[0]
    return q, lv, sel


@pytest.mark.parametrize("repeat", [False, True])
@pytest.mark.parametrize("slab", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["pallas", "manual"])
@pytest.mark.parametrize("b,w,nb,length,d", SLAB_SHAPES)
def test_slab_dots_matches_pallas(rng, b, w, nb, length, d, variant, slab, repeat):
    q, lv, sel = _slab_case(rng, b, w, nb, length, d, repeat)
    jlv = jnp.asarray(lv) if slab == "f32" else jnp.asarray(lv).astype(jnp.bfloat16)
    if variant == "pallas":
        want = slab_dots_pallas(jnp.asarray(q), jlv, jnp.asarray(sel), interpret=True)
    else:
        want = slab_dots_manual(jnp.asarray(q), jlv, jnp.asarray(sel), interpret=True, depth=8)
    want = np.asarray(want)
    tlv = torch.from_numpy(lv)
    if slab == "bf16":  # the same bf16 bits on both sides
        tlv = torch.from_numpy(np.asarray(jlv).view(np.int16)).view(torch.bfloat16)
    got = kernels.slab_dots(torch.from_numpy(q), tlv, torch.from_numpy(sel))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (b, w, length)
    got = got.numpy()
    if slab == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    else:
        assert np.max(np.abs(got - want) / (np.abs(want) + 1.0)) <= 1e-4
    if repeat:  # a repeated id gives the same dots
        np.testing.assert_array_equal(got[:, 1], got[:, 0])


def test_slab_dots_plain_version_chunks_alike(rng):
    """The plain version's W chunking gives the same dots (to f32 sums in
    another order), and an int64 sel gives what int32 gives."""
    q, lv, sel = _slab_case(rng, 5, 7, 6, 10, 24, True)
    tq, tlv, tsel = torch.from_numpy(q), torch.from_numpy(lv), torch.from_numpy(sel)
    whole = kernels.slab_dots_reference(tq, tlv, tsel)
    want = np.einsum("bwld,bd->bwl", lv[sel], q)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(whole.numpy(), want, rtol=0, atol=tol)
    for chunk in (1, 5 * 10 * 24 * 4 * 3):  # one slab, then three at a time
        part = kernels.slab_dots_reference(tq, tlv, tsel, chunk_bytes=chunk)
        np.testing.assert_allclose(part.numpy(), want, rtol=0, atol=tol)
    assert torch.equal(kernels.slab_dots(tq, tlv, tsel.long()), whole)


def test_slab_dots_launch_count_untouched_on_cpu(rng):
    before = dict(kernels.LAUNCHES)
    q, lv, sel = _slab_case(rng, 3, 2, 4, 8, 16, False)
    kernels.slab_dots(torch.from_numpy(q), torch.from_numpy(lv), torch.from_numpy(sel))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize(
    "kind,exc",
    [
        ("int16_slabs", TypeError),
        ("f64_queries", TypeError),
        ("float_sel", TypeError),
        ("dim", ValueError),
        ("rows", ValueError),
        ("rank", ValueError),
        ("noncontig", ValueError),
    ],
)
def test_slab_dots_wrapper_rejects(kind, exc):
    q, lv, sel = torch.zeros((4, 16)), torch.zeros((5, 8, 16)), torch.zeros((4, 3), dtype=torch.int32)
    if kind == "int16_slabs":  # raw bf16 bits must arrive viewed as bfloat16
        lv = lv.to(torch.int16)
    elif kind == "f64_queries":
        q = q.double()
    elif kind == "float_sel":
        sel = sel.float()
    elif kind == "dim":
        q = torch.zeros((4, 12))
    elif kind == "rows":
        sel = torch.zeros((3, 3), dtype=torch.int32)
    elif kind == "rank":
        lv = torch.zeros((40, 16))
    elif kind == "noncontig":
        lv = torch.zeros((5, 16, 8)).transpose(1, 2)
    with pytest.raises(exc):
        kernels.slab_dots(q, lv, sel)
