"""The port's kernels against the JAX Pallas kernels: dist_blockmin in its
f32, bf16 and u8 modes and dist_blockmin_pair (two pens over one bf16/u8
product), the k-means assignment, the graph beam's slab dot products, and
the interleaved full-L2 blockmin (K4); K5's plain version against the
tuning probe's floor; and K6's plain version (the exact rescore of the
selected blocks) against the JAX package's rescore arithmetic.

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
own test allows 1e-3); K4: 1e-5 x max|ref| (both compute ||q||^2 +
||x||^2 - 2 q.x with full-f32 products, summed in another order), and the
JAX oracle test's 1e-3 against float64.

On the card K1's f32 mode and K4 run 3xTF32 (``kernels.split_tf32``): the
split is tested against a float64 rounding of its own, and the kernels'
arithmetic is emulated here by three f32 products of the tf32-valued
pieces (each product exact in f32) and held against the Pallas kernels
with the tolerances above, against the plain versions within 1e-5 x
max|ref|, and against float64 where each output holds one product, within
1e-6 relative (the route's own error is <= 3 x 2^-22 plus f32 rounding).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectordb_retrieval_tpu.ops.kmeans import kmeans_assign as jax_kmeans_assign
from vectordb_retrieval_tpu.ops.pallas_kernels import (
    _BM_TILE,
    assign_pallas,
    blockmin_pallas,
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


def _pair_pens(rng, x, pen, pen_kind):
    """A second pen over the same payload: the other kind, with the first
    pen's dead slots and slot 0 of every block dead too (as the cover
    tree's pen of real nodes is a subset of its pen of all nodes)."""
    xf = x.astype(np.float32) if x.dtype == np.uint8 else np.asarray(
        jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    other = np.zeros(pen.shape, np.float32) if pen_kind == "l2" else (
        (xf * xf).sum(1).reshape(pen.shape).astype(np.float32))
    other[np.isinf(pen)] = np.inf
    other[:, 0] = np.inf
    return other


@pytest.mark.parametrize("pen_kind", ["l2", "zero"])
@pytest.mark.parametrize("w", [8, 16, 32])
@pytest.mark.parametrize("mode", ["bf16", "u8"])
def test_dist_blockmin_pair_matches_pallas(rng, mode, w, pen_kind):
    """The pair equals two dist_blockmin_pallas calls, one per pen."""
    n, d, b = 1500, 48, 12
    q, x, pen_a = _mode_inputs(rng, n, d, b, w, mode, pen_kind)
    pen_b = _pair_pens(rng, x, pen_a, pen_kind)
    jx = jnp.asarray(x) if mode == "u8" else jnp.asarray(x).astype(jnp.bfloat16)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    want = [np.asarray(dist_blockmin_pallas(jq, jx, jnp.asarray(pen), w=w, interpret=True))
            for pen in (pen_a, pen_b)]
    tx = torch.from_numpy(x)
    if mode == "bf16":
        tx = tx.to(torch.bfloat16)
    got = kernels.dist_blockmin_pair(
        torch.from_numpy(q), tx, torch.from_numpy(pen_a), torch.from_numpy(pen_b), w=w)
    assert len(got) == 2
    for g, h in zip(got, want):
        g = g.numpy()
        assert g.shape == h.shape == (b, pen_a.shape[0]) and g.dtype == np.float32
        np.testing.assert_array_equal(np.isinf(g), np.isinf(h))
        assert np.isinf(g[:, 2]).all()  # block 2 is dead in both pens
        fin = np.isfinite(h)
        assert np.abs(g[fin] - h[fin]).max() <= 1e-5 * np.abs(h[fin]).max()
    assert not np.array_equal(got[0].numpy(), got[1].numpy())  # two pens, two results


def test_dist_blockmin_pair_plain_version_is_one_product(rng):
    """On the CPU the pair counts nothing, chunks alike, and gives each
    pen's dist_blockmin result bit for bit."""
    q, x, pen_a = _mode_inputs(rng, 700, 24, 5, 8, "u8", "l2")
    pen_b = _pair_pens(rng, x, pen_a, "l2")
    args = (torch.from_numpy(q), torch.from_numpy(x))
    pa, pb = torch.from_numpy(pen_a), torch.from_numpy(pen_b)
    before = dict(kernels.LAUNCHES)
    full = kernels.dist_blockmin_pair(*args, pa, pb, w=8)
    chunked = kernels.dist_blockmin_pair(*args, pa, pb, w=8, chunk_rows=40)
    assert kernels.LAUNCHES == before
    for got, pen, part in zip(full, (pa, pb), chunked):
        torch.testing.assert_close(got, kernels.dist_blockmin(*args, pen, w=8), rtol=0, atol=0)
        torch.testing.assert_close(part, got, rtol=1e-6, atol=1e-4)
    # the pair counts under its payload's mode, as dist_blockmin does
    assert set(kernels._PAIR_ENTRIES) <= set(kernels._DBM_MODES)


def _bad_pair(kind):
    q = torch.zeros((4, 16))
    x = torch.zeros((64, 16), dtype=torch.bfloat16)
    pen_a, pen_b = torch.zeros((8, 8)), torch.zeros((8, 8))
    if kind == "pen_shape":  # the second pen is not (S/w, w)
        pen_b = torch.zeros((4, 16))
    elif kind == "pen_len":
        pen_b = torch.zeros((7, 8))
    elif kind == "pen_dtype":
        pen_b = pen_b.double()
    elif kind == "pen_bf16":
        pen_a = pen_a.to(torch.bfloat16)
    elif kind == "f32_payload":  # the pair is a tensor-core mode only
        x = x.float()
    elif kind == "noncontig":
        pen_b = torch.zeros((8, 8)).T
    return q, x, pen_a, pen_b


@pytest.mark.parametrize(
    "kind,exc",
    [
        ("pen_shape", ValueError),
        ("pen_len", ValueError),
        ("pen_dtype", TypeError),
        ("pen_bf16", TypeError),
        ("f32_payload", TypeError),
        ("noncontig", ValueError),
    ],
)
def test_dist_blockmin_pair_wrapper_rejects(kind, exc):
    q, x, pen_a, pen_b = _bad_pair(kind)
    with pytest.raises(exc):
        kernels.dist_blockmin_pair(q, x, pen_a, pen_b, w=8)


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


@pytest.mark.parametrize(
    "n,k,d,dup",
    [(1000, 64, 32, False), (1030, 16, 16, False), (777, 40, 24, True)],
)
def test_assign_tf32x3_matches_pallas_and_plain(rng, n, k, d, dup):
    """K3's 3xTF32 arithmetic, emulated (||p||^2 summed from the raw f32
    points, (pn + cn) - 2 dot, the first minimum), against assign_pallas and
    the plain version: ids agree on >= 99.9 %, minima within 1e-5 of the
    largest, the lowest id on duplicated centroids."""
    x, c = _assign_case(rng, n, k, d, dup)
    pn = (x * x).sum(1, dtype=np.float32)
    cn = (c * c).sum(1, dtype=np.float32)
    dist = (pn[:, None] + cn[None, :]) - 2.0 * _tf32x3_dots(x, c)
    ids, mins = dist.argmin(1), dist.min(1)
    a_pl, d_pl = (np.asarray(v) for v in assign_pallas(jnp.asarray(x), jnp.asarray(c), interpret=True))
    p_ids, p_mins = (t.numpy() for t in kernels.assign_reference(torch.from_numpy(x), torch.from_numpy(c)))
    for ref_ids, ref_mins in ((a_pl, d_pl), (p_ids, p_mins)):
        assert (ids == ref_ids).mean() >= 0.999
        assert np.abs(mins - ref_mins).max() <= 1e-5 * np.abs(ref_mins).max()
    if dup:
        assert not np.isin(ids, [7, k - 1]).any()


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
        "slab_dots", "blockmin", "matmul_floor", "block_rescore", "ivf_block_rescore"}


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
    """Every kernel's source ships in csrc/ and includes its header: the
    tensor-core kernel's (K1, K3 and K4 run its main loop, K2 its loaders)
    or, for K5, the TMA and mbarrier helpers; K6 stands alone on the CUDA
    cores and includes no header of csrc/ (so none of the tensor-core
    helpers); both headers stand on the wgmma helpers; the FFMA tile is
    gone; each build directory is keyed by the source, the headers and the
    compiler flags."""
    import os

    headers = {"dist_blockmin_tc": "blockmin_tc.cuh", "blockmin": "blockmin_tc.cuh",
               "assign": "blockmin_tc.cuh", "slab_dots": "blockmin_tc.cuh",
               "matmul_floor": "tma.cuh", "block_rescore": None}
    assert set(headers) == set(kernels.KERNEL_SOURCES)
    assert sorted(f for f in os.listdir(kernels.CSRC_DIR) if f.endswith(".cuh")) == [
        "blockmin_tc.cuh", "tma.cuh", "wgmma.cuh"]
    for name in kernels.KERNEL_SOURCES:
        src = os.path.join(kernels.CSRC_DIR, f"{name}.cu")
        assert os.path.exists(src)
        with open(src) as f:
            text = f.read()
        if headers[name] is None:
            assert '#include "' not in text and "wgmma" not in text, name
        else:
            assert f'#include "{headers[name]}"' in text
        path = kernels._lib_path(name)
        assert path.startswith(kernels.BUILD_DIR)
        assert path.endswith(f"lib{name}.so")
    for header in set(headers.values()) - {None}:
        assert os.path.exists(os.path.join(kernels.CSRC_DIR, header))
    for header in ("blockmin_tc.cuh", "tma.cuh"):
        with open(os.path.join(kernels.CSRC_DIR, header)) as f:
            assert '#include "wgmma.cuh"' in f.read(), header
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_k1_entry_points_live_in_one_source_each():
    """Each K1 entry point the wrappers call is defined in the source the
    wrapper loads and in no other: every mode (f32, bf16 and u8, one pen
    and the pair) in the tensor-core source; K4's in blockmin.cu, K3's in
    assign.cu, K2's in slab_dots.cu, K5's in matmul_floor.cu, K6's in
    block_rescore.cu; no source
    holds an FFMA kernel or names the FFMA tile."""
    import os
    import re

    defined = {}
    for name in kernels.KERNEL_SOURCES:
        with open(os.path.join(kernels.CSRC_DIR, f"{name}.cu")) as f:
            for fn in re.findall(r'extern "C" int (vrt_\w+)\(', f.read()):
                defined.setdefault(fn, []).append(name)
    for _, source, fn in kernels._DBM_MODES.values():
        assert defined[fn] == [source], fn
    for fn in kernels._PAIR_ENTRIES.values():
        assert defined[fn] == ["dist_blockmin_tc"], fn
    assert {m[1] for m in kernels._DBM_MODES.values()} == {"dist_blockmin_tc"}
    assert defined["vrt_blockmin_f32"] == ["blockmin"]
    assert defined["vrt_assign_f32"] == ["assign"]
    assert defined["vrt_matmul_floor_f32"] == ["matmul_floor"]
    assert defined["vrt_block_rescore_f32"] == ["block_rescore"]
    assert defined["vrt_ivf_block_rescore_bf16"] == ["block_rescore"]
    for fn in kernels._SLAB_MODES.values():
        assert defined[fn] == ["slab_dots"], fn
    assert not [fn for fn, srcs in defined.items()
                if fn.startswith(("vrt_dist_blockmin", "vrt_blockmin"))
                and set(srcs) & {"assign", "slab_dots"}]
    for name in ("dist_blockmin.cu", "ffma_tile.cuh"):
        assert not os.path.exists(os.path.join(kernels.CSRC_DIR, name))
    for name in os.listdir(kernels.CSRC_DIR):
        with open(os.path.join(kernels.CSRC_DIR, name)) as f:
            assert "ffma_tile" not in f.read(), name
    with open(os.path.join(kernels.CSRC_DIR, "assign.cu")) as f:
        assert "Mode::ASSIGN" in f.read()
    with open(os.path.join(kernels.CSRC_DIR, "slab_dots.cu")) as f:
        src = f.read()
        assert "wgmma_m64n128k16_bf16" in src and "wgmma_m64n128k8_tf32" in src


def test_build_key_follows_the_wgmma_header(tmp_path, monkeypatch):
    """A change to wgmma.cuh alone moves every kernel's build key too."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    before = {name: kernels._lib_path(name) for name in kernels.KERNEL_SOURCES}
    with open(csrc / "wgmma.cuh", "a") as f:
        f.write("\n// edited\n")
    for name in kernels.KERNEL_SOURCES:
        assert kernels._lib_path(name) != before[name]


def test_build_key_follows_the_tensor_core_kernel_header(tmp_path, monkeypatch):
    """A change to blockmin_tc.cuh (the K1 and K4 kernel) alone moves every
    kernel's build key too."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    before = {name: kernels._lib_path(name) for name in kernels.KERNEL_SOURCES}
    with open(csrc / "blockmin_tc.cuh", "a") as f:
        f.write("\n// edited\n")
    for name in kernels.KERNEL_SOURCES:
        assert kernels._lib_path(name) != before[name]


def test_build_key_follows_the_shared_header(tmp_path, monkeypatch):
    """A change to any one shared header alone moves every kernel's build
    key, so a stale library is never loaded."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    for header in sorted(p.name for p in csrc.glob("*.cuh")):
        before = {name: kernels._lib_path(name) for name in kernels.KERNEL_SOURCES}
        with open(csrc / header, "a") as f:
            f.write("\n// edited\n")
        for name in kernels.KERNEL_SOURCES:
            assert kernels._lib_path(name) != before[name], (header, name)


# ---- the 3xTF32 route of K1 f32 and K4 ------------------------------------


def _rna_tf32_f64(x):
    """tf32 rounding (11 significant bits; the low 13 bits of an f32 word),
    to nearest with ties away from zero, computed in float64 from the
    value: the quantum is 2^(e - 11) for x = m 2^e, m in [0.5, 1), and
    2^-136 for f32 subnormals."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(x)
    quantum = np.maximum(np.ldexp(1.0, e - 11), np.ldexp(1.0, -136))
    return np.sign(x) * np.floor(np.abs(x) / quantum + 0.5) * quantum


def _split_values(kind, rng):
    if kind == "normals":
        return rng.standard_normal(4096).astype(np.float32) * np.float32(3.0)
    if kind == "specials":
        return np.array([0.0, -0.0, 1e6, -1e6, 1e30, -1e30, 1.0, -1.0, 3.3e-20,
                         65504.0, 1.17549435e-38], np.float32)
    tiny = np.float32(1.4e-45)  # subnormals, from the smallest to near 2^-126
    return np.concatenate([np.arange(1, 300, dtype=np.float32) * tiny,
                           -np.float32(1e-40) * np.arange(1, 60, dtype=np.float32),
                           np.array([1e-39, -1.1e-38], np.float32)])


@pytest.mark.parametrize("kind", ["normals", "specials", "subnormals"])
def test_split_tf32_pieces(rng, kind):
    """big and small carry the low 13 bits as zero, big is the value rounded
    to tf32 (ties away from zero), small is the rest rounded once, and
    big + small is the value up to that one rounding."""
    v = _split_values(kind, rng)
    big, small = kernels.split_tf32(torch.from_numpy(v))
    big, small = big.numpy(), small.numpy()
    assert big.dtype == small.dtype == np.float32
    for piece in (big, small):
        assert not (piece.view(np.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(big.astype(np.float64), _rna_tf32_f64(v))
    rest = v.astype(np.float64) - big.astype(np.float64)  # exact in f32 too
    np.testing.assert_array_equal(small.astype(np.float64), _rna_tf32_f64(rest))
    err = np.abs(v.astype(np.float64) - big.astype(np.float64) - small.astype(np.float64))
    # one rounding of small: half its tf32 step (2^-137 among subnormals)
    assert (err <= np.maximum(np.ldexp(np.abs(rest), -11), 2.0 ** -137)).all()
    if kind != "subnormals":
        assert (err <= np.ldexp(np.abs(v.astype(np.float64)), -22)).all()


def test_split_tf32_ties_round_away_from_zero():
    """Halfway values round away from zero (rna), where round-to-even would
    go the other way for the first pair."""
    h = 2.0 ** -11  # half a tf32 step at 1
    v = np.array([1 + h, -(1 + h), 1 + 3 * h, -(1 + 3 * h), 1 + h / 2], np.float32)
    big, small = kernels.split_tf32(torch.from_numpy(v))
    np.testing.assert_array_equal(
        big.numpy(), np.array([1 + 2 * h, -(1 + 2 * h), 1 + 4 * h, -(1 + 4 * h), 1.0],
                              np.float32))
    np.testing.assert_array_equal(
        small.numpy(), np.array([-h, h, -h, h, h / 2], np.float32))


def _tf32x3_dots(q, x):
    """q @ x.T as the kernels form it: the tf32 pieces' three products
    (small_q big_x + big_q small_x + big_q big_x), each exact in f32."""
    qb, qs = kernels.split_tf32(torch.from_numpy(q))
    xb, xs = kernels.split_tf32(torch.from_numpy(x))
    return (qs @ xb.T + qb @ xs.T + qb @ xb.T).numpy()


def _k1_tf32x3(q, x, pen, w):
    s = x.shape[0]
    scores = pen.reshape(1, s) - 2.0 * _tf32x3_dots(q, x)
    return scores.reshape(q.shape[0], s // w, w).min(-1)


@pytest.mark.parametrize("pen_kind", ["l2", "zero"])
@pytest.mark.parametrize("n,d,b,w", ORACLE_SHAPES)
def test_k1_f32_tf32x3_matches_pallas_and_plain(rng, n, d, b, w, pen_kind):
    """K1 f32's 3xTF32 arithmetic, emulated, against dist_blockmin_pallas
    (within its test's 2e-3) and the port's plain version (1e-5 x max)."""
    s = jax_pad_rows(n, w)
    q, dbp, pen = _inputs(rng, n, d, b, s, pen_kind)
    got = _k1_tf32x3(q, dbp, pen, w)
    want = np.asarray(dist_blockmin_pallas(
        jnp.asarray(q), jnp.asarray(dbp), jnp.asarray(pen).reshape(s // w, w), w=w,
        interpret=True))
    plain = kernels.dist_blockmin_reference(
        torch.from_numpy(q), torch.from_numpy(dbp),
        torch.from_numpy(pen).reshape(s // w, w), w=w).numpy()
    for ref, tol in ((want, 2e-3), (plain, None)):
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        fin = np.isfinite(ref)
        bound = tol if tol is not None else 1e-5 * np.abs(ref[fin]).max()
        assert np.abs(got[fin] - ref[fin]).max() <= bound


def test_k1_f32_tf32x3_one_product_against_float64(rng):
    """One product an output (d = 4, columns 1-3 zero, w = 1, zero pen): the
    3xTF32 route is within 1e-6 of float64 per entry; a bf16x3 split (the
    TPU kernel's HIGH) and plain TF32 are not."""
    q = np.zeros((64, 4), np.float32)
    x = np.zeros((4096, 4), np.float32)
    q[:, 0] = rng.standard_normal(64)
    x[:, 0] = rng.standard_normal(4096)
    exact = -2.0 * np.outer(q[:, 0].astype(np.float64), x[:, 0].astype(np.float64))
    pen = np.zeros(4096, np.float32)

    def rel(got):
        return float((np.abs(got - exact) / np.abs(exact)).max())

    assert rel(_k1_tf32x3(q, x, pen, 1)) <= 1e-6
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    hq = tq.to(torch.bfloat16).float()
    hx = tx.to(torch.bfloat16).float()
    lq = (tq - hq).to(torch.bfloat16).float()
    lx = (tx - hx).to(torch.bfloat16).float()
    bf16x3 = -2.0 * (hq @ hx.T + hq @ lx.T + lq @ hx.T).numpy()
    tf32 = -2.0 * (kernels.split_tf32(tq)[0] @ kernels.split_tf32(tx)[0].T).numpy()
    assert rel(bf16x3) > 1e-6 and rel(tf32) > 1e-4


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


def test_slab_dots_f32_block_geometry_waves_match_manual(rng):
    """The block-geometry probe's K2 shape: f32 slabs of L = 256 rows at
    d = 384 (one slab, 384 KiB, outgrows an SM's shared memory; the kernel
    stages k), over three waves of a beam (popped ids repeat across waves,
    queries share blocks), against slab_dots_manual in interpret mode."""
    b, w, nb, length, d = 6, 4, 5, 256, 384
    q = rng.standard_normal((b, d)).astype(np.float32)
    lv = rng.standard_normal((nb, length, d)).astype(np.float32)
    jq, jlv = jnp.asarray(q), jnp.asarray(lv)
    popped = rng.permutation(np.repeat(np.arange(nb), 3 * b * w // nb + 1))
    for wave in range(3):
        sel = popped[wave * b * w:(wave + 1) * b * w].reshape(b, w).astype(np.int32)
        sel[1] = sel[0]
        want = np.asarray(slab_dots_manual(jq, jlv, jnp.asarray(sel), interpret=True, depth=8))
        got = kernels.slab_dots(torch.from_numpy(q), torch.from_numpy(lv), torch.from_numpy(sel))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (b, w, length)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


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


def test_split_bf16x3_pieces(rng):
    """hi, mid and lo are bf16 values whose sum is the f32 value to 2^-24
    relative (each difference exact in f32); two pieces, the TPU kernel's
    split, leave ~2^-16."""
    v = np.concatenate([rng.standard_normal(4096).astype(np.float32) * np.float32(3.0),
                        np.array([0.0, -0.0, 1e6, -1e-6, 1e30, 65504.0, 1.0], np.float32)])
    hi, mid, lo = kernels.split_bf16x3(torch.from_numpy(v))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    x = v.astype(np.float64)
    parts = [t.float().numpy().astype(np.float64) for t in (hi, mid, lo)]
    np.testing.assert_array_equal(parts[0], np.asarray(torch.from_numpy(v).to(torch.bfloat16).float()))
    assert (np.abs(x - parts[0] - parts[1] - parts[2]) <= np.ldexp(np.abs(x), -24)).all()
    assert (np.abs(x - parts[0] - parts[1]) > np.ldexp(np.abs(x), -20)).any()


def _bf16x3_slab_dots(q, lv, sel):
    """slab_dots as K2 forms it on bf16 slabs: the three query pieces' exact
    products with the slab values, summed in f32."""
    tlv = torch.from_numpy(lv).to(torch.bfloat16).float()
    pieces = [p.float() for p in kernels.split_bf16x3(torch.from_numpy(q))]
    slabs = tlv[torch.from_numpy(sel).long()]  # [B, W, L, d]
    return sum(torch.einsum("bwld,bd->bwl", slabs, p) for p in pieces[::-1]).numpy()


@pytest.mark.parametrize("b,w,nb,length,d", SLAB_SHAPES)
def test_slab_dots_bf16x3_matches_pallas_and_plain(rng, b, w, nb, length, d):
    """K2's bf16 arithmetic, emulated, against slab_dots_pallas (the JAX
    kernel's two-piece split, within its 1e-4 x (|ref| + 1)) and against the
    port's plain version, the f32 query against the stored values, within
    1e-5 x max|ref|."""
    q, lv, sel = _slab_case(rng, b, w, nb, length, d, True)
    jlv = jnp.asarray(lv).astype(jnp.bfloat16)
    want = np.asarray(slab_dots_pallas(jnp.asarray(q), jlv, jnp.asarray(sel), interpret=True))
    got = _bf16x3_slab_dots(q, lv, sel)
    plain = kernels.slab_dots_reference(
        torch.from_numpy(q), torch.from_numpy(lv).to(torch.bfloat16), torch.from_numpy(sel)).numpy()
    assert got.shape == want.shape == plain.shape == (b, w, length)
    assert np.max(np.abs(got - want) / (np.abs(want) + 1.0)) <= 1e-4
    assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()


def _work_case(kind, rng):
    """(B, W, Nb, sel) of one grouping case."""
    if kind == "pad_slab":  # most pops clamped to block 0 by the beam
        sel = rng.integers(0, 50, (64, 40))
        sel[rng.random(sel.shape) < 0.8] = 0
        return 50, sel
    if kind == "out_of_range":  # ids -1 and Nb: their own bucket, NaN rows
        sel = rng.integers(0, 9, (20, 7))
        sel[0, 0], sel[3, 6], sel[19, 2] = -1, 9, 12
        return 9, sel
    if kind == "repeated":  # a block twice in a row, two queries alike
        sel = rng.integers(0, 6, (10, 5))
        sel[:, 1] = sel[:, 0]
        sel[1] = sel[0]
        return 6, sel
    if kind == "w1":
        return 7, rng.integers(0, 7, (300, 1))
    if kind == "ragged":  # B W = 391, no multiple of 128; one bucket of 300
        sel = rng.integers(0, 30, (23, 17))
        sel.reshape(-1)[:300] = 4
        return 30, sel
    # at the static bound: every bucket (the out-of-range one too) holds
    # 1 mod 128 pairs
    counts = [129, 1, 257, 1, 1]  # buckets 0-3 and bucket Nb = 4
    sel = np.concatenate([np.full(c, g if g < 4 else -1) for g, c in enumerate(counts)])
    return 4, rng.permutation(sel).reshape(-1, 1)


def _walk_work_items(queries, list_vecs, sel):
    """slab_dots computed as the kernel walks it: per work item of
    kernels.slab_work_items, the item's slab against the queries of its
    pairs, one product an item; items of bucket Nb leave NaN rows."""
    b, w = sel.shape
    nb, length, _ = list_vecs.shape
    order, items, _ = kernels.slab_work_items(sel, nb)
    out = torch.full((b * w, length), float("nan"))
    for slab, first, count in items.tolist():
        if count and slab < nb:
            pairs = order[first : first + count]
            out[pairs] = queries[pairs // w] @ list_vecs[slab].T
    return out.reshape(b, w, length)


@pytest.mark.parametrize("kind", ["pad_slab", "out_of_range", "repeated", "w1", "ragged", "bound"])
def test_slab_work_items(rng, kind):
    """K2's grouping (plain version): every pair in exactly one item of its
    bucket, items of at most 128 pairs in bucket order, the count within
    the static bound (at it for 'bound') and no host sync needed to size
    anything; walking the items gives slab_dots_reference, NaN rows for ids
    outside [0, Nb)."""
    nb, sel = _work_case(kind, rng)
    sel = torch.from_numpy(sel.astype(np.int32))
    b, w = sel.shape
    order, items, n_items = kernels.slab_work_items(sel, nb)
    n = int(n_items)
    bound = kernels.slab_max_items(b * w, nb)
    assert items.shape == (bound, 3) and n <= bound
    if kind == "bound":
        assert n == bound == 8
    assert sorted(order.tolist()) == list(range(b * w))
    flat = sel.reshape(-1).long()
    key = torch.where((flat >= 0) & (flat < nb), flat, nb)
    seen = torch.zeros(b * w, dtype=torch.long)
    for slab, first, count in items[:n].tolist():
        assert 1 <= count <= kernels.SLAB_ITEM_PAIRS and 0 <= slab <= nb
        pairs = order[first : first + count]
        assert (key[pairs] == slab).all()
        seen[pairs] += 1
    assert (seen == 1).all()
    assert items[n:].tolist() == [[nb + 1, 0, 0]] * (bound - n)
    largest = int(torch.bincount(key, minlength=nb + 1).max())
    assert n >= -(-largest // kernels.SLAB_ITEM_PAIRS) + (int((key != key[0]).any()))
    q = torch.from_numpy(rng.standard_normal((b, 24)).astype(np.float32))
    lv = torch.from_numpy(rng.standard_normal((nb, 12, 24)).astype(np.float32))
    got = _walk_work_items(q, lv, sel)
    bad = (sel < 0) | (sel >= nb)
    assert torch.equal(torch.isnan(got).any(-1), bad) and torch.isnan(got[bad]).all()
    want = kernels.slab_dots_reference(q, lv, sel.clamp(0, nb - 1))
    torch.testing.assert_close(got[~bad], want[~bad], rtol=0, atol=1e-5 * float(want.abs().max()))


# ---- K4: interleaved full-L2 blockmin ------------------------------------

# (N, d, B, w): the JAX oracle test's shape, w = 32 (seg = 64), a ragged B,
# two tiles at w = 16, and a database under one tile (TILE = N, seg = 32)
K4_SHAPES = [(4096, 32, 8, 8), (4096, 32, 8, 32), (4096, 24, 5, 8), (4096, 17, 3, 16),
             (256, 16, 4, 8)]


def _k4_oracle(q, x, w):
    """The JAX test's float64 oracle of the interleaved membership."""
    n = x.shape[0]
    tile = min(_BM_TILE, n)
    seg = tile // w
    full = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    out = np.empty((q.shape[0], n // w))
    for g in range(n // w):
        ti, j = g // seg, g % seg
        out[:, g] = full[:, [ti * tile + j + i * seg for i in range(w)]].min(-1)
    return out


@pytest.mark.parametrize("n,d,b,w", K4_SHAPES)
def test_blockmin_matches_pallas(rng, n, d, b, w):
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    want = np.asarray(blockmin_pallas(jnp.asarray(q), jnp.asarray(x), w=w, interpret=True))
    got = kernels.blockmin(torch.from_numpy(q), torch.from_numpy(x), w=w)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (b, n // w)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, _k4_oracle(q, x, w), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n,d,b,w", K4_SHAPES)
def test_blockmin_tf32x3_matches_pallas(rng, n, d, b, w):
    """K4's 3xTF32 arithmetic, emulated (||x||^2 from the raw rows), against
    blockmin_pallas within 1e-5 x max|ref|."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    want = np.asarray(blockmin_pallas(jnp.asarray(q), jnp.asarray(x), w=w, interpret=True))
    seg = min(_BM_TILE, n) // w
    qn = (q * q).sum(1, dtype=np.float32)
    xn = (x * x).sum(1, dtype=np.float32)
    dist = (qn[:, None] + xn[None, :]) - 2.0 * _tf32x3_dots(q, x)
    got = dist.reshape(b, -1, w, seg).min(2).reshape(b, -1)
    assert got.shape == want.shape == (b, n // w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_blockmin_plain_version_chunks_by_tile(rng):
    """Chunking the plain version by whole tiles changes nothing, and padding
    rows of 1e6 never win a minimum."""
    x = rng.standard_normal((6144, 12)).astype(np.float32)
    q = rng.standard_normal((4, 12)).astype(np.float32)
    x[5000:] = 1e6
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    whole = kernels.blockmin_reference(tq, tx, w=8)
    for chunk in (1, 2048, 4096, 5000):
        assert torch.equal(kernels.blockmin_reference(tq, tx, w=8, chunk_rows=chunk), whole)
    assert float(whole.max()) < 1e3  # every block keeps a real row
    np.testing.assert_allclose(whole.numpy(), _k4_oracle(q, x, 8), rtol=1e-3, atol=1e-3)


def test_blockmin_launch_count_untouched_on_cpu(rng):
    before = dict(kernels.LAUNCHES)
    kernels.blockmin(torch.zeros((2, 8)), torch.ones((64, 8)), w=8)
    assert kernels.LAUNCHES == before
    assert "blockmin" in kernels.LAUNCHES and "blockmin" in kernels.KERNEL_SOURCES


@pytest.mark.parametrize(
    "kind,exc",
    [
        ("f64", TypeError),
        ("bf16", TypeError),
        ("dim", ValueError),
        ("rank", ValueError),
        ("noncontig", ValueError),
        ("ragged_tiles", ValueError),
        ("w", ValueError),
        ("w_over_tile", ValueError),
        ("empty", ValueError),
    ],
)
def test_blockmin_wrapper_rejects(kind, exc):
    q, x, w = torch.zeros((4, 16)), torch.zeros((4096, 16)), 8
    if kind == "f64":
        x = x.double()
    elif kind == "bf16":
        q = q.to(torch.bfloat16)
    elif kind == "dim":
        q = torch.zeros((4, 12))
    elif kind == "rank":
        q = torch.zeros(16)
    elif kind == "noncontig":
        x = torch.zeros((16, 4096)).T
    elif kind == "ragged_tiles":  # N % 2048 != 0 above one tile
        x = torch.zeros((3000, 16))
    elif kind == "w":
        w = 12
    elif kind == "w_over_tile":  # a 4-row tile cannot hold w = 8 members
        x = torch.zeros((4, 16))
    elif kind == "empty":
        x = torch.zeros((0, 16))
    with pytest.raises(exc):
        kernels.blockmin(q, x, w=w)


# ---- K5: K1 f32's matmul floor (the TPU kernel lives in a tuning probe) -----


def _jax_matmul_floor():
    """The floor of ``scripts/exp_dbm_tune.py``, loaded by path, with its
    ``pallas_call`` in interpret mode."""
    import importlib.util
    import os
    import types

    from jax.experimental import pallas as pl

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "exp_dbm_tune.py")
    spec = importlib.util.spec_from_file_location("jax_exp_dbm_tune", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=lambda *a, **k: pl.pallas_call(*a, **{**k, "interpret": True}))
    return mod.matmul_floor


# (B, d, S), each S a whole number of the probe's 256-row tiles
K5_SHAPES = [(8, 16, 512), (16, 64, 1024), (12, 40, 2048)]


@pytest.mark.parametrize("w", [8, 16, 32])
@pytest.mark.parametrize("b,d,s", K5_SHAPES)
def test_matmul_floor_matches_pallas(rng, b, d, s, w):
    """The plain version against the TPU floor in interpret mode (its 3-pass
    bf16 split, ~5.7e-6 of the largest |dot| from float64 here) within 2e-5
    of the largest |dot|; both against float64."""
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = rng.standard_normal((s, d)).astype(np.float32)
    want = np.asarray(_jax_matmul_floor()(jnp.asarray(q), jnp.asarray(x), w, 256))
    got = kernels.matmul_floor(torch.from_numpy(q), torch.from_numpy(x), w=w).numpy()
    exact = x[::w].astype(np.float64) @ q.astype(np.float64).T
    assert got.shape == want.shape == (s // w, b) and got.dtype == np.float32
    scale = np.abs(exact).max()
    assert np.abs(got - want).max() <= 2e-5 * scale
    assert np.abs(got - exact).max() <= 1e-6 * scale
    assert np.abs(want - exact).max() <= 2e-5 * scale


# chip_smoke.py's K5_SHAPES rows at the kernel's edges, (B, S, d, w, offset):
# d % 4 != 0 at w = 32 (masked loads), and a payload view one element into
# its buffer (its base 4 bytes past a 16-byte boundary: masked loads too)
K5_EDGE_SHAPES = [(130, 4096, 98, 32, 0), (256, 4096, 384, 8, 1)]


@pytest.mark.parametrize("b,s,d,w,offset", K5_EDGE_SHAPES)
def test_matmul_floor_matches_pallas_at_the_edges(rng, b, s, d, w, offset):
    """The plain version on the inputs of chip_smoke.py's two edge rows of
    K5 (the payload as the view the card is given) against the TPU floor in
    interpret mode, held as test_matmul_floor_matches_pallas holds them."""
    q = rng.standard_normal((b, d)).astype(np.float32)
    buf = rng.standard_normal(s * d + offset).astype(np.float32)
    x = buf[offset:].reshape(s, d)
    payload = torch.from_numpy(buf)[offset:].view(s, d)
    assert payload.is_contiguous() and payload.storage_offset() == offset
    want = np.asarray(_jax_matmul_floor()(jnp.asarray(q), jnp.asarray(x), w, 256))
    got = kernels.matmul_floor(torch.from_numpy(q), payload, w=w).numpy()
    exact = x[::w].astype(np.float64) @ q.astype(np.float64).T
    assert got.shape == want.shape == (s // w, b) and got.dtype == np.float32
    scale = np.abs(exact).max()
    assert np.abs(got - want).max() <= 2e-5 * scale
    assert np.abs(got - exact).max() <= 1e-6 * scale
    assert np.abs(want - exact).max() <= 2e-5 * scale


def test_matmul_floor_is_its_own_tma_kernel():
    """K5 is a kernel of its own: its entry point lives in matmul_floor.cu
    and in no other source; that source runs on the TMA and mbarrier
    helpers (a producer's bulk tensor copies into an mbarrier ring); the
    tensor-core block-minimum kernel has no floor mode left; and the
    binding gives the entry point to the new library alone."""
    import ctypes
    import os
    import re

    sources = {}
    for name in os.listdir(kernels.CSRC_DIR):
        with open(os.path.join(kernels.CSRC_DIR, name)) as f:
            sources[name] = f.read()
    entry = re.compile(r'extern "C" int vrt_matmul_floor_f32\(')
    assert [n for n, src in sources.items() if entry.search(src)] == ["matmul_floor.cu"]
    src = sources["matmul_floor.cu"]
    assert '#include "tma.cuh"' in src
    for word in ("tma_load_2d", "mbar_wait", "mbar_arrive", "setmaxnreg"):
        assert word in src, word
    assert "cp.async.bulk.tensor" in sources["tma.cuh"] and "mbarrier" in sources["tma.cuh"]
    hdr = sources["blockmin_tc.cuh"]
    assert "FLOOR" not in hdr and "floor_epilogue" not in hdr
    assert "matmul_floor" not in sources["dist_blockmin_tc.cu"]

    class Lib:  # records what _bind sets on each entry point
        def __init__(self):
            self.fns = {}

        def __getattr__(self, fn):
            return self.fns.setdefault(fn, type("Fn", (), {})())

    bound = {}
    for name in kernels.KERNEL_SOURCES:
        lib = Lib()
        kernels._bind(name, lib)
        bound[name] = set(lib.fns)
    assert [n for n, fns in bound.items() if "vrt_matmul_floor_f32" in fns] == ["matmul_floor"]
    lib = Lib()
    kernels._bind("matmul_floor", lib)
    fn = lib.fns["vrt_matmul_floor_f32"]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    assert fn.argtypes == [vp] * 4 + [ci] * 4 + [vp] and fn.restype == ci
    scratch = lib.fns["vrt_matmul_floor_scratch_floats"]
    assert scratch.argtypes == [ci, ci] and scratch.restype == ctypes.c_longlong


@pytest.mark.parametrize("name", ["shipped", "cluster1", "cluster4", "regs56", "early_split",
                                  "no_overlap", "cluster_release", "consumers_only"])
def test_matmul_floor_variants_apply_to_the_sources(name):
    """Each of K5's timed variants (scripts.exp_matmul_floor_variants) is
    the shipped source with its substitutions, each matching its file once;
    only "shipped" leaves the sources as they are."""
    import os

    from vectordb_retrieval_tpu_torch.scripts import exp_matmul_floor_variants as variants

    assert name in variants.VARIANTS
    shipped = {f: open(os.path.join(kernels.CSRC_DIR, f)).read()
               for f in os.listdir(kernels.CSRC_DIR) if f.endswith((".cu", ".cuh"))}
    texts = variants.variant_sources(name)
    assert set(texts) == set(shipped)
    changed = {f for f in texts if texts[f] != shipped[f]}
    expected = {f for f, _, _ in variants.VARIANTS[name][1]}
    assert changed == expected and (name == "shipped") == (not changed)


def test_matmul_floor_launch_count_untouched_on_cpu():
    before = dict(kernels.LAUNCHES)
    out = kernels.matmul_floor(torch.ones((3, 8)), torch.ones((64, 8)), w=16)
    assert kernels.LAUNCHES == before and tuple(out.shape) == (4, 3)
    with kernels.count_work() as work:
        kernels.matmul_floor(torch.ones((3, 8)), torch.ones((64, 8)), w=16)
    assert work == {"flops": 2.0 * 3 * 4 * 8,
                    "bytes": 4.0 * (3 * 8 + 4 * 8 + 4 * 3), "calls": 1}


@pytest.mark.parametrize(
    "kind,exc",
    [
        ("f64", TypeError),
        ("bf16", TypeError),
        ("dim", ValueError),
        ("rank", ValueError),
        ("noncontig", ValueError),
        ("ragged_s", ValueError),
        ("w", ValueError),
        ("w_256", ValueError),
    ],
)
def test_matmul_floor_wrapper_rejects(kind, exc):
    q, x, w = torch.zeros((4, 16)), torch.zeros((256, 16)), 8
    if kind == "f64":
        q = q.double()
    elif kind == "bf16":
        x = x.to(torch.bfloat16)
    elif kind == "dim":
        q = torch.zeros((4, 12))
    elif kind == "rank":
        x = torch.zeros(256)
    elif kind == "noncontig":
        x = torch.zeros((16, 256)).T
    elif kind == "ragged_s":
        x = torch.zeros((260, 16))
    elif kind == "w":
        w = 12
    elif kind == "w_256":  # the kernel's groups are at most one 128-row tile
        w = 256
    with pytest.raises(exc):
        kernels.matmul_floor(q, x, w=w)


# ---- K6: exact rescore of the selected blocks -------------------------------


def _rescore_case(rng, b, n, d, w, nb, metric):
    """Queries, the payload padded with zero rows to whole blocks, and block
    ids drawn with repeats, the ragged last block always among them."""
    s = kernels.dist_blockmin_pad_rows(n, w)
    x = np.zeros((s, d), np.float32)
    x[:n] = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if metric == "cosine":
        x[:n] /= np.linalg.norm(x[:n], axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    blk = rng.integers(0, s // w, (b, nb))
    blk[0, 0] = s // w - 1
    return q, x, blk


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("d", [3, 50, 128, 384])
@pytest.mark.parametrize("w", [8, 16, 32])
def test_block_rescore_reference_matches_jax_rescore(rng, w, d, metric):
    """The plain version against the JAX package's stage-3 arithmetic on the
    gathered blocks (``jnp.sum((x - q)**2)`` and ``-jnp.sum(x * q)``; cosine
    is ip on normalised rows), within 1e-5 of the largest |score| (f32 sums
    in another order); n is not a multiple of w and the ragged block is
    selected: its padding rows read +inf and -1."""
    n = 7 * w + 3
    b, nb = 5, 4
    q, x, blk = _rescore_case(rng, b, n, d, w, nb, metric)
    cd, cand = kernels.block_rescore_reference(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(blk), n, w,
        "l2" if metric == "l2" else "ip")
    blocks = jnp.asarray(x.reshape(-1, w, d)[blk])  # [B, nb, w, d]
    qj = jnp.asarray(q)[:, None, None, :]
    if metric == "l2":
        want = jnp.sum((blocks - qj) ** 2, axis=-1)
    else:
        want = -jnp.sum(blocks * qj, axis=-1)
    want = np.asarray(want).reshape(b, nb * w)
    ids = (blk[:, :, None] * w + np.arange(w)).reshape(b, nb * w)
    pad = ids >= n
    assert pad[0, :w].sum() == w - 3  # the ragged block's padding rows
    assert cd.dtype == torch.float32 and cand.dtype == torch.int64
    assert cd.shape == cand.shape == (b, nb * w)
    np.testing.assert_array_equal(cand.numpy(), np.where(pad, -1, ids))
    cd = cd.numpy()
    assert np.isposinf(cd[pad]).all() and np.isfinite(cd[~pad]).all()
    scale = np.abs(want[~pad]).max()
    assert np.abs(cd[~pad] - want[~pad]).max() <= 1e-5 * scale


def test_block_rescore_is_exact_search_stage_three(rng):
    """The wrapper on CPU tensors is the plain version: what
    _exact_search_blockmin rescores equals a direct distance of every
    selected row (integer rows: exact in f32)."""
    n, d, w = 1003, 16, 8
    x = rng.integers(0, 256, (n, d)).astype(np.float32)
    q = rng.integers(0, 256, (4, d)).astype(np.float32)
    s = kernels.dist_blockmin_pad_rows(n, w)
    payload = np.zeros((s, d), np.float32)
    payload[:n] = x
    blk = rng.integers(0, s // w, (4, 6))
    cd, cand = kernels.block_rescore(torch.from_numpy(q), torch.from_numpy(payload),
                                     torch.from_numpy(blk), n, w, "l2")
    for r in range(4):
        for c, i in enumerate(cand[r].tolist()):
            if i < 0:
                assert cd[r, c] == float("inf")
            else:
                assert float(cd[r, c]) == float(((x[i] - q[r]) ** 2).sum())


def test_block_rescore_launch_count_untouched_on_cpu(rng):
    """CPU tensors take the plain version: no launch is counted. The counted
    work reads each distinct selected block once (a repeated id and an
    id of another query's block count once)."""
    q, x, blk = _rescore_case(rng, 3, 100, 8, 8, 4, "l2")
    blk[1] = blk[0]  # every block of query 1 is one of query 0's
    before = dict(kernels.LAUNCHES)
    args = (torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(blk), 100, 8)
    with kernels.count_work() as work:
        kernels.block_rescore(*args, "l2")
        kernels.block_rescore(*args, "ip")
    assert kernels.LAUNCHES == before
    distinct = len(np.unique(blk))
    l2 = kernels.block_rescore_work(3, 4, 8, 8, distinct, "l2")
    ip = kernels.block_rescore_work(3, 4, 8, 8, distinct, "ip")
    assert work == {"flops": l2[0] + ip[0], "bytes": l2[1] + ip[1], "calls": 2}
    assert l2 == (3.0 * 3 * 4 * 8 * 8,
                  4.0 * distinct * 8 * 8 + 4.0 * 3 * 8 + 8.0 * 3 * 4 + 12.0 * 3 * 4 * 8)
    assert ip[0] == 2.0 * 3 * 4 * 8 * 8 and ip[1] == l2[1]


@pytest.mark.parametrize(
    "kind,exc",
    [
        ("f64", TypeError),
        ("bf16", TypeError),
        ("blk_int32", TypeError),
        ("rank", ValueError),
        ("noncontig", ValueError),
        ("noncontig_queries", ValueError),
        ("noncontig_blk", ValueError),
        ("ragged_s", ValueError),
        ("metric", ValueError),
        ("w", ValueError),
        ("w_4", ValueError),
        ("dim", ValueError),
        ("rows", ValueError),
        ("n", ValueError),
        ("blk_negative", IndexError),
        ("blk_past_the_blocks", IndexError),
    ],
)
def test_block_rescore_wrapper_rejects(kind, exc):
    q, x, blk = torch.zeros((4, 16)), torch.zeros((64, 16)), torch.zeros((4, 3), dtype=torch.int64)
    n, w, metric = 60, 8, "l2"
    if kind == "f64":
        q = q.double()
    elif kind == "bf16":
        x = x.to(torch.bfloat16)
    elif kind == "blk_int32":
        blk = blk.int()
    elif kind == "rank":
        blk = torch.zeros(12, dtype=torch.int64)
    elif kind == "noncontig":
        x = torch.zeros((16, 64)).T
    elif kind == "noncontig_queries":
        q = torch.zeros((16, 4)).T
    elif kind == "noncontig_blk":
        blk = torch.zeros((3, 4), dtype=torch.int64).T
    elif kind == "ragged_s":
        x = torch.zeros((60, 16))
    elif kind == "metric":  # cosine is ip on normalised rows: the caller maps it
        metric = "cosine"
    elif kind == "w":
        w = 12
    elif kind == "w_4":  # the kernel's row groups start at 8
        w = 4
    elif kind == "dim":
        q = torch.zeros((4, 12))
    elif kind == "rows":
        blk = torch.zeros((5, 3), dtype=torch.int64)
    elif kind == "n":
        n = 65
    elif kind == "blk_negative":  # the plain gather would wrap it
        blk[1, 2] = -1
    elif kind == "blk_past_the_blocks":
        blk[3, 0] = 64 // 8
    with pytest.raises(exc):
        kernels.block_rescore(q, x, blk, n, w, metric)


def test_block_rescore_binding_and_source():
    """K6's entry point is bound in its own library alone, with its
    argument types; its source states what it replaces and keeps the
    module's precision rule (an elementwise f32 sum, no tensor cores)."""
    import ctypes
    import os

    class Lib:  # records what _bind sets on each entry point
        def __init__(self):
            self.fns = {}

        def __getattr__(self, fn):
            return self.fns.setdefault(fn, type("Fn", (), {})())

    bound = {}
    for name in kernels.KERNEL_SOURCES:
        lib = Lib()
        kernels._bind(name, lib)
        bound[name] = lib.fns
    assert [n for n, fns in bound.items() if "vrt_block_rescore_f32" in fns] == ["block_rescore"]
    fn = bound["block_rescore"]["vrt_block_rescore_f32"]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    assert fn.argtypes == [vp] * 5 + [ci] * 7 + [vp] and fn.restype == ci
    assert "block_rescore" in kernels.KERNELS and kernels.LAUNCHES["block_rescore"] >= 0
    with open(os.path.join(kernels.CSRC_DIR, "block_rescore.cu")) as f:
        src = f.read()
    assert "Replaces no Pallas kernel" in src and "vectordb_retrieval_tpu/ops/distances.py" in src
    for word in ("wgmma", "mma.sync", "tf32", "__shfl_xor_sync", "fmaf"):
        assert (word in src) == (word in ("__shfl_xor_sync", "fmaf")), word


# ---- IVF-Flat's stage 3 over bf16 lists (ivf_block_rescore) ---------------------


def _ivf_rescore_case(rng, b, s, d, w, nb, integer):
    """bf16 lists (integers 0-255, exact in bf16, or normals), slot ids with
    a fifth of the slots dead, block ids with one block shared by every
    query and repeats, and a fifth of the pairs never probed (+inf)."""
    if integer:
        x = rng.integers(0, 256, (s, d)).astype(np.float32)
        q = rng.integers(0, 256, (b, d)).astype(np.float32)
    else:
        x = rng.standard_normal((s, d)).astype(np.float32)
        q = rng.standard_normal((b, d)).astype(np.float32)
    x16 = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    slots = rng.permutation(s).astype(np.int32)
    slots[rng.random(s) < 0.2] = -1
    blk = rng.integers(0, s // w, (b, nb))
    blk[:, 0] = blk[0, 1]  # one block in every query's selection
    vals = rng.random((b, nb)).astype(np.float32)
    vals[rng.random((b, nb)) < 0.2] = np.inf
    return q, x16, slots, blk, vals


def _ivf_rescore_tensors(q, x16, slots, blk, vals):
    payload = torch.from_numpy(x16.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return (torch.from_numpy(q), payload, torch.from_numpy(slots), torch.from_numpy(blk),
            torch.from_numpy(vals))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [50, 128])
@pytest.mark.parametrize("w", [8, 16, 32])
def test_ivf_block_rescore_reference_matches_jax_stage_three(rng, w, d, metric, integer):
    """The plain version against the JAX package's IVF stage 3 on the same
    inputs (``_ivf_probed_blockmin`` / ``_ivf_blockmin`` with IVF-Flat's
    block rescore: the blocks and their slot ids gathered whole, widened to
    f32, ``jnp.sum((x - q)**2)`` or ``-jnp.sum(x * q)``, then the unprobed
    pairs and dead slots masked to +inf). Integer rows: equal; normals:
    within 1e-5 of the largest |score| (f32 sums in another order). The row
    ids equal the slots' where the score is finite, -1 elsewhere."""
    b, s, nb = 6, 64 * w, 7
    q, x16, slots, blk, vals = _ivf_rescore_case(rng, b, s, d, w, nb, integer)
    cd, cand = kernels.ivf_block_rescore_reference(
        *_ivf_rescore_tensors(q, x16, slots, blk, vals), w, metric)
    # the JAX package's stage 3, as its IVF-Flat streams run it
    jcand = jnp.asarray(slots).reshape(-1, w)[jnp.asarray(blk)]  # [B, nb, w]
    v32 = jnp.asarray(x16).reshape(-1, w, d)[jnp.asarray(blk)].astype(jnp.float32)
    jq = jnp.asarray(q)[:, None, None, :]
    if metric == "l2":
        diff = v32 - jq
        jcd = jnp.sum(diff * diff, axis=-1)
    else:
        jcd = -jnp.sum(v32 * jq, axis=-1)
    jcd = jnp.where(jnp.isfinite(jnp.asarray(vals))[:, :, None], jcd, jnp.inf)
    jcd = jnp.where(jcand >= 0, jcd, jnp.inf).reshape(b, nb * w)
    want_cd, want_slots = np.asarray(jcd), np.asarray(jcand).reshape(b, nb * w)
    assert cd.dtype == torch.float32 and cand.dtype == torch.int64
    assert cd.shape == cand.shape == (b, nb * w)
    cd, cand = cd.numpy(), cand.numpy()
    fin = np.isfinite(want_cd)
    assert 0 < fin.sum() < fin.size  # dead slots and unprobed pairs were selected
    np.testing.assert_array_equal(np.isposinf(cd), ~fin)
    np.testing.assert_array_equal(cand, np.where(fin, want_slots, -1))
    if integer:
        np.testing.assert_array_equal(cd[fin], want_cd[fin])
    else:
        assert np.abs(cd[fin] - want_cd[fin]).max() <= 1e-5 * np.abs(want_cd[fin]).max()


def test_ivf_block_rescore_launch_count_untouched_on_cpu(rng):
    """CPU tensors take the plain version: no launch is counted. The counted
    work reads each distinct block of the probed pairs once and computes
    the probed pairs alone."""
    q, x16, slots, blk, vals = _ivf_rescore_case(rng, 3, 256, 16, 8, 4, True)
    blk[1] = blk[0]  # every block of query 1 is one of query 0's
    vals[2, 3] = np.inf
    before = dict(kernels.LAUNCHES)
    args = _ivf_rescore_tensors(q, x16, slots, blk, vals)
    with kernels.count_work() as work:
        kernels.ivf_block_rescore(*args, 8, "l2")
        kernels.ivf_block_rescore(*args, 8, "ip")
    assert kernels.LAUNCHES == before
    probed = np.isfinite(vals)
    distinct = len(np.unique(blk[probed]))
    l2 = kernels.ivf_block_rescore_work(3, 4, 8, 16, int(probed.sum()), distinct, "l2")
    ip = kernels.ivf_block_rescore_work(3, 4, 8, 16, int(probed.sum()), distinct, "ip")
    assert work == {"flops": l2[0] + ip[0], "bytes": l2[1] + ip[1], "calls": 2}
    assert l2 == (3.0 * probed.sum() * 8 * 16,
                  distinct * 8 * (2.0 * 16 + 4.0) + 4.0 * 3 * 16 + 12.0 * 3 * 4
                  + 12.0 * 3 * 4 * 8)
    assert ip[0] == 2.0 * probed.sum() * 8 * 16 and ip[1] == l2[1]


@pytest.mark.parametrize(
    "kind,exc",
    [
        ("queries_bf16", TypeError),
        ("payload_f32", TypeError),
        ("slots_int64", TypeError),
        ("blk_int32", TypeError),
        ("vals_f64", TypeError),
        ("rank", ValueError),
        ("slots_2d", ValueError),
        ("slots_short", ValueError),
        ("noncontig", ValueError),
        ("noncontig_queries", ValueError),
        ("vals_shape", ValueError),
        ("ragged_s", ValueError),
        ("metric", ValueError),
        ("w", ValueError),
        ("w_4", ValueError),
        ("w_256", ValueError),
        ("dim", ValueError),
        ("rows", ValueError),
        ("device_mix", ValueError),
        ("slots_device_mix", ValueError),
        ("device", ValueError),
        ("blk_negative", IndexError),
        ("blk_past_the_blocks", IndexError),
    ],
)
def test_ivf_block_rescore_wrapper_rejects(kind, exc):
    q, x = torch.zeros((4, 16)), torch.zeros((64, 16), dtype=torch.bfloat16)
    slots = torch.arange(64, dtype=torch.int32)
    blk, vals = torch.zeros((4, 3), dtype=torch.int64), torch.zeros((4, 3))
    w, metric = 8, "l2"
    # another device than the payload's: "meta" stands in for the card here
    meta = torch.device("meta")
    if kind == "queries_bf16":
        q = q.to(torch.bfloat16)
    elif kind == "payload_f32":  # f32 lists keep the gathered chain
        x = x.float()
    elif kind == "slots_int64":
        slots = slots.long()
    elif kind == "blk_int32":
        blk = blk.int()
    elif kind == "vals_f64":
        vals = vals.double()
    elif kind == "rank":
        blk = torch.zeros(12, dtype=torch.int64)
    elif kind == "slots_2d":
        slots = slots.reshape(8, 8)
    elif kind == "slots_short":
        slots = slots[:56]
    elif kind == "noncontig":
        x = torch.zeros((16, 64), dtype=torch.bfloat16).T
    elif kind == "noncontig_queries":
        q = torch.zeros((16, 4)).T
    elif kind == "vals_shape":
        vals = torch.zeros((4, 2))
    elif kind == "ragged_s":
        x, slots = x[:60], slots[:60]
    elif kind == "metric":  # cosine is ip on normalised rows: the caller maps it
        metric = "cosine"
    elif kind == "w":
        w = 12
    elif kind == "w_4":
        w = 4
    elif kind == "w_256":
        w, x, slots = 256, torch.zeros((256, 16), dtype=torch.bfloat16), torch.arange(
            256, dtype=torch.int32)
    elif kind == "dim":
        q = torch.zeros((4, 12))
    elif kind == "rows":
        blk, vals = torch.zeros((5, 3), dtype=torch.int64), torch.zeros((5, 3))
    elif kind == "device_mix":
        q = q.to(meta)
    elif kind == "slots_device_mix":
        slots = slots.to(meta)
    elif kind == "device":  # neither the card nor the host
        q, x, slots, blk, vals = (t.to(meta) for t in (q, x, slots, blk, vals))
    elif kind == "blk_negative":  # the plain gather would wrap it
        blk[1, 2] = -1
    elif kind == "blk_past_the_blocks":
        blk[3, 0] = 64 // 8
    with pytest.raises(exc):
        kernels.ivf_block_rescore(q, x, slots, blk, vals, w, metric)


def test_ivf_block_rescore_binding_and_source():
    """The kernel's entry point is bound in K6's library alone (no library
    more to load), with its argument types; its source states what it
    replaces, keeps the precision rule, and names its kernel so that K6's
    reader (``block_rescore_kernel<`` after a word boundary) cannot match it;
    K6's kernel and entry point lie before it."""
    import ctypes
    import os
    import re

    class Lib:  # records what _bind sets on each entry point
        def __init__(self):
            self.fns = {}

        def __getattr__(self, fn):
            return self.fns.setdefault(fn, type("Fn", (), {})())

    bound = {}
    for name in kernels.KERNEL_SOURCES:
        lib = Lib()
        kernels._bind(name, lib)
        bound[name] = lib.fns
    assert [n for n, fns in bound.items() if "vrt_ivf_block_rescore_bf16" in fns] == [
        "block_rescore"]
    fn = bound["block_rescore"]["vrt_ivf_block_rescore_bf16"]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    assert fn.argtypes == [vp] * 7 + [ci] * 6 + [vp] and fn.restype == ci
    assert "ivf_block_rescore" in kernels.KERNELS and kernels.LAUNCHES["ivf_block_rescore"] >= 0
    assert "ivf_block_rescore" not in kernels.KERNEL_SOURCES
    with open(os.path.join(kernels.CSRC_DIR, "block_rescore.cu")) as f:
        src = f.read()
    head, ivf = src.split("// ---- IVF-Flat's stage 3 over bf16 lists")
    assert "Replaces no Pallas kernel" in ivf and "vectordb_retrieval_tpu/ops/" in ivf
    assert "_ivf_probed_blockmin" in ivf and "_ivf_blockmin" in ivf
    for word in ("wgmma", "mma.sync", "tf32", "__half", "__nv_bfloat16"):
        assert word not in ivf, word
    assert "ivf_block_rescore_kernel(" in ivf and "block_rescore_kernel(" in head
    assert not re.search(r"\bblock_rescore_kernel<", "void vrt::ivfr::ivf_block_rescore_kernel<16, "
                         "16, 8, 1, true>(float const*)")
    # K6 lies whole before the new section (the new kernel reuses its
    # add_term and halve_rows as they are)
    assert 'extern "C" int vrt_block_rescore_f32(' in head and "namespace ivfr" not in head
