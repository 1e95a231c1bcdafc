"""The block beam's CUDA graphs (``ops/graph.block_graph_search``) on the
card against the eager beam (``BlockBeam.run``).

Needs an NVIDIA card: every test takes the ``card`` fixture, which skips
on a host without one. This file imports nothing of JAX, so that it runs
on the card's machine without the repository's conftest:

    python -m pytest tests/test_torch_graph_capture_card.py -q --noconftest -p no:cacheprovider

A replay runs the kernels the eager beam runs, on the same inputs: ids
and distances must be equal bit for bit.
"""

import gc

import pytest
import torch

from vectordb_retrieval_tpu_torch.ops import graph as gops
from vectordb_retrieval_tpu_torch.ops import kernels

K = 10
# the geometry of a two-wave search (one push) and a three-wave one
GEOMETRIES = [dict(k=K, efb=48, expand=24, iters=2, metric="ip"),
              dict(k=K, efb=24, expand=8, iters=3, metric="l2")]


@pytest.fixture
def card():
    """Skips the test on a host without a CUDA card (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


def _clustered(dev, seed, n=20_000, d=50, n_clusters=64):
    gen = torch.Generator(device=dev).manual_seed(seed)
    centers = torch.randn((n_clusters, d), generator=gen, device=dev) * 1.5
    pick = torch.randint(0, n_clusters, (n,), generator=gen, device=dev)
    return centers[pick] + 0.6 * torch.randn((n, d), generator=gen, device=dev)


def _queries(dev, x, seed, b=64):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, x.shape[0], (b,), generator=gen, device=dev)
    return x[rows] + 0.3 * torch.randn((b, x.shape[1]), generator=gen, device=dev)


def _index(dev, seed, slab_dtype="bf16"):
    return gops.build_block_graph(_clustered(dev, seed), 120, 8, slab_dtype=slab_dtype)


def _calls():
    return dict(kernels.BEAM_CALLS)


def _delta(before):
    return {k: v - before[k] for k, v in kernels.BEAM_CALLS.items()}


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.card
@pytest.mark.parametrize("geometry", range(len(GEOMETRIES)))
def test_replays_equal_the_eager_beam_bit_for_bit(card, geometry):
    geom = GEOMETRIES[geometry]
    index = _index(card, 1)
    x = _clustered(card, 1)
    before = _calls()
    for seed in range(5):  # eager, capture, then three replays
        q = _queries(card, x, 100 + seed)
        got = gops.block_graph_search(q, *index, **geom)
        _assert_equal(got, gops.BlockBeam(q, *index, **geom).run())
    assert _delta(before) == {"eager": 1, "captured": 1, "replayed": 3}


@pytest.mark.card
def test_each_batch_shape_captures_its_own_graphs(card):
    geom = GEOMETRIES[0]
    index = _index(card, 2)
    x = _clustered(card, 2)
    before = _calls()
    for b in (64, 64, 64, 32, 32, 32, 64):
        q = _queries(card, x, 7 + b, b)
        _assert_equal(gops.block_graph_search(q, *index, **geom),
                      gops.BlockBeam(q, *index, **geom).run())
    assert _delta(before) == {"eager": 2, "captured": 2, "replayed": 3}


@pytest.mark.card
def test_a_rebuilt_index_never_replays_the_old_graphs(card):
    geom = GEOMETRIES[0]
    x = _clustered(card, 3)
    q = _queries(card, x, 5)
    old = _index(card, 3)
    for _ in range(3):
        gops.block_graph_search(q, *old, **geom)
    # beside the old index: other addresses, a key of its own
    new = _index(card, 4)
    before = _calls()
    _assert_equal(gops.block_graph_search(q, *new, **geom),
                  gops.BlockBeam(q, *new, **geom).run())
    assert _delta(before) == {"eager": 1, "captured": 0, "replayed": 0}
    # in place of the old index, freed first: its addresses may come back
    del old, new
    gc.collect()
    rebuilt = _index(card, 5)
    before = _calls()
    _assert_equal(gops.block_graph_search(q, *rebuilt, **geom),
                  gops.BlockBeam(q, *rebuilt, **geom).run())
    assert _delta(before) == {"eager": 1, "captured": 0, "replayed": 0}


@pytest.mark.card
def test_an_answer_outlives_the_next_call(card):
    geom = GEOMETRIES[0]
    index = _index(card, 6)
    x = _clustered(card, 6)
    for seed in range(2):  # eager, capture
        gops.block_graph_search(_queries(card, x, seed), *index, **geom)
    first = gops.block_graph_search(_queries(card, x, 10), *index, **geom)
    kept = (first[0].clone(), first[1].clone())
    second = gops.block_graph_search(_queries(card, x, 11), *index, **geom)
    torch.cuda.synchronize()
    _assert_equal(first, kept)
    assert not torch.equal(first[1], second[1])


@pytest.mark.card
def test_a_work_count_runs_the_beam_eagerly(card):
    geom = GEOMETRIES[0]
    index = _index(card, 7)
    x = _clustered(card, 7)
    q = _queries(card, x, 3)
    for _ in range(2):
        gops.block_graph_search(q, *index, **geom)
    before = _calls()
    with kernels.count_work() as work:
        got = gops.block_graph_search(q, *index, **geom)
    assert work["calls"] == geom["iters"]  # every wave's K2 call counted
    assert _delta(before) == {"eager": 1, "captured": 0, "replayed": 0}
    _assert_equal(got, gops.block_graph_search(q, *index, **geom))
