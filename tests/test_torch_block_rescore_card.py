"""K6 (``ops/kernels.block_rescore``) on the card against its plain version.

Needs an NVIDIA card: every test takes the ``card`` fixture, which skips
on a host without one. This file imports nothing of JAX, so that it runs
on the card's machine without the repository's conftest:

    python -m pytest tests/test_torch_block_rescore_card.py -q --noconftest -p no:cacheprovider

Integer-valued rows (0-255) make every partial sum an integer below 2^24,
exact in f32 in any order: the kernel must equal the plain version. On
float rows the two sum in another order: within 1e-6 of the largest score.
"""

import os
import subprocess
import sys

import pytest
import torch

from vectordb_retrieval_tpu_torch.ops import kernels

# (B, n, d, w, nb, metric): the two exact cells' shapes cut in B, d % 4 != 0,
# one to four 16-byte chunks a lane, wide blocks; n is never a multiple of w
SHAPES = [
    (64, 100_003, 128, 32, 116, "l2"),
    (128, 100_001, 384, 8, 36, "ip"),
    (9, 5_003, 50, 16, 9, "l2"),
    (7, 2_001, 3, 8, 5, "ip"),
    (11, 9_001, 768, 32, 7, "ip"),
    (16, 20_003, 384, 64, 6, "l2"),
    (5, 4_099, 96, 128, 4, "ip"),
]


@pytest.fixture
def card():
    """Skips the test on a host without a CUDA card (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


def _case(dev, b, n, d, w, nb, integer, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = kernels.dist_blockmin_pad_rows(n, w)

    def draw(*shape):
        if integer:
            return torch.randint(0, 256, shape, generator=gen, device=dev).float()
        return torch.randn(shape, generator=gen, device=dev)

    x = torch.zeros((s, d), device=dev)
    x[:n] = draw(n, d)
    blk = torch.randint(0, s // w, (b, nb), generator=gen, device=dev)
    blk[0, 0] = s // w - 1  # the ragged last block: its padding rows
    return draw(b, d), x, blk


# integer rows wherever every sum stays below 2^24 (l2's differences and
# ip's products of 0-255 values), float rows everywhere
CASES = [(*shape, integer) for shape in SHAPES for integer in (True, False)
         if not integer or 255 * 255 * shape[2] < 2**24]


@pytest.mark.card
@pytest.mark.parametrize("b,n,d,w,nb,metric,integer", CASES)
def test_block_rescore_kernel_matches_plain_version(card, b, n, d, w, nb, metric, integer):
    q, x, blk = _case(card, b, n, d, w, nb, integer, seed=d + w)
    before = kernels.LAUNCHES["block_rescore"]
    cd, cand = kernels.block_rescore(q, x, blk, n, w, metric)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["block_rescore"] == before + 1
    want_cd, want_cand = kernels.block_rescore_reference(q, x, blk, n, w, metric)
    assert torch.equal(cand, want_cand)
    assert torch.equal(torch.isinf(cd), torch.isinf(want_cd))
    assert int((cand < 0).sum()) > 0  # padding rows were selected
    fin = ~torch.isinf(want_cd)
    if integer:
        assert torch.equal(cd[fin], want_cd[fin])
    else:
        scale = float(want_cd[fin].abs().max())
        assert float((cd - want_cd)[fin].abs().max()) <= 1e-6 * scale


@pytest.mark.card
def test_block_rescore_kernel_on_a_misaligned_payload(card):
    """A payload view one element into its buffer takes single-float loads."""
    q, x, blk = _case(card, 8, 3_001, 128, 32, 6, False, seed=5)
    buf = torch.empty(x.numel() + 1, device=card)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    cd, cand = kernels.block_rescore(q, view, blk, 3_001, 32, "l2")
    want_cd, want_cand = kernels.block_rescore_reference(q, x, blk, 3_001, 32, "l2")
    fin = ~torch.isinf(want_cd)
    assert torch.equal(cand, want_cand)
    assert float((cd - want_cd)[fin].abs().max()) <= 1e-6 * float(want_cd[fin].abs().max())


@pytest.mark.card
@pytest.mark.parametrize("bad", [-1, 126])
def test_block_rescore_kernel_traps_on_an_id_outside_the_blocks(card, bad):
    """An id outside [0, S/w) (S/w = 126 here) is a precondition broken: the
    launch traps and the next synchronisation fails, rather than read
    outside the payload. Run in a child process: a trap ends its context."""
    child = (
        "import torch\n"
        "from vectordb_retrieval_tpu_torch.ops import kernels\n"
        "q, x = torch.ones((4, 64), device='cuda'), torch.ones((1008, 64), device='cuda')\n"
        "blk = torch.zeros((4, 3), dtype=torch.int64, device='cuda')\n"
        f"blk[2, 1] = {bad}\n"
        "kernels.block_rescore(q, x, blk, 1001, 8, 'l2')\n"
        "torch.cuda.synchronize()\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                       timeout=300, cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode != 0 and "Error" in r.stderr
