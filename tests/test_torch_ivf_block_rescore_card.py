"""``ops/kernels.ivf_block_rescore`` on the card against its plain version.

Needs an NVIDIA card: every test takes the ``card`` fixture, which skips
on a host without one. This file imports nothing of JAX, so that it runs
on the card's machine without the repository's conftest:

    python -m pytest tests/test_torch_ivf_block_rescore_card.py -q --noconftest -p no:cacheprovider

Integer-valued rows (0-255, exact in bf16) make every partial sum an
integer below 2^24, exact in f32 in any order: the kernel must equal the
plain version. On float rows the two sum in another order: within 1e-6 of
the largest score.
"""

import os
import subprocess
import sys

import pytest
import torch

from vectordb_retrieval_tpu_torch.ops import kernels

# (B, S, d, w, nb, metric): sift1m.ivf_flat's shape cut in B; 2, 4 and 8
# rows a warp load (d 128, 64, 32); d % 8 != 0 (single loads); one to four
# 16-byte chunks a lane past 32 chunks; w 8-128
SHAPES = [
    (64, 196_608, 128, 32, 116, "l2"),
    (32, 65_536, 128, 8, 40, "l2"),
    (16, 32_768, 64, 16, 24, "ip"),
    (9, 16_384, 32, 32, 9, "l2"),
    (7, 4_096, 50, 16, 5, "ip"),
    (11, 8_192, 384, 32, 7, "ip"),
    (5, 8_192, 768, 64, 6, "l2"),
    (4, 8_192, 96, 128, 4, "ip"),
]


@pytest.fixture
def card():
    """Skips the test on a host without a CUDA card (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


def _case(dev, b, s, d, w, nb, integer, seed):
    """bf16 lists with a tenth of the slots dead, block ids with repeats
    across queries, and a few pairs never probed (+inf minima)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape):
        if integer:
            return torch.randint(0, 256, shape, generator=gen, device=dev).float()
        return torch.randn(shape, generator=gen, device=dev)

    payload = draw(s, d).to(torch.bfloat16)
    slots = torch.randperm(s, generator=gen, device=dev).to(torch.int32)
    slots[torch.rand(s, generator=gen, device=dev) < 0.1] = -1
    blk = torch.randint(0, s // w, (b, nb), generator=gen, device=dev)
    blk[1:, 0] = blk[0, 0]  # one block shared by every query
    vals = torch.rand((b, nb), generator=gen, device=dev)
    vals[torch.rand((b, nb), generator=gen, device=dev) < 0.1] = float("inf")
    return draw(b, d), payload, slots, blk, vals


CASES = [(*shape, integer) for shape in SHAPES for integer in (True, False)
         if not integer or 255 * 255 * shape[2] < 2**24]


@pytest.mark.card
@pytest.mark.parametrize("b,s,d,w,nb,metric,integer", CASES)
def test_ivf_block_rescore_kernel_matches_plain_version(card, b, s, d, w, nb, metric, integer):
    q, x, slots, blk, vals = _case(card, b, s, d, w, nb, integer, seed=d + w)
    before = kernels.LAUNCHES["ivf_block_rescore"]
    cd, cand = kernels.ivf_block_rescore(q, x, slots, blk, vals, w, metric)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ivf_block_rescore"] == before + 1
    want_cd, want_cand = kernels.ivf_block_rescore_reference(q, x, slots, blk, vals, w, metric)
    assert torch.equal(cand, want_cand)
    assert torch.equal(torch.isinf(cd), torch.isinf(want_cd))
    assert int((cand < 0).sum()) > 0  # dead slots and unprobed pairs were selected
    fin = ~torch.isinf(want_cd)
    if integer:
        assert torch.equal(cd[fin], want_cd[fin])
    else:
        scale = float(want_cd[fin].abs().max())
        assert float((cd - want_cd)[fin].abs().max()) <= 1e-6 * scale


@pytest.mark.card
def test_ivf_block_rescore_kernel_on_a_misaligned_payload(card):
    """A payload view one element into its buffer takes single loads."""
    q, x, slots, blk, vals = _case(card, 8, 4_096, 128, 32, 6, False, seed=5)
    buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=card)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    cd, cand = kernels.ivf_block_rescore(q, view, slots, blk, vals, 32, "l2")
    want_cd, want_cand = kernels.ivf_block_rescore_reference(q, x, slots, blk, vals, 32, "l2")
    fin = ~torch.isinf(want_cd)
    assert torch.equal(cand, want_cand)
    assert torch.equal(torch.isinf(cd), torch.isinf(want_cd))
    assert float((cd - want_cd)[fin].abs().max()) <= 1e-6 * float(want_cd[fin].abs().max())


@pytest.mark.card
@pytest.mark.parametrize("bad", [-1, 128])
def test_ivf_block_rescore_kernel_traps_on_an_id_outside_the_blocks(card, bad):
    """An id outside [0, S/w) (S/w = 128 here) traps the launch; the next
    synchronisation fails. Run in a child process: a trap ends its
    context."""
    child = (
        "import torch\n"
        "from vectordb_retrieval_tpu_torch.ops import kernels\n"
        "q = torch.ones((4, 64), device='cuda')\n"
        "x = torch.ones((1024, 64), device='cuda', dtype=torch.bfloat16)\n"
        "slots = torch.arange(1024, device='cuda', dtype=torch.int32)\n"
        "blk = torch.zeros((4, 3), dtype=torch.int64, device='cuda')\n"
        "vals = torch.zeros((4, 3), device='cuda')\n"
        f"blk[2, 1] = {bad}\n"
        "kernels.ivf_block_rescore(q, x, slots, blk, vals, 8, 'l2')\n"
        "torch.cuda.synchronize()\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                       timeout=300, cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode != 0 and "Error" in r.stderr
