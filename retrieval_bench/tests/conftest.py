"""Shared pieces of the benchmark's own tests (run them with
``python -m pytest retrieval_bench/tests -q`` from the repo root)."""

import copy
import re

import pytest
import torch

from retrieval_bench import harness


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips on a host without one)")


@pytest.fixture
def card():
    """Skips the test on a host without a CUDA card (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


def small_cell(name, n=3000, pool=200, batch=64, k=10):
    """Cell ``name`` as its files give it, at a size a CPU test can hold
    (IVF cells on 16 lists, 4 probed)."""
    cell = copy.deepcopy(harness.load_cell(name))
    cell["config"]["n"], cell["config"]["pool"] = n, pool
    cell["workload"]["batch"], cell["workload"]["k"] = batch, k
    wl = cell["workload"]
    if "ivf_build" in wl:
        key = re.sub(r"IVF\d+", "IVF16", wl["ivf_build"]["index_key"])
        wl["ivf_build"].update(index_key=key, nprobe=4)
        wl["algorithm"]["indexer"].update(index_key=key, nprobe=4)
        wl["algorithm"]["searcher"]["nprobe"] = 4
    return cell
