"""The correctness comparison fails what it has to fail: the control (the
reference in the program's place at the workload's lower precision) and
each fault a search cell can have, planted where the answers are
produced, while the program passes. Small sizes on the host, with the
limits of the workload files; the card runs are in test_rb_card.py."""

import pytest

from retrieval_bench import control, harness
from retrieval_bench.tests.conftest import small_cell

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
SEED = 2**33 + 1
# rows, pool, batch and k at which a lower precision reaches the k-th answer
SIZE = dict(n=20000, pool=256, batch=256, k=20)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", control.FAULTS)
def test_a_planted_fault_is_not_correct(name, fault):
    out = harness.run(name, SEED, 0.3, False, device="cpu", cell=small_cell(name),
                      factory=control.factory(fault))
    assert out["attempted"] > 0 and not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small_cell(name, **SIZE)
    out = harness.run(name, SEED, 0.3, False, device="cpu", cell=cell,
                      factory=control.factory("control"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct_where_the_control_is_not(name):
    cell = small_cell(name, **SIZE)
    out = harness.run(name, SEED, 0.3, False, device="cpu", cell=cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0 and out["device"]["platform"] == "cpu"
    assert list(out["checks"]) == list(cell["workload"]["limits"])
