"""On the card (marker `cuda`; skipped without one): a cell through the
harness at its configuration's card test size (`test_rows["card"]`)
comes out correct, and the control (the float32-summed reference in the
program's place, benchmark/control.py) does not.

    python -m pytest benchmark/tests/test_benchmark_card.py -m cuda
"""

import pytest
import torch

from benchmark import harness
from benchmark.control import Control
from benchmark.spec import Cell, load_benchmark
from benchmark.tests.test_benchmark_cells import SEED, sized

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      load_benchmark()["workloads"]])
def test_the_program_is_correct_and_the_control_is_not(card, workload):
    cell = sized(Cell(load_benchmark(), workload), "card")
    ok = harness.run_cell(cell, SEED, 1.0, False, card, 0.0)
    assert ok["correct"], ok["checks"]
    control = harness.run_cell(cell, SEED, 1.0, False, card, 0.0,
                               engine_factory=Control)
    assert not control["correct"]
    assert control["checks"]["mismatched_lines"]["value"] > 0
