"""On the card (marker `cuda`; skipped without one): a cell through the
harness at its configuration's card test size (`test_rows["card"]`)
comes out correct, and the control (the cell's reference, float32-summed,
in the program's place, benchmark/control.py) does not; a profiled
window of the program's csrc kernels gives each its device seconds.

    python -m pytest benchmark/tests/test_benchmark_card.py -m cuda
"""

import pytest
import torch

from benchmark import harness
from benchmark.capture import reduce_capture
from benchmark.control import control
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
    controlled = harness.run_cell(cell, SEED, 1.0, False, card, 0.0,
                                  engine_factory=control(cell))
    assert not controlled["correct"]
    assert controlled["checks"]["mismatched_lines"]["value"] > 0


def test_the_capture_times_each_csrc_kernel(card):
    """Each of kernels.LAUNCHES' keys, launched three times in a profiled
    window (both bincount kernels: shared-memory bins and the hot-bin
    cache), reads device seconds above 0 in `csrc_s`, and the capture
    counts as many csrc kernels as the program counted launches."""
    from torch.profiler import ProfilerActivity, profile

    from radixhashjoin_tpu_torch import kernels
    gen = torch.Generator(device=card).manual_seed(SEED)
    n, bins = 1 << 22, 1 << 20
    keys = torch.randint(0, bins, (n,), generator=gen, device=card,
                         dtype=torch.int32)
    ones = torch.ones_like(keys)
    table = torch.arange(bins, dtype=torch.int32, device=card)
    pairs = torch.stack((table, table), 1)
    digits = keys % 257

    def launch_each():
        kernels.weighted_bincount_cuda(keys, ones, bins)
        kernels.weighted_bincount_cuda(digits, ones, 257)
        kernels.table_gather_cuda(table, keys)
        kernels.table_gather2_cuda(pairs, keys)
        kernels.radix_histogram_cuda(keys, n, 256)
        kernels.rank_hist_cuda(digits, 256)

    launch_each()                        # builds and loads the libraries
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(harness.WINDOW_SPAN):
            for _ in range(3):
                launch_each()
            torch.cuda.synchronize()
    made = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    cap = reduce_capture(prof, harness.WINDOW_SPAN)
    assert made == {"bincount": 6, "gather": 3, "gather2": 3,
                    "radix_hist": 3, "rank_hist": 3}
    assert cap["csrc_kernels"] == sum(made.values())
    assert set(cap["csrc_s"]) == set(kernels.LAUNCHES)
    assert all(v > 0 for v in cap["csrc_s"].values()), cap["csrc_s"]
    assert sum(cap["csrc_s"].values()) <= cap["busy_s"]
