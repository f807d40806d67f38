"""The trace's reduction: device intervals to busy time and gaps, and the
attribution of kernels to the calls that launched them."""
import pytest

from portbench import harness


def test_union_busy_merges_overlaps_and_lists_gaps():
    busy, gaps = harness._union_busy([(0, 10, "a"), (5, 12, "b"), (20, 25, "c"),
                                      (30, 31, "d")])
    assert busy == 12 + 5 + 1
    assert sorted(gaps) == [(5, "d"), (8, "c")]


def test_attribute_counts_kernels_launched_inside_each_call():
    # (is_device, correlation, start ns, duration ns, name)
    events = [(False, 1, 100, 5, "cudaLaunchKernel"), (True, 1, 500, 40, "k1a"),
              (False, 2, 150, 5, "cuLaunchKernel"), (True, 2, 560, 60, "k1b"),
              (False, 3, 300, 5, "cudaLaunchKernel"), (True, 3, 700, 1000, "other"),
              (False, 4, 410, 5, "cudaLaunchKernel"), (True, 4, 900, 7, "k1c")]
    calls = {"k1": [(90, 200, (1, 8, 8), "torch.float64"),
                    (400, 420, (2, 4, 4), "torch.float64")]}
    out = harness.attribute(events, calls)
    assert out["k1"] == [((1, 8, 8), "torch.float64", pytest.approx(100e-9)),
                         ((2, 4, 4), "torch.float64", pytest.approx(7e-9))]
