"""Tests that need the card (marker ``cuda``; they skip without one). On
the card: ``python -m pytest benchmark/tests/test_bench_cuda.py -m cuda
-o addopts=""``.

A short run of a cell is correct; the control, the same run with the
program's TF32 path switched on and its fitness taken at TF32 neighbours,
is not."""
import pytest

pytestmark = pytest.mark.cuda


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")


@pytest.mark.parametrize("workload", ["joint_organized.cam1"])
def test_a_short_run_is_correct_and_its_control_is_not(workload):
    _card()
    from benchmark.control import readings

    sound = readings(workload, [2 ** 31 + 41], 2.0, False)
    control = readings(workload, [2 ** 31 + 41], 2.0, True)
    assert sound[0]["correct"], sound
    assert not control[0]["correct"], control
