"""PyTorch's CPU threads in a run of the test suite.

The suite runs under pytest-xdist with six worker processes on the CPU, and
every worker imports every test module while it collects. PyTorch's default
gives each process one OpenMP thread per core, so six workers run six times
as many threads as there are cores, and the port's tests then spend most of
their time waiting on each other. Importing this module (which collection
does in every worker) sets two threads per process: on an 8-core host the
whole suite (ROADMAP.md's tier-1 command) then took 882 s where it took
1,416 s with the default. A single test file run on its own keeps
PyTorch's default.
"""
import torch

THREADS = 2

torch.set_num_threads(THREADS)


def test_torch_runs_on_two_threads_per_worker():
    assert torch.get_num_threads() == THREADS
