"""Shared pieces of the benchmark's own tests (run from the repository root:
``python -m pytest benchmark/tests``)."""
import pytest


@pytest.fixture
def tiny_cell():
    """A cell resolved by name and cut to a size a CPU test run holds: a
    pool of four frames and one warm round (the frames and the bank at full
    size)."""
    from benchmark import cells

    def make(name: str) -> dict:
        cell = cells.resolve(name)
        mix = cell["traffic"]
        mix.update(pool=4, warm_rounds=1)
        return cell

    return make


@pytest.fixture
def cpu_trace(monkeypatch):
    """``benchmark.trace.Trace`` stood in for by the CPU profiler, so that a
    ``--trace 1`` run goes through on the CPU (no device activity: the
    window reads idle throughout)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace

    class CpuTrace(trace.Trace):
        def __init__(self):
            self.prof = profile(activities=[ProfilerActivity.CPU])
            self.t0 = self.t1 = 0

        def start(self):
            self.prof.__enter__()
            self.t0 = time.time_ns()

        def stop(self):
            self.t1 = time.time_ns()
            self.prof.__exit__(None, None, None)

    monkeypatch.setattr(trace, "Trace", CpuTrace)
