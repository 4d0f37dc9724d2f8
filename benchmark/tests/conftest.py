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
