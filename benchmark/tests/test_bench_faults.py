"""The correctness check fails a run whose timed path is broken
underneath. Each test drives a small cell on the CPU (the harness's whole
path minus its look for a card) with one fault planted in the program:

* a step that returns its state unchanged — the captured chain hands back
  its first result for every later frame, as a replay whose outputs were
  never refreshed would;
* an answer altered where it is produced — the final ICP's poses moved by
  2 mm as it returns them, before the chain composes the view pose and
  the box from them;
* a kernel K1 that returns a wrong near neighbour — every search of the
  refinement blind to one source point in seven.

Half of a batch left out and the exchange between chips are not faults a
cell of one frame at a time on one card can have. Each test names the
number that catches its fault and holds the unbroken run of the same cell
within every limit but the accepted share: a CPU run holds one to four
frames, and a share over so few frames says nothing."""
import functools
import importlib

import pytest

from benchmark import run
from tpu_joints_torch.core import graphs

detect_mod = importlib.import_module("tpu_joints_torch.pipelines.detect")
icp_mod = importlib.import_module("tpu_joints_torch.recognize.icp")
SEED = 2 ** 31 + 21
CELLS = ["joint_organized.cam1"]


def _run(cell):
    line, _ = run.run_cell(cell, SEED, 1.0, False, device="cpu")
    return line


def _over(line, number):
    c = line["compared"][number]
    return c["value"] > c["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_the_unbroken_cell_keeps_its_limits(tiny_cell, name):
    line = _run(tiny_cell(name))
    over = [k for k in line["compared"] if _over(line, k)]
    assert over in ([], ["rejected_share"]), line["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_a_chain_that_returns_its_state_unchanged(tiny_cell, monkeypatch,
                                                  name):
    real, first = graphs.run, {}

    def stale(entry, fn, args, static, keep):
        key = graphs.cache_key(entry, args, static, keep)
        if key not in first:
            first[key] = real(entry, fn, args, static, keep)
        return first[key]

    monkeypatch.setattr(graphs, "run", stale)
    line = _run(tiny_cell(name))
    assert not line["correct"] and _over(line, "ws_gap"), line["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_a_pose_altered_where_it_is_produced(tiny_cell, monkeypatch, name):
    real = detect_mod.icp_multi
    final_rows = tiny_cell(name)["config"]["bank"]["icp_capacity"]

    def moved(src_xyz, *a, **kw):
        T, fit = real(src_xyz, *a, **kw)
        if src_xyz.shape[1] == final_rows:
            T = T.clone()
            T[:, 0, 3] += 0.002
        return T, fit

    monkeypatch.setattr(detect_mod, "icp_multi", moved)
    line = _run(tiny_cell(name))
    assert not line["correct"] and _over(line, "fit_gap"), line["compared"]
    assert not _over(line, "view_gap"), line["compared"]


def _blind(search):
    @functools.wraps(search)
    def wrapped(query, source, k, source_mask=None, **kw):
        if source_mask is not None:
            source_mask = source_mask.clone()
            source_mask[..., ::7] = False
        return search(query, source, k, source_mask=source_mask, **kw)
    return wrapped


@pytest.mark.parametrize("name", CELLS)
def test_a_k1_that_returns_a_wrong_neighbour(tiny_cell, monkeypatch, name):
    monkeypatch.setattr(icp_mod, "knn", _blind(icp_mod.knn))
    monkeypatch.setattr(icp_mod, "knn_batched", _blind(icp_mod.knn_batched))
    line = _run(tiny_cell(name))
    assert not line["correct"] and _over(line, "fit_gap"), line["compared"]
