"""The readings of the program's spans (``benchmark/spans.py``): per frame
from synthetic records, None without spans; the idle gaps of a synthetic
window split by the innermost span open over them, their total the window
less busy time, unspanned pieces named by the call that ended them; and a
whole spanned run of a cell at tiny size on the CPU, its device trace
stood in for by the CPU profiler (no device activity: the window is idle
throughout)."""
import pytest

from benchmark import spans as bspans
from tpu_joints_torch.core.spans import Record


def _frame(t0, request, device=True):
    """One served frame's records from ``t0`` (ns): 100 µs long, its
    children 10 µs each, and 1 µs of each of the four stages on the
    device."""
    frame = Record("serve.frame", t0, t0 + 100_000, None, request, 1)
    out = [frame]
    names = ["serve.unproject", "serve.queue", "serve.upload",
             "serve.upload", "graphs.replay", "serve.to_host",
             "serve.payload"]
    for i, name in enumerate(names):
        a = t0 + 10_000 * i
        out.append(Record(name, a, a + 10_000, frame, request, 1))
    replay = out[5]
    if device:
        out += [Record(n, 1_000 * i, 1_000 * (i + 1), replay, request, 1,
                       "device") for i, n in enumerate(bspans.STAGES.values())]
    return out


def test_readings_per_frame():
    records = _frame(0, 1) + _frame(1_000_000, 2)
    trace = dict(window_s=2.0, idle_unspanned_s=0.5)
    got = bspans.readings(dict(spans=records, trace=trace))
    assert set(got) == set(bspans.HOST) | set(bspans.STAGES) | {
        "device.idle_unspanned_pct"}
    assert got["serve.upload_ms"] == pytest.approx(0.02)     # two a frame
    for k in set(bspans.HOST) - {"serve.upload_ms"}:
        assert got[k] == pytest.approx(0.01)
    for k in bspans.STAGES:
        assert got[k] == pytest.approx(0.001)
    assert got["device.idle_unspanned_pct"] == pytest.approx(25.0)
    assert bspans.readings(dict(spans=_frame(0, 1, device=False), trace=trace))[
        "chain.refine_device_ms"] is None


@pytest.mark.parametrize("ctx", [{}, dict(spans=None, trace=None),
                                 dict(spans=[], trace=dict(
                                     window_s=1.0, busy_s=0.5))])
def test_readings_without_spans_are_none(ctx):
    assert all(v is None for v in bspans.readings(ctx).values())


def test_gaps_split_by_the_innermost_span():
    """Window [0, 100): device busy [10, 20) and [60, 70); spans outer
    [5, 50) holding inner [15, 40), and a lone span [65, 80) on another
    thread. Idle: [0, 10) → 5 unspanned ("until_a") + 5 outer; [20, 60) →
    20 inner, 10 outer, 10 unspanned ("until_b"); [70, 100) → 10 lone, 20
    unspanned ("window_end")."""
    device = [(60, 70, 2), (10, 20, 1)]
    launcher = {1: "a", 2: "b"}
    host = [(5, 50, "outer"), (15, 40, "inner"), (65, 80, "lone")]
    gaps, unspanned = bspans.split_gaps(device, launcher, 0, 100, host)
    ns = {k: round(v * 1e9) for k, v in gaps.items()}
    assert ns == {"until_a": 5, "outer": 15, "inner": 20, "until_b": 10,
                  "lone": 10, "window_end": 20}
    assert sum(ns.values()) == 100 - 20                 # window less busy
    assert round(unspanned * 1e9) == 35


def test_gaps_without_spans_keep_the_calls_names():
    device = [(10, 30, 7), (20, 40, 8), (50, 60, 9)]
    gaps, unspanned = bspans.split_gaps(
        device, {7: "cudaGraphLaunch", 9: "cudaMemcpyAsync"}, 0, 70, [])
    ns = {k: round(v * 1e9) for k, v in gaps.items()}
    assert ns == {"until_cudaGraphLaunch": 10, "until_cudaMemcpyAsync": 10,
                  "window_end": 10}
    assert round(unspanned * 1e9) == 30


def test_innermost_of_two_spans_that_start_together():
    assert bspans._innermost([(0, 10, "outer"), (0, 4, "inner")]) == [
        (0, 4, "inner"), (4, 10, "outer")]


def test_a_spanned_run_on_the_cpu(tiny_cell, cpu_trace, monkeypatch):
    """The whole run (set-up, both windows, the check) at tiny size, the
    profiler on the CPU only: every host reading is read, no stage is (the
    chain is eager on the CPU: its stages are host spans), the card idles
    all window and every idle second is named by a span or unspanned; with
    spans off nothing is read."""
    import torch

    from benchmark import cells

    cell = tiny_cell("joint_organized.cam1")
    cell["config"]["bank"].update(level=0, resolution=64)
    cell["traffic"].update(pool=2)
    monkeypatch.setattr(cells, "resolve", lambda name: cell)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    on = bspans.run_spanned("joint_organized.cam1", 2 ** 31 + 5, 1.0,
                            device="cpu")
    for k in bspans.HOST:
        if k != "chain.host_ms":            # no replay on the CPU
            assert on["spans"][k] > 0, k
    assert on["spans"]["chain.host_ms"] is None
    assert all(on["spans"][k] is None for k in bspans.STAGES)
    c = on["checks"]
    assert c["idle_s"] == pytest.approx(c["window_s"])
    assert 0 <= on["spans"]["device.idle_unspanned_pct"] < 100
    assert 0 < c["frame_self_share"] < 1
    assert [g[0] for g in on["line"]["breakdown"]["idle_gaps"]]
    off = bspans.run_spanned("joint_organized.cam1", 2 ** 31 + 5, 1.0,
                             on=False, device="cpu")
    assert all(v is None for v in off["spans"].values())
