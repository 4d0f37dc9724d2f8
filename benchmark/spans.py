"""The program's own spans over one cell: where a frame's time goes, layer
by layer, and what the device trace's idle stretches were waiting on.

    python3 -m benchmark.spans --workload <config>.<mix> --seed <n> \\
        --seconds <s> [--spans 0|1]

Runs the cell as ``benchmark.run --trace 1`` does (``run.run_cell``: set-up,
a window, a second window under the profiler, the reference's check), with
the program's spans (``tpu_joints_torch/core/spans.py``) turned on before
set-up, so that the warm-up captures the graphs that time their stages;
``--spans 0`` makes the same run with them off, which gives their cost.
Prints one JSON line: the run's result line, ``spans`` (the readings
below), ``checks`` (how the readings add up against the round trip and the
profiler's busy time) and the run's notes.

The readings, each per frame (a ``serve.frame`` span with no parent), from
the first window's records:

* host, ms: ``serve.unproject_ms``, ``serve.upload_ms``, ``chain.host_ms``
  (``graphs.replay``), ``serve.device_wait_ms`` (``serve.to_host``),
  ``serve.reply_ms`` (``serve.payload``);
* device, ms of the card's clock: ``chain.ingest_device_ms``,
  ``chain.features_device_ms``, ``chain.match_device_ms``,
  ``chain.refine_device_ms``;

and from the profiled window, ``device.idle_unspanned_pct``: the share of
the window in which the card was idle and no span of the program was open.
With spans off, or on a program without ``core/spans.py``, every reading is
None. In the profiled window each idle stretch is split by the innermost
span open over it and each piece named after that span (``split_gaps``);
a piece with no span open keeps the name of the call that ended the
stretch, as ``benchmark/trace.py`` names it.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

HOST = {"serve.unproject_ms": "serve.unproject",
        "serve.upload_ms": "serve.upload",
        "chain.host_ms": "graphs.replay",
        "serve.device_wait_ms": "serve.to_host",
        "serve.reply_ms": "serve.payload"}
STAGES = {"chain.ingest_device_ms": "chain.ingest",
          "chain.features_device_ms": "chain.features",
          "chain.match_device_ms": "chain.match",
          "chain.refine_device_ms": "chain.refine"}


def program_spans():
    """The program's span recorder, or None where the program has none."""
    try:
        return importlib.import_module("tpu_joints_torch.core.spans")
    except ImportError:
        return None


def per_frame_ms(records, name: str, clock: str = "host") -> Optional[float]:
    """The ms of the spans ``name`` (on ``clock``) per served frame, or None
    where there is no frame or no such span."""
    frames = sum(r.name == "serve.frame" and r.parent is None
                 for r in records)
    ns = [r.end_ns - r.start_ns for r in records
          if r.name == name and r.clock == clock]
    if not frames or not ns:
        return None
    return sum(ns) / frames / 1e6


def readings(ctx: dict) -> Dict[str, Optional[float]]:
    """Every reading of the module docstring from ``ctx``: ``spans``, the
    first window's records (or None), and ``trace``, the profiled window's
    summary (``idle_unspanned_s`` where spans were split)."""
    records = ctx.get("spans") or []
    out = {k: per_frame_ms(records, v) for k, v in HOST.items()}
    out.update({k: per_frame_ms(records, v, "device")
                for k, v in STAGES.items()})
    t = ctx.get("trace") or {}
    unspanned = t.get("idle_unspanned_s")
    out["device.idle_unspanned_pct"] = (
        100.0 * unspanned / t["window_s"]
        if records and unspanned is not None and t.get("window_s") else None)
    return out


def _innermost(host: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """Host spans (start, end, name), of any threads, as disjoint pieces
    (start, end, name) of the innermost span open over each: the open one
    that started last (of two that started together, the one that ends
    first)."""
    events = sorted({t for a, b, _ in host for t in (a, b)})
    starts = sorted(host)
    active: list = []
    out, i = [], 0
    for x, y in zip(events, events[1:]):
        while i < len(starts) and starts[i][0] <= x:
            active.append(starts[i])
            i += 1
        active = [s for s in active if s[1] > x]
        if active:
            a, b, name = max(active, key=lambda s: (s[0], -s[1]))
            if out and out[-1][1] == x and out[-1][2] == name:
                out[-1] = (out[-1][0], y, name)
            else:
                out.append((x, y, name))
    return out


def split_gaps(device: List[Tuple[int, int, int]], launcher: Dict[int, str],
               t0: int, t1: int, host: List[Tuple[int, int, str]]):
    """The idle stretches of the window [t0, t1) between the device
    intervals ``device`` ((start, end, correlation id), in ns), each split
    by the innermost host span open over it (``host``: (start, end, name),
    in ns of the same clock). Returns (seconds by name, seconds idle with
    no span open). A piece with no span open is named as
    ``benchmark/trace.py`` names the whole stretch: ``until_<the call that
    launched the activity ending it>``, or ``window_end``."""
    pieces = _innermost(host)
    gaps: Dict[str, float] = defaultdict(float)
    unspanned = 0.0
    j = 0

    def idle(a, b, label):
        nonlocal j, unspanned
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k, at = j, a
        while k < len(pieces) and pieces[k][0] < b:
            pa, pb, name = pieces[k]
            if pa > at:
                gaps[label] += (pa - at) * 1e-9
                unspanned += (pa - at) * 1e-9
            lo, hi = max(pa, at), min(pb, b)
            gaps[name] += (hi - lo) * 1e-9
            at = hi
            k += 1
        if b > at:
            gaps[label] += (b - at) * 1e-9
            unspanned += (b - at) * 1e-9

    edge = t0
    for a, b, corr in sorted(device):
        if a > edge:
            idle(edge, a, "until_" + launcher.get(corr, "unknown"))
        edge = max(edge, b)
    if t1 > edge:
        idle(edge, t1, "window_end")
    return dict(gaps), unspanned


def device_intervals(prof, t0: int, t1: int):
    """(device intervals (start, end, correlation id) clipped to [t0, t1),
    the launching call's name by correlation id) of a finished
    ``torch.profiler`` run, as ``benchmark/trace.py`` reads them."""
    import torch

    launcher, device = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            a = max(e.start_ns(), t0)
            b = min(e.start_ns() + e.duration_ns(), t1)
            if b > a:
                device.append((a, b, e.correlation_id()))
        elif e.name().startswith("cuda"):
            launcher[e.correlation_id()] = e.name()
    return device, launcher


def _top(d: dict) -> list:
    return [[k[:96], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
            [:10]]


def run_spanned(workload: str, seed: int, seconds: float, on: bool = True,
                device: str = "cuda") -> dict:
    """One run of the cell (module docstring): dict(line, spans, checks,
    notes)."""
    from benchmark import cells, run, trace, traffic

    cell = cells.resolve(workload)
    rec = program_spans()
    windows: List[dict] = []
    real_run_load, real_trace = traffic.run_load, trace.Trace

    def run_load(*args, **kwargs):
        if rec is not None:
            rec.drain()
        out = real_run_load(*args, **kwargs)
        out["spans"] = rec.drain() if rec is not None else []
        windows.append(out)
        return out

    class SplitTrace(real_trace):
        """``benchmark/trace.py``'s trace, its idle gaps split by span."""

        def summary(self):
            out = super().summary()
            host = [(r.start_ns, r.end_ns, r.name) for r in windows[-1]["spans"]
                    if r.clock == "host"]
            dev, launcher = device_intervals(self.prof, self.t0, self.t1)
            gaps, unspanned = split_gaps(dev, launcher, self.t0, self.t1, host)
            out.update(idle_gaps_by_call=out["idle_gaps"], idle_gaps=_top(gaps),
                       idle_s=sum(gaps.values()), idle_unspanned_s=unspanned)
            summaries.append(out)
            return out

    summaries: List[dict] = []
    if on and rec is not None:
        rec.enable(True)
    # run_cell looks both up when it runs: each window hands over its
    # records, and the profiled one's gaps are split by them
    traffic.run_load, trace.Trace = run_load, SplitTrace
    try:
        line, notes = run.run_cell(cell, seed, seconds, True, device=device)
    finally:
        traffic.run_load, trace.Trace = real_run_load, real_trace
        if rec is not None:
            rec.enable(False)
    first, traced = windows[-2:]    # the profiled window last
    values = readings(dict(spans=first["spans"], trace=summaries[-1]))
    return dict(line=line, spans=values,
                checks=checks(values, first, traced, line, summaries[-1], rec),
                notes=notes)


def checks(values: dict, first: dict, traced: dict, line: dict,
           summary: dict, rec) -> dict:
    """How the readings add up: the five host readings against the first
    window's mean round trip, ``serve.frame``'s self time against its
    duration (``rec``, the program's recorder, computes it), the four stages
    against the profiler's busy time per frame (the first window's stages,
    and the profiled window's own, which timed the frames the profiler
    saw), the split idle time against the window less busy time."""
    records = first["spans"]
    replied = [r for r in first["records"] if r["reply"] is not None]
    lat = [1000.0 * (r["t_done"] - r["t_start"]) for r in first["records"]
           if r["t_done"] <= first["t_end"]]
    out = dict(latency_p50_ms=statistics.median(lat) if lat else None,
               round_trip_mean_ms=statistics.fmean(
                   1000.0 * (r["t_done"] - r["t_start"]) for r in replied)
               if replied else None,
               queue_ms=per_frame_ms(records, "serve.queue"),
               window_s=summary["window_s"],
               window_less_busy_s=summary["window_s"] - summary["busy_s"],
               idle_s=summary["idle_s"])
    host = [values[k] for k in HOST]
    if None not in host and out["round_trip_mean_ms"]:
        out.update(host_sum_ms=sum(host),
                   host_sum_share=sum(host) / out["round_trip_mean_ms"])
    frames = [r for r in records if r.name == "serve.frame" and r.parent is None]
    if frames:
        out["frame_self_share"] = (sum(rec.self_ns(r, records) for r in frames)
                                   / sum(r.end_ns - r.start_ns for r in frames))
    busy = line["metrics"].get("chain.device_ms_per_frame", {}).get("value")
    for key, stages in (("stage_sum", [values[k] for k in STAGES]),
                        ("stage_sum_traced", [
                            per_frame_ms(traced["spans"], v, "device")
                            for v in STAGES.values()])):
        if None not in stages and busy:
            out.update({key + "_ms": sum(stages),
                        key + "_share": sum(stages) / busy})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    out = run_spanned(args.workload, args.seed, args.seconds, bool(args.spans))
    print(json.dumps(dict(workload=args.workload, seed=args.seed,
                          spans_on=bool(args.spans), **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
