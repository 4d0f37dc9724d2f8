"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m benchmark.run --workload <config>.<mix> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

The system under test is ``tpu_joints_torch``'s detection service,
``serve.server.DetectionService``, driven in process: cameras (threads) hand
depth frames to ``detect_depth``; no HTTP. Set-up makes the frames on the
card from the seed, builds the bank, builds the service with the mix's
batching and runs ``warmup`` (which captures the graphs of this cell's
shapes), then runs every batch size and the loop once more with the real
frames. The window then runs for ``--seconds``. Afterwards the program's
state is freed and the reference judges the replies
(``benchmark/reference/check.py``).

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
taken on the host's clock; with ``--trace 1`` they are the per-layer ones,
each read by its own ``benchmark/metrics/<name>.py``: the host-clock
readers from a window run as with ``--trace 0``, the device readers from a
second window of the same length under the profiler. The last line of
standard output is the result as JSON; the last lines of standard error
are the numbers the correctness check compared, each beside its limit. Without a card, or with
fewer cards than the cell asks for, it prints no result and exits 2; with
``jax``, ``jaxlib``, ``flax`` or ``tpu_joints`` loaded after the window, 3.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
_CACHE = _ROOT / "benchmark" / ".cache"
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "nv")

FOREIGN = ("jax", "jaxlib", "flax", "tpu_joints")
CHECK_SAMPLE = 256          # replies held to the reference numbers


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def foreign_modules() -> list:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FOREIGN))


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def _graph_count() -> int:
    from tpu_joints_torch.core import graphs

    return sum(len(e.graphs) for e in graphs.entries())


def _warm(service, frames, mix: dict, fov: float) -> None:
    """The cell's own traffic before the window: every batch size once with
    real frames (a growing's second graph is captured at its first need),
    then every camera ``warm_rounds`` frames."""
    from benchmark.traffic import run_load

    def call(depth):
        return service.detect_depth(depth, fov_deg=fov)

    for b in range(int(mix["batch_max"]), 0, -1):
        run_load(call, frames[:b], b, 0.0, frames_per_camera=1)
    run_load(call, frames, int(mix["cameras"]), 0.0,
             frames_per_camera=int(mix["warm_rounds"]))


def passes(reply: dict, true_pose, gate: dict) -> bool:
    """A reply that came and that the gate lets through: an honest
    rejection, or an accepted pose within the gate's errors."""
    from benchmark.reference.check import rot_trans_err

    if reply is None:
        return False
    if not reply["accepted"]:
        return True
    rot, trans = rot_trans_err(reply["pose"], true_pose)
    return rot <= gate["rot_deg"] and trans <= gate["trans_mm"]


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False) -> tuple:
    """Set up, run the window and judge it. Returns (the result line, with
    the compared numbers under ``"compared"``, last; notes on the run for
    standard error). With ``trace`` a second window of the same length
    follows the first under the profiler: the host-clock readers read the
    first, the device readers the second. ``control`` judges the control
    (``benchmark/control.py``) in the program's place."""
    import torch

    from benchmark import frames as frames_mod
    from benchmark.reference import check, joint
    from benchmark.traffic import run_load
    from tpu_joints_torch.config import DetectionConfig
    from tpu_joints_torch.core import graphs
    from tpu_joints_torch.modelbank.bank import build_bank
    from tpu_joints_torch.serve.server import DetectionService

    on_card = torch.device(device).type == "cuda"
    marks = dict(imported=process_age_s())

    def sync():
        if on_card:
            torch.cuda.synchronize()

    config, mix = cell["config"], cell["traffic"]
    det = DetectionConfig(**config["detection"])
    scene = frames_mod.Scene(config)
    pool = frames_mod.make_pool(scene, int(mix["pool"]), seed, device)
    frames = list(pool["depth"])
    fov = scene.fov_deg
    marks.update(frames=process_age_s())

    t = time.perf_counter()
    recipe = dict(config["bank"])
    model = joint.joint_model(recipe.pop("model"))
    bank = build_bank(model, device=device, **recipe)
    sync()
    bank_s = time.perf_counter() - t

    t = time.perf_counter()
    service = DetectionService(
        bank, det, batch_max=int(mix["batch_max"]),
        batch_window_ms=float(mix["batch_window_ms"]),
        max_pending=int(mix["max_pending"]))
    service.warmup(depth_shape=(scene.height, scene.width), fov_deg=fov)
    sync()
    warm_s = time.perf_counter() - t
    marks.update(warmup=process_age_s())
    _warm(service, frames, mix, fov)
    sync()
    marks.update(warm_traffic=process_age_s())

    def call(depth):
        return service.detect_depth(depth, fov_deg=fov)

    def counters():
        return dict(batches=service.n_batches,
                    batched_frames=service.n_batched_frames)

    captured = _graph_count() if on_card else 0
    cameras = int(mix["cameras"])
    before = counters()
    setup_s = process_age_s()
    load = run_load(call, frames, cameras, seconds)
    after = counters()
    traced = summary = None
    if trace:
        from benchmark.trace import Trace

        tracer = Trace()
        tracer.start()
        traced = run_load(call, frames, cameras, seconds)
        tracer.stop()
        t = time.perf_counter()
        summary = tracer.summary()
        marks.update(trace_read_s=time.perf_counter() - t)
    captured_in_window = (_graph_count() - captured) if on_card else 0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name() if on_card else "cpu"

    # the program's state goes before the reference runs
    del service, bank, call
    graphs.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    records = load["records"] + (traced["records"] if traced else [])
    gate = config["gate"]
    for r in records:
        r["passed"] = passes(r["reply"], pool["pose"], gate)
    window = [r for r in load["records"] if r["t_done"] <= load["t_end"]]
    lat = [1000.0 * (r["t_done"] - r["t_start"]) for r in window]
    t = time.perf_counter()
    ref = check.Reference(config, pool, device)
    verdict = check.judge_window(ref, records, seed, config["limits"],
                                 CHECK_SAMPLE, control=control)
    reference_s = time.perf_counter() - t
    line = dict(correct=verdict["correct"], attempted=len(records),
                failed=sum(not r["passed"] for r in records))
    device_info = dict(platform="gpu" if on_card else "cpu", kind=kind,
                       count=1, memory_peak_bytes=int(peak))
    if trace:
        ctx = dict(window=window, traced=traced["records"], seconds=seconds,
                   trace=summary,
                   counters={k: after[k] - before[k] for k in after},
                   setup=dict(bank_s=bank_s, warm_s=warm_s), config=config,
                   traffic=mix)
        metrics = {}
        for m in cell["per_layer"]:
            from benchmark.cells import reader

            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
        line.update(metrics=metrics, device=device_info,
                    breakdown=dict(device_ops=summary["device_ops"],
                                   idle_gaps=summary["idle_gaps"]))
    else:
        e2e = dict(setup_s=setup_s,
                   frames_per_s=sum(r["passed"] for r in window) / seconds)
        if lat:
            e2e.update(latency_p50_ms=statistics.median(lat))
        line.update(metrics={m["name"]: dict(value=e2e[m["name"]],
                                             unit=m["unit"])
                             for m in cell["end_to_end"] if m["name"] in e2e},
                    device=device_info)
    errors = sorted({r["error"] for r in records if r["error"]})
    notes = dict(captured_in_window=captured_in_window,
                 latency_p95_ms=percentile(lat, 95.0) if lat else None,
                 judged=verdict["judged"], errors=errors[:3],
                 window_frames=len(window), setup_marks_s=marks,
                 bank_s=bank_s, warm_s=warm_s, reference_s=reference_s)
    line["compared"] = {k: dict(value=v, limit=lim)
                        for k, (v, lim) in verdict["numbers"].items()}
    return line, notes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import cells

    cell = cells.resolve(args.workload)
    chips = int(cell["workload"]["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}; no result",
              file=sys.stderr)
        return 2
    line, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = foreign_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(f"notes {json.dumps(notes)}", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
