"""The device trace of a traced run: ``torch.profiler`` (CUPTI) over the
window, reduced to what the per-layer readers and the result line need.

Busy time is the union of every device activity (kernels, copies, sets)
inside the window; idle gaps are the stretches between, each named by the
host call that launched the activity ending it (``until_cudaGraphLaunch``:
the host had not yet launched the next graph). Kernels are summed by name.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

K1_NAME = "knn_split_kernel<1>"


class Trace:
    """Profile the device from ``start()`` to ``stop()``; then ``summary``."""

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = 0

    def start(self):
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.time_ns()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        """dict(window_s, busy_s, k1_s, device_ops [[name, s]] top 10,
        idle_gaps [[label, s]] top 10)."""
        events = self.prof.profiler.kineto_results.events()
        launcher: Dict[int, str] = {}
        device: List[Tuple[int, int, str, int]] = []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.name(), e.correlation_id()))
            elif e.name().startswith("cuda"):
                launcher[e.correlation_id()] = e.name()
        kernels: Dict[str, float] = defaultdict(float)
        spans = []
        for a, b, name, corr in device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            kernels[name] += (b - a) * 1e-9
            spans.append((a, b, corr))
        spans.sort()
        busy = 0
        gaps: Dict[str, float] = defaultdict(float)
        edge = self.t0
        for a, b, corr in spans:
            if a > edge:
                gaps["until_" + launcher.get(corr, "unknown")] += (a - edge) * 1e-9
            if b > edge:
                busy += b - max(a, edge)
                edge = b
        if self.t1 > edge:
            gaps["window_end"] += (self.t1 - edge) * 1e-9

        def top(d):
            return [[k[:96], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return dict(window_s=(self.t1 - self.t0) * 1e-9, busy_s=busy * 1e-9,
                    k1_s=sum(v for k, v in kernels.items() if K1_NAME in k),
                    device_ops=top(kernels), idle_gaps=top(gaps))
