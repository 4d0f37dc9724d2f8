"""The one load generator: cameras that hand depth frames to the service.

A mix (``benchmark/traffic/<mix>.json``) sets the number of cameras and the
service's batching. The loop is closed: each camera is a thread that sends
its next frame when its reply has arrived. Camera ``c`` starts at pool
entry ``c`` and steps through the pool. The frames are made before the
window; in it the generator only hands them over.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Sequence


def run_load(call: Callable, frames: Sequence, cameras: int, seconds: float,
             frames_per_camera: int = 0) -> dict:
    """Drive ``call(frame)`` from ``cameras`` threads for ``seconds`` (or,
    with ``frames_per_camera``, until each camera has sent that many).

    Returns dict(t0, t_end, records): every request sent, as
    dict(camera, index, t_start, t_done, reply, error). A request that
    raises records its error and no reply."""
    n = len(frames)
    records: List[list] = [[] for _ in range(cameras)]
    go = threading.Event()
    clock = {}

    def camera(c: int):
        go.wait()
        t_end = clock["t_end"]
        k = 0
        while not frames_per_camera or k < frames_per_camera:
            t_start = time.perf_counter()
            if t_start >= t_end:
                break
            index = (c + k) % n
            reply = error = None
            try:
                reply = call(frames[index])
            except Exception as e:  # noqa: BLE001 — a failed request is counted
                error = f"{type(e).__name__}: {e}"
            records[c].append(dict(camera=c, index=index, t_start=t_start,
                                   t_done=time.perf_counter(), reply=reply,
                                   error=error))
            k += 1

    threads = [threading.Thread(target=camera, args=(c,), daemon=True)
               for c in range(cameras)]
    for t in threads:
        t.start()
    clock["t0"] = time.perf_counter()
    clock["t_end"] = (clock["t0"] + seconds) if not frames_per_camera \
        else float("inf")
    go.set()
    for t in threads:
        t.join()
    out = sorted((r for rs in records for r in rs), key=lambda r: r["t_done"])
    return dict(t0=clock["t0"], t_end=clock["t0"] + seconds, records=out)
