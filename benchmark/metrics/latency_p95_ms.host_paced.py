"""latency_p95_ms.host_paced — the 95th percentile, ms, of the host round
trips (``detect_depth`` called to its reply returned) of the window run as
with ``--trace 0``, before the traced one: the profiler's own host work
never enters it. A per-layer reading: in these cells the card is idle for
most of the window, so the tail is the host's, and it decides no change."""
from benchmark.run import percentile


def read(ctx):
    lat = [1000.0 * (r["t_done"] - r["t_start"]) for r in ctx["window"]]
    return percentile(lat, 95.0) if len(lat) >= 20 else None
