"""serve.host_ms — the service's host time per frame, ms: the mean, over
the frames of the window run as with ``--trace 0`` (no profiler), of the
round trip less the reply's own ``latency_ms`` (the service's timing
around the device call). What is left is host unprojection, the tile
count and the reply."""


def read(ctx):
    frames = [r for r in ctx["window"] if r["reply"] is not None]
    if not frames:
        return None
    return sum(1000.0 * (r["t_done"] - r["t_start"]) - r["reply"]["latency_ms"]
               for r in frames) / len(frames)
