"""chain.device_ms_per_frame — device busy time per frame, ms: the
profiler's busy time over the traced window (every request sent in that
window, to its reply) divided by the frames it answered."""


def read(ctx):
    n = sum(r["reply"] is not None for r in ctx["traced"])
    if ctx["trace"] is None or n == 0 or ctx["trace"]["busy_s"] <= 0:
        return None
    return 1000.0 * ctx["trace"]["busy_s"] / n
