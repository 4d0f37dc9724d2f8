"""k1_roofline — kernel K1's share of its roofline, %: the least time of
the K1 searches the traced window's frames needed (``benchmark/bound.py``,
counted from the configuration and each frame's working set, so the same
whatever implements K1) over the profiler's device time of
``knn_split_kernel<1>``."""
from benchmark.bound import k1_frame_ms


def read(ctx):
    t = ctx["trace"]
    if t is None or t["k1_s"] <= 0:
        return None
    det, bank = ctx["config"]["detection"], ctx["config"]["bank"]
    least_ms = sum(k1_frame_ms(det, bank, int(r["reply"]["metrics"]
                                              ["scene_points"]))
                   for r in ctx["traced"] if r["reply"] is not None)
    return 100.0 * least_ms / (1000.0 * t["k1_s"])
