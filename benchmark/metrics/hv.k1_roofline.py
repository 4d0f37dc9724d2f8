"""hv.k1_roofline — kernel K1's share of its roofline, %, in a cell with
GO-HV on: the least time of every K1 search the traced window's frames
needed, the refinement's and GO-HV's two (``benchmark/hv_bound.py``,
counted from the configuration and each reply's ``scene_points`` and
``hv_instance_points``), over the profiler's device time of
``knn_split_kernel<1>``. None where no reply carries GO-HV's counts."""
from benchmark.hv_bound import hv_frame_ms


def read(ctx):
    t = ctx["trace"]
    if t is None or t["k1_s"] <= 0:
        return None
    det, bank = ctx["config"]["detection"], ctx["config"]["bank"]
    counted = [r["reply"]["metrics"] for r in ctx["traced"]
               if r["reply"] is not None
               and "hv_instance_points" in r["reply"]["metrics"]]
    if not counted:
        return None
    least_ms = sum(hv_frame_ms(det, bank, int(m["scene_points"]),
                               int(m["hv_instance_points"])) for m in counted)
    return 100.0 * least_ms / (1000.0 * t["k1_s"])
