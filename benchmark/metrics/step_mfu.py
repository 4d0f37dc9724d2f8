"""step_mfu — the whole chain's share of the card's fp32 peak, %: the
operations the traced window's frames needed in their two counted parts
(the K1 searches and the descriptor match product, ``benchmark/bound.py``)
over the traced window at 67 TFLOP/s. Work the count leaves out (the
ingest, SHOT, the voting, the solves) only makes the true share larger,
so this is a lower bound of it."""
from benchmark.bound import (DESC_DIM, FP32_FLOPS, k1_frame_flops,
                             match_flops, n_views)


def read(ctx):
    t = ctx["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    det, bank = ctx["config"]["detection"], ctx["config"]["bank"]
    per_match = match_flops(det, bank, n_views(bank["level"]),
                            DESC_DIM[bank["descriptor"]])
    flops = sum(k1_frame_flops(det, bank, int(r["reply"]["metrics"]
                                              ["scene_points"])) + per_match
                for r in ctx["traced"] if r["reply"] is not None)
    return 100.0 * flops / (t["window_s"] * FP32_FLOPS)
