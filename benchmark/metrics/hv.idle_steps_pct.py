"""hv.idle_steps_pct — the share, %, of GO-HV's sequential search steps
that changed nothing: 100 × (Σ ``hv_steps`` − Σ ``hv_steps_improved``) /
Σ ``hv_steps`` over the traced window's replies. None where no reply
carries the counts."""


def read(ctx):
    counted = [r["reply"]["metrics"] for r in ctx["traced"]
               if r["reply"] is not None
               and "hv_steps" in r["reply"]["metrics"]]
    steps = sum(float(m["hv_steps"]) for m in counted)
    if steps <= 0:
        return None
    improved = sum(float(m["hv_steps_improved"]) for m in counted)
    return 100.0 * (steps - improved) / steps
