"""Training step: the window's model FLOPs (``uvmbench.lm_flops``, counted
from the configuration whatever runs the step) over the window's time and
the card's float32 peak (``uvmbench.peaks``), in percent: the share of the
peak the whole step reaches."""
from uvmbench.peaks import PEAKS


def read(record):
    rows = record.get("rows") or []
    if not rows or not record.get("window_s"):
        return None
    flops = sum(r["model_flops"] for r in rows)
    return 100.0 * flops / (record["window_s"] * PEAKS["fp32_flops"])
