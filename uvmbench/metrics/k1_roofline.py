"""K1: the least time the card could take for the window's replays
(``uvmbench.roofline``: bytes over the HBM peak) as a share of the kernel
time the traced window ran, in percent."""
from uvmbench.roofline import replay_least_seconds


def read(record):
    trace = record.get("trace") or {}
    if not trace.get("kernel_s") or not record.get("rows"):
        return None
    return 100.0 * replay_least_seconds(record["rows"]) / trace["kernel_s"]
