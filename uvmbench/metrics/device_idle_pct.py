"""Device: the share of the traced window with nothing running on the card,
in percent."""


def read(record):
    trace = record.get("trace") or {}
    if not trace.get("busy_s"):
        return None
    return 100.0 * max(0.0, 1.0 - trace["busy_s"] / trace["window_s"])
