"""Replay backend: host milliseconds a pass blocked reading K1's results
back, while the card replays (the program's span
``cuda_backend.readback``)."""
from uvmbench.metrics._passes import window_totals


def read(record):
    got = window_totals(record, "spans", ("cuda_backend.readback",))
    if got is None:
        return None
    totals, passes = got
    return totals["cuda_backend.readback"] * 1e3 / passes
