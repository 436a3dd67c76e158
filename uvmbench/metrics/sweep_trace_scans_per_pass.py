"""Sweep driver: the whole-trace NumPy passes the sweep and the backend make
in a pass (the program's counter ``sweep.trace_scans``: working-set reads,
oracle first-touch builds, tenant last-index and component extractions,
lane page bounds), exact."""
from uvmbench.metrics._passes import window_totals


def read(record):
    got = window_totals(record, "counters", ("sweep.trace_scans",))
    if got is None:
        return None
    totals, passes = got
    return totals["sweep.trace_scans"] / passes
