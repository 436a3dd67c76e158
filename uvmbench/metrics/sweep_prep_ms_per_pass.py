"""Sweep driver: host milliseconds a pass in the sweep's preparation, the
program's spans ``sweep.resolve_evictions``, ``sweep.prepare_cell`` and
``sweep._solo_requests`` (none nests in another; their sub-spans lie
inside them)."""
from uvmbench.metrics._passes import window_totals

SPANS = ("sweep.resolve_evictions", "sweep.prepare_cell",
         "sweep._solo_requests")


def read(record):
    got = window_totals(record, "spans", SPANS)
    if got is None:
        return None
    totals, passes = got
    return sum(totals.values()) * 1e3 / passes
