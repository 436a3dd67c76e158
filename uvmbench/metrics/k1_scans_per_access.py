"""K1: victim-search chunk scans per replayed access (the program's
counters ``k1.lane_scans`` and ``k1.lane_accesses``, from K1's
``lane_info``; padding lanes left out), exact."""
from uvmbench.metrics._passes import window_totals

COUNTERS = ("k1.lane_scans", "k1.lane_accesses")


def read(record):
    got = window_totals(record, "counters", COUNTERS)
    if got is None or not got[0]["k1.lane_accesses"]:
        return None
    totals, _ = got
    return totals["k1.lane_scans"] / totals["k1.lane_accesses"]
