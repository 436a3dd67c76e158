"""K1: the share of the lanes' evictions that block-wide selection rounds
made, in percent (the program's counters ``k1.lane_round_evictions`` and
``k1.lane_evictions``, from K1's ``lane_info`` and its stats; padding
lanes left out), exact.  The rest took one warp search a victim."""
from uvmbench.metrics._passes import window_totals

COUNTERS = ("k1.lane_round_evictions", "k1.lane_evictions")


def read(record):
    got = window_totals(record, "counters", COUNTERS)
    if got is None or not got[0]["k1.lane_evictions"]:
        return None
    totals, _ = got
    return (100.0 * totals["k1.lane_round_evictions"]
            / totals["k1.lane_evictions"])
