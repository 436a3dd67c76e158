"""K1: how evenly a batch's lanes share its time, in percent: the lanes'
nanoseconds on the card's global timer over the longest lane's times the
batch's lanes, summed over the window's batches (the program's counters
``k1.lane_ns_sum`` and ``k1.lane_ns_longest_x_lanes``, from K1's
``lane_info``; padding lanes left out).  100 is a batch whose lanes all
take as long as its longest."""
from uvmbench.metrics._passes import window_totals

COUNTERS = ("k1.lane_ns_sum", "k1.lane_ns_longest_x_lanes")


def read(record):
    got = window_totals(record, "counters", COUNTERS)
    if got is None or not got[0]["k1.lane_ns_longest_x_lanes"]:
        return None
    totals, _ = got
    return (100.0 * totals["k1.lane_ns_sum"]
            / totals["k1.lane_ns_longest_x_lanes"])
