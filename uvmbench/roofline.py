"""The least time the card could take for a sweep's replays.

A replay reads each access's page number once (an int32) and writes each
row's simulated counters once (8 bytes each): K1's nine ``STAT_FIELDS``,
and on a two-tenant row also the tenant-0 hit count and the clocks at the
two tenants' last accesses.  It does no arithmetic worth counting against a
FLOP peak, so the bound is bytes over the HBM bandwidth.  The work is
counted from the rows (their ``n_accesses``), whatever replays them, so a
change to how the program replays cannot change what a replay is worth.
K1 replays each lane as a chain of dependent accesses, so its share of this
bound is far below 1%: the bound is a ceiling no later claim can pass, not
a target.
"""
from __future__ import annotations

from typing import Dict, Iterable

from uvmbench.peaks import PEAKS

PAGE_ID_BYTES = 4
COUNTER_BYTES = 8
ROW_COUNTERS = 9
#: the tenant-0 hit count and the two tenants' completion clocks
TENANT_COUNTERS = 3


def replay_bytes(rows: Iterable[Dict]) -> int:
    """Bytes the replays of ``rows`` must move at the least."""
    total = 0
    for row in rows:
        counters = ROW_COUNTERS + (TENANT_COUNTERS if row.get("tenants")
                                   else 0)
        total += (PAGE_ID_BYTES * int(row["n_accesses"])
                  + COUNTER_BYTES * counters)
    return total


def replay_least_seconds(rows: Iterable[Dict]) -> float:
    """The least time the card could take for the replays of ``rows``."""
    return replay_bytes(rows) / PEAKS["hbm_bytes_per_s"]
