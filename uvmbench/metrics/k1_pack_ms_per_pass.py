"""Replay backend: host milliseconds a pass packing K1's lane batches and
copying them to the card (the program's spans ``cuda_backend.pack_lanes``,
``cuda_backend.pack_batch`` and ``cuda_backend.to_device``)."""
from uvmbench.metrics._passes import window_totals

SPANS = ("cuda_backend.pack_lanes", "cuda_backend.pack_batch",
         "cuda_backend.to_device")


def read(record):
    got = window_totals(record, "spans", SPANS)
    if got is None:
        return None
    totals, passes = got
    return sum(totals.values()) * 1e3 / passes
