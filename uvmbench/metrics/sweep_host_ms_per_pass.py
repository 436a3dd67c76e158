"""Sweep driver: milliseconds of a pass in which nothing ran on the card
(the profiler's timeline), over the traced window's whole passes."""


def read(record):
    trace = record.get("trace") or {}
    if not trace.get("busy_s") or not record.get("passes"):
        return None
    return (trace["window_s"] - trace["busy_s"]) * 1e3 / record["passes"]
