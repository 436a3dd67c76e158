"""The program's own pass records of the traced window
(``repro_torch.spans``: per pass, host seconds by span name and counts by
counter name), summed for the readers of program spans and counters."""


def window_totals(record, kind, names):
    """``(totals, passes)``: each of ``names`` of ``kind`` (``"spans"`` or
    ``"counters"``) summed over the pass records of the window's
    ``record["passes"]`` passes, and their number.  None where the program
    keeps no such records (no ``repro_torch.spans``), keeps fewer, a record
    lacks a name, or the window launched no K1 (no card)."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    n = record.get("passes") or 0
    if not n or not sum(record.get("counters", {}).get("k1_launches") or []):
        return None
    kept = spans.passes()
    if len(kept) < n:
        return None
    totals = dict.fromkeys(names, 0)
    for rec in kept[-n:]:
        values = rec.get(kind, {})
        for name in names:
            if name not in values:
                return None
            totals[name] += values[name]
    return totals, n
