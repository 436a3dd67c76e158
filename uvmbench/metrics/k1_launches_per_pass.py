"""Replay backend: K1 launches a pass, from the program's exact launch
counter (``repro_torch.kernels.launch_counts``)."""


def read(record):
    launches = record.get("counters", {}).get("k1_launches") or []
    if not sum(launches):
        return None
    return sum(launches) / len(launches)
