"""K1: device nanoseconds of kernel time per simulated access of the
window's rows (every kernel the traced window ran, whatever its name)."""


def read(record):
    trace = record.get("trace") or {}
    if not trace.get("kernel_s") or not record.get("accesses"):
        return None
    return trace["kernel_s"] * 1e9 / record["accesses"]
