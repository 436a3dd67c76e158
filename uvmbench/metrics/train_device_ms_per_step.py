"""Device: the card's busy time a training step (the union of its kernels,
copies and sets inside the traced window, over the window's steps), in
milliseconds."""


def read(record):
    trace = record.get("trace") or {}
    if not trace.get("busy_s") or not record.get("passes"):
        return None
    return 1e3 * trace["busy_s"] / record["passes"]
