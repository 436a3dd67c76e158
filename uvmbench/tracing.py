"""The traced run: spans from the benchmark's own files, ``torch.profiler``
over the window, and the reduction of its timeline to busy time, kernel
time and idle gaps.

Spans are ``record_function`` ranges.  The harness opens one around the
window (``uvmbench.window``) and one around each pass (``uvmbench.pass``);
a driver names the program's functions to wrap (``span_targets``), and
:class:`Spans` wraps each for the traced window only and restores it after.
The profiler's chrome trace is written to a temporary file under ``TMPDIR``,
read back, and deleted.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import tempfile
from typing import Dict, Iterator, List, Sequence, Tuple

WINDOW_SPAN = "uvmbench.window"
PASS_SPAN = "uvmbench.pass"
#: chrome-trace categories of work that ran on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP_N = 10
NAME_CHARS = 100


class Spans:
    """Wrap ``(owner, attribute, label)`` targets in ``record_function``
    for the life of the context, and put the originals back after."""

    def __init__(self, targets: Sequence[Tuple[object, str, str]]):
        self.targets = list(targets)
        self._saved: List[Tuple[object, str, object]] = []

    def __enter__(self) -> "Spans":
        from torch.profiler import record_function
        for owner, attr, label in self.targets:
            original = getattr(owner, attr)

            def wrapped(*args, __fn=original, __label=label, **kwargs):
                with record_function(__label):
                    return __fn(*args, **kwargs)
            functools.update_wrapper(wrapped, original)
            # a class attribute read through the class is the plain function,
            # so the wrapper binds like a method
            self._saved.append((owner, attr, owner.__dict__[attr]
                                if attr in getattr(owner, "__dict__", {})
                                else original))
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc) -> None:
        for owner, attr, original in reversed(self._saved):
            setattr(owner, attr, original)
        self._saved.clear()


@contextlib.contextmanager
def span(label: str) -> Iterator[None]:
    from torch.profiler import record_function
    with record_function(label):
        yield


@contextlib.contextmanager
def profiled(device: str) -> Iterator[Dict]:
    """Profile the body; on exit the yielded dict holds the reduced timeline
    (:func:`reduce_trace`)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out: Dict = {}
    with profile(activities=activities) as prof:
        yield out
    fd, path = tempfile.mkstemp(prefix="uvmbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    out.update(reduce_trace(events))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def reduce_trace(events: List[Dict]) -> Dict:
    """Reduce chrome-trace events (times in microseconds) to seconds:

    * ``window_s``: the ``uvmbench.window`` span;
    * ``busy_s``: the union of the device's work (kernels, copies, sets)
      inside it; ``kernel_s``: the sum of its kernels' durations;
    * ``device_ops``: device time by operation name, largest first;
    * ``idle_gaps``: the window's time with nothing on the device, by the
      innermost span the host was in, largest first;
    * ``pass_s``, ``pass_busy_s``: each ``uvmbench.pass`` span's length and
      the device's busy time inside it.

    A window with no device work has ``busy_s == 0``."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in xs if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
    if not windows:
        return {}
    w = windows[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])

    dev, kernel_us = [], 0.0
    by_op: Dict[str, float] = {}
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        name = str(e.get("name", "?"))[:NAME_CHARS]
        by_op[name] = by_op.get(name, 0.0) + (b - a)
        if e.get("cat") == "kernel":
            kernel_us += b - a
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)

    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))

    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     str(e["name"])) for e in xs
                    if e.get("cat") == "user_annotation"
                    and e.get("name") != WINDOW_SPAN
                    and float(e["ts"]) < w1
                    and float(e["ts"]) + float(e["dur"]) > w0),
                   key=lambda s: (s[0], -s[1]))
    # cut each gap at the spans' edges and give each piece to the innermost
    # span around it
    cuts = sorted({t for a, b, _ in spans for t in (a, b) if w0 < t < w1})
    pieces = []
    for a, b in gaps:
        lo, hi = bisect.bisect_right(cuts, a), bisect.bisect_left(cuts, b)
        edges = [a] + cuts[lo:hi] + [b]
        pieces += [(x, y) for x, y in zip(edges, edges[1:]) if y > x]
    idle: Dict[str, float] = {}
    for (a, b), label in zip(pieces, _innermost(spans, [(a + b) / 2
                                                        for a, b in pieces])):
        idle[label] = idle.get(label, 0.0) + (b - a)

    passes = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in xs if e.get("name") == PASS_SPAN
                    and e.get("cat") == "user_annotation")
    pass_busy = [sum(max(0.0, min(b, p1) - max(a, p0)) for a, b in busy)
                 / 1e6 for p0, p1 in passes]

    def top(d: Dict[str, float]) -> List[List]:
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP_N]]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "kernel_s": kernel_us / 1e6, "device_ops": top(by_op),
            "idle_gaps": top(idle),
            "pass_s": [(p1 - p0) / 1e6 for p0, p1 in passes],
            "pass_busy_s": pass_busy}


def _innermost(spans: List[Tuple[float, float, str]],
               points: List[float]) -> List[str]:
    """For each point (ascending), the label of the innermost span that
    holds it (spans of one host thread nest), or ``"outside spans"``."""
    out: List[str] = []
    stack: List[Tuple[float, float, str]] = []
    starts = [s[0] for s in spans]
    j = 0
    for p in points:
        k = bisect.bisect_right(starts, p)
        while j < k:
            s = spans[j]
            while stack and stack[-1][1] <= s[0]:
                stack.pop()
            stack.append(s)
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else "outside spans")
    return out


