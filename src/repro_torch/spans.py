"""Spans and counters of the port's sweep, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` records.  The sweep's
entry (``repro_torch.uvm.sweep.run_sweep``, decorated with
:func:`records_pass`) looks once, when it is called, and holds the answer
for the whole call: a pass is traced whole or not at all.  Each call made
while the profiler records leaves one pass record, ``{"spans": {name: host
seconds}, "counters": {name: int}}``, in a bounded in-process list that
:func:`passes` returns, oldest first.

While tracing is on, :func:`span` opens ``torch.profiler.record_function``
under its name, so the span lands in the profiler's timeline beside the
device's work, and adds its host seconds to the pass record
(:func:`spanned` does the same around a whole function); :func:`count`
adds to a counter.  While tracing is off, :func:`span` returns one shared
no-op context after a single test, :func:`spanned` calls its function
after that test, :func:`count` returns at once, and no ``record_function``
is entered.

A span covers a cell or a lane batch at the finest, never an access or a
lane, so a traced pass holds a few thousand spans.  One pass is traced at a
time in a process (the sweep's lane stage runs in one thread).

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        run_sweep(cells, device="cuda")
    record = spans.passes()[-1]
"""
from __future__ import annotations

import collections
import functools
import time
from typing import Callable, Deque, Dict, List, Optional

import torch
from torch.profiler import record_function

#: pass records kept, newest last
MAX_PASSES = 4096

_passes: Deque[Dict] = collections.deque(maxlen=MAX_PASSES)
#: the record of the pass being traced, None while tracing is off
_current: Optional[Dict] = None


class _Off:
    """The span while tracing is off: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


OFF = _Off()


class _Span:
    """A ``record_function`` range whose host seconds go to a pass record."""

    __slots__ = ("name", "_totals", "_range", "_t0")

    def __init__(self, name: str, totals: Dict[str, float]) -> None:
        self.name, self._totals = name, totals

    def __enter__(self) -> None:
        self._range = record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        seconds = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        self._totals[self.name] = self._totals.get(self.name, 0.0) + seconds


def on() -> bool:
    """True while a pass is being traced."""
    return _current is not None


def span(name: str):
    """A context manager timing its body under ``name`` while tracing is
    on; the shared no-op :data:`OFF` while it is off."""
    if _current is None:
        return OFF
    return _Span(name, _current["spans"])


def spanned(name: str) -> Callable:
    """Decorate a function to run its whole body under :func:`span`."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _current is None:
                return fn(*args, **kwargs)
            with _Span(name, _current["spans"]):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the traced pass's counter ``name``."""
    if _current is None:
        return
    counters = _current["counters"]
    counters[name] = counters.get(name, 0) + int(n)


def passes() -> List[Dict]:
    """The kept pass records, oldest first."""
    return list(_passes)


def records_pass(fn: Callable) -> Callable:
    """Decorate a pass's entry: a call made while a ``torch.profiler``
    records, outside another traced pass, traces its whole body and leaves
    one pass record when it returns."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        global _current
        if _current is not None or not torch.autograd.profiler.\
                _is_profiler_enabled:
            return fn(*args, **kwargs)
        record: Dict = {"spans": {}, "counters": {}}
        _current = record
        try:
            out = fn(*args, **kwargs)
        finally:
            _current = None
        _passes.append(record)
        return out
    return entry
