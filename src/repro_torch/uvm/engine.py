"""Engine façade over the port's backend chain, a copy of the reference
``repro.uvm.engine``:

* :class:`VectorizedUVMSimulator` -- drop-in replacement for
  ``UVMSimulator`` (same timing model, bit-identical stats) on the
  ``numpy`` backend, with the legacy loop for unknown prefetcher subclasses
  and oversized page spans.
* :func:`simulate` -- one (trace, prefetcher) cell on a chosen engine and
  backend; the returned ``UVMStats.backend`` records what ran.

Lane batching of whole grids is scheduled by ``repro_torch.uvm.sweep``;
this module dispatches single cells.
"""
from __future__ import annotations

from repro_torch.traces.trace import Trace
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.prefetchers import Prefetcher
from repro_torch.uvm.replay_core import MAX_SPAN_PAGES, ReplayRequest, dispatch
from repro_torch.uvm.simulator import UVMStats

ENGINES = ("auto", "vectorized", "legacy")


class VectorizedUVMSimulator:
    """Drop-in replacement for :class:`UVMSimulator`: the NumPy chunked
    replay through the ``numpy`` backend; unknown prefetcher subclasses and
    oversized page spans fall back to the legacy loop wholesale."""

    def __init__(self, config: UVMConfig | None = None,
                 record_timeline: bool = False,
                 strict_checks: bool = False,
                 max_span_pages: int = MAX_SPAN_PAGES) -> None:
        self.config = config or UVMConfig()
        self.record_timeline = record_timeline
        self.strict_checks = strict_checks
        self.max_span_pages = max_span_pages

    def run(self, trace: Trace, prefetcher: Prefetcher) -> UVMStats:
        request = ReplayRequest(
            trace=trace, prefetcher=prefetcher, config=self.config,
            record_timeline=self.record_timeline,
            strict_checks=self.strict_checks,
            max_span_pages=self.max_span_pages)
        return dispatch(request, backend="numpy")


def simulate(trace: Trace, prefetcher: Prefetcher,
             config: UVMConfig | None = None, *, engine: str = "auto",
             backend: str = "auto", record_timeline: bool = False,
             step_bounds=None, device: str = "cuda") -> UVMStats:
    """Run one (trace, prefetcher) cell on the chosen engine and backend.

    ``engine`` picks the replay style: ``auto``/``vectorized`` take the
    backend chain of ``backend`` (``auto`` and ``cuda``: K1 on ``device``,
    then the NumPy engine, then the legacy loop; ``numpy``: the NumPy
    engine, then legacy), ``legacy`` forces the per-access loop.  The
    returned ``UVMStats.backend`` names the backend that ran.
    ``step_bounds`` requests per-window completion clocks
    (``UVMStats.step_clocks``; see ``ReplayRequest.step_bounds``).
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    request = ReplayRequest(trace=trace, prefetcher=prefetcher,
                            config=config or UVMConfig(),
                            record_timeline=record_timeline,
                            step_bounds=step_bounds)
    if engine == "legacy":
        return dispatch(request, backend="legacy")
    return dispatch(request, backend=backend, device=device)
