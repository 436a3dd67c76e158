"""The NumPy chunked replay core as a replay backend (a copy of the
reference ``repro.uvm.backends.numpy_backend``): bit-identical to the
legacy loop for every supported prefetcher type, on the host whatever the
device.  It replays the cells K1 declines.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.uvm.eviction import EVICTION_POLICIES
from repro_torch.uvm.replay_core import (SUPPORTED_PREFETCHERS, ReplayBackend,
                                         ReplayRequest, replay_chunked,
                                         span_ok)
from repro_torch.uvm.simulator import UVMStats


class NumpyReplayBackend(ReplayBackend):
    name = "numpy"

    def can_replay(self, request: ReplayRequest) -> bool:
        return (type(request.prefetcher) in SUPPORTED_PREFETCHERS
                and request.config.eviction in EVICTION_POLICIES
                and span_ok(request))

    def replay(self, requests: Sequence[ReplayRequest]) -> List[UVMStats]:
        out = []
        for req in requests:
            stats = replay_chunked(req)
            stats.backend = self.name
            out.append(stats)
        return out
