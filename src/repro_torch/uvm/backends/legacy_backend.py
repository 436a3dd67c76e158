"""The reference per-access loop as a replay backend (a copy of the
reference ``repro.uvm.backends.legacy_backend``).

``UVMSimulator`` *is* the timing model: every other backend is pinned
against it.  It accepts any prefetcher (including unknown ``Prefetcher``
subclasses that may touch pages outside a dense span) and any trace, so it
ends every fallback chain.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.uvm.replay_core import (ReplayBackend, ReplayRequest,
                                         run_legacy)
from repro_torch.uvm.simulator import UVMStats


class LegacyReplayBackend(ReplayBackend):
    name = "legacy"

    def can_replay(self, request: ReplayRequest) -> bool:
        return True

    def replay(self, requests: Sequence[ReplayRequest]) -> List[UVMStats]:
        out = []
        for req in requests:
            stats = run_legacy(req)
            stats.backend = self.name
            out.append(stats)
        return out
