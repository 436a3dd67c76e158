"""UVM substrate of the port: the legacy page-granular simulator (a copy of
the reference's, the port's own cross-check), the replay chain (the ``cuda``
multi-lane backend around kernel K1, the NumPy chunked engine and the legacy
loop; ``simulate`` and ``VectorizedUVMSimulator``), the golden matrix, the
prediction cache, the sweep entry point (``python -m repro_torch.uvm.sweep``),
its scenarios and the paper's tables and interconnect figures."""
from repro_torch.uvm.config import UVMConfig
from repro_torch.uvm.engine import VectorizedUVMSimulator, simulate
from repro_torch.uvm.eviction import EVICTION_POLICIES
from repro_torch.uvm.metrics import unity
from repro_torch.uvm.prefetchers import (LearnedPrefetcher, NoPrefetcher,
                                         OraclePrefetcher, Prefetcher,
                                         TreePrefetcher)
from repro_torch.uvm.replay_core import (ReplayBackend, ReplayRequest,
                                         available_backends, get_backend)
from repro_torch.uvm.simulator import UVMSimulator, UVMStats

__all__ = [
    "UVMConfig", "UVMSimulator", "UVMStats", "VectorizedUVMSimulator",
    "simulate", "unity", "EVICTION_POLICIES",
    "ReplayBackend", "ReplayRequest", "available_backends", "get_backend",
    "Prefetcher", "NoPrefetcher", "TreePrefetcher", "LearnedPrefetcher",
    "OraclePrefetcher",
]
