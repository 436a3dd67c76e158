"""Replay backends of the port.  Importing this package registers them:

* ``cuda`` -- the multi-lane replay around kernel K1 (on a CPU device it
  runs K1's plain PyTorch version);
* ``numpy`` -- the NumPy chunked replay core (bit-identical to legacy for
  the supported prefetcher types and page spans up to 2^24 pages);
* ``legacy`` -- the reference per-access loop (accepts everything).

``replay_core.backend_chain`` orders them: a request goes to the first
backend of its chain that accepts it.
"""
from repro_torch.uvm.replay_core import register_backend
from repro_torch.uvm.backends.cuda_backend import CudaReplayBackend
from repro_torch.uvm.backends.legacy_backend import LegacyReplayBackend
from repro_torch.uvm.backends.numpy_backend import NumpyReplayBackend

register_backend(CudaReplayBackend)
register_backend(NumpyReplayBackend)
register_backend(LegacyReplayBackend)

__all__ = ["CudaReplayBackend", "NumpyReplayBackend", "LegacyReplayBackend"]
