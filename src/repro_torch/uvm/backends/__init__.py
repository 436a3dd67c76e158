"""Replay backends of the port.  Importing this package registers them:

* ``cuda`` -- the multi-lane replay around kernel K1 (on a CPU device it
  runs K1's plain PyTorch version).
"""
from repro_torch.uvm.replay_core import register_backend
from repro_torch.uvm.backends.cuda_backend import CudaReplayBackend

register_backend(CudaReplayBackend)

__all__ = ["CudaReplayBackend"]
