"""PyTorch/CUDA port of the UVM learned-prefetching system (``repro``).

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch and hand-written CUDA kernels for Hopper (sm_90a).
It imports ``torch`` and never ``jax``, and nothing of ``repro``: host code
the two share is kept here as a copy under the same relative path.

Layout:

* ``traces`` -- benchmark generators and the GPU model (copies).
* ``core`` -- clustering, features, vocab and dataset (copies); the
  simplified §6 predictor, its training loop and ``PredictorService``.
* ``optimizer`` -- AdamW with global-norm clipping, LR schedules.
* ``kernels`` -- K1 (multi-lane UVM replay) and K2 (HLSH attention), each a
  CUDA source under ``csrc/`` built with nvcc at first use, a ctypes
  wrapper with a launch counter, and a plain PyTorch version.
* ``uvm`` -- the legacy simulator (the port's own cross-check), the golden
  matrix, the prediction cache, the ``cuda`` replay backend, the sweep entry
  point, the scenario registry and the paper's Table 10/11.

Entry points take ``device`` (default ``"cuda"``); the CPU path runs only
when the caller passes ``device="cpu"``.
"""
