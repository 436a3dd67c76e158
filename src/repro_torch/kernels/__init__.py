"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

* K1 ``lane_replay`` -- multi-lane UVM replay (replaces the reference's
  Pallas ``_lane_replay_fn``), host side in ``repro_torch.uvm.backends``.
* K2 ``hlsh_attention`` -- HLSH masked attention (replaces the reference's
  Pallas ``_hlsh_kernel``); ``ops.hlsh_attention`` adds the share map.

Sources live in ``repro_torch/csrc``; ``build`` compiles each with nvcc into
a shared library with a plain C interface at first use.  A wrapper launches
its kernel for CUDA tensors and runs the plain version for CPU tensors, and
counts its launches in its ``launches`` attribute.
"""
