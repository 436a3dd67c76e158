"""The paper's core: deep-learning UVM page prediction, in PyTorch.

Pipeline: GMMU trace -> clustering -> feature tokens -> delta vocabulary ->
sliding-window dataset -> simplified §6 predictor (HLSH attention or the
convergence bypass, 4-bit QAT) -> per-access top-1 page predictions.
"""
