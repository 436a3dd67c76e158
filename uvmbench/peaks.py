"""Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM5 80 GB data sheet, dense rates without sparsity, at the
full 700 W power limit.  A card held below that limit runs slower under
load: every result line carries the card's limit beside its numbers.
"""

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops": 989e12,
    "fp8_flops": 1979e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "memory_bytes": 80e9,
    "power_limit_w": 700.0,
}

#: the peaks the rooflines are taken against
PEAKS = H100_SXM
