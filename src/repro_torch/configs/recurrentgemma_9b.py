"""recurrentgemma-9b — RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427]."""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288,
    vocab=256000, head_dim=256, window=2048,
    pattern=("lru", "lru", "lattn"),
    tie_embeddings=True,
    source="arXiv:2402.19427",
)
