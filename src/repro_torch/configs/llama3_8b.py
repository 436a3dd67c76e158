"""llama3-8b [arXiv:2407.21783]."""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=128256, head_dim=128, tie_embeddings=False,
    source="arXiv:2407.21783",
)
