"""granite-20b (code) — llama-arch with MQA [arXiv:2405.04324]."""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv=1, d_ff=24576,
    vocab=49152, head_dim=128, tie_embeddings=False,
    source="arXiv:2405.04324",
)
