"""internvl2-1b — InternViT frontend (stub) + Qwen2-0.5B-class LM backbone
[arXiv:2404.16821].  ``input_specs`` supplies precomputed patch embeddings."""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, d_ff=4864,
    vocab=151655, head_dim=64,
    frontend="vision", frontend_seq=256,
    tie_embeddings=True,
    source="arXiv:2404.16821",
)
