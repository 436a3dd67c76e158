"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family]."""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, d_ff=1536,
    vocab=151936, n_experts=128, top_k=8, head_dim=64,
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-30B-A3B",
)
