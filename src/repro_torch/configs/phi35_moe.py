"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400,
    vocab=32064, n_experts=16, top_k=2, head_dim=128,
    tie_embeddings=False,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
