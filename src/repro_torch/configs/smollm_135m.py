"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv=3, d_ff=1536,
    vocab=49152, head_dim=64, tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
