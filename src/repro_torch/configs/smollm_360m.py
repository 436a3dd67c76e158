"""smollm-360m [hf:HuggingFaceTB/SmolLM-360M]."""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv=5, d_ff=2560,
    vocab=49152, head_dim=64, tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M (360M sibling)",
)
