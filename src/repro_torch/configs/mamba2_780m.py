"""mamba2-780m — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
