"""seamless-m4t-medium — encoder-decoder multimodal backbone
[arXiv:2308.11596].  Audio frontend is a stub: ``input_specs`` supplies
precomputed frame embeddings at seq/8 (conformer downsampling)."""
from repro_torch.configs.arch import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv=16, d_ff=4096,
    vocab=256206, head_dim=64,
    enc_layers=12, frontend="audio", frontend_seq=0,  # frames = seq // 8
    tie_embeddings=False,
    source="arXiv:2308.11596",
)
