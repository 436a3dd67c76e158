"""ArchConfig: declarative description of every supported architecture, and
the assigned input-shape suite (train_4k / prefill_32k / decode_32k /
long_500k)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    # hybrid (recurrentgemma): local-attention window + block pattern period
    window: Optional[int] = None
    pattern: Tuple[str, ...] = ()
    # encoder-decoder
    enc_layers: int = 0
    # modality frontend stub: precomputed embeddings of this length are a
    # model input (vlm: patches; audio: frames = seq/8)
    frontend: Optional[str] = None
    frontend_seq: int = 0
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: bool = True
    source: str = ""
    # ---- performance knobs (hillclimb levers, EXPERIMENTS.md §Perf) ----
    capacity_factor: float = 1.25   # MoE dispatch capacity
    attn_f32_logits: bool = True    # accumulate attention logits in f32
    ssd_chunk: int = 128            # SSD intra-chunk length
    # MoE dispatch algorithm: "grouped" (GShard-style token groups, the
    # default), "einsum" (global one-hot einsum: O(T^2) dispatch flops),
    # "scatter" (scatter-add: minimal flops but GSPMD-hostile collectives).
    # The three are the measured §Perf iterations of the MoE cells.
    moe_dispatch: str = "grouped"
    moe_group_tokens: int = 512

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k (bounded attention state)?"""
        return self.family in ("ssm", "hybrid")

    def reduced(self, n_layers: int = 2, d_model: int = 64,
                vocab: int = 512) -> "ArchConfig":
        """Same-family smoke-test config: tiny widths, few experts."""
        hd = 16
        n_heads = max(2, min(self.n_heads, 4))
        n_kv = max(1, min(self.n_kv, n_heads))
        while n_heads % n_kv:       # GQA requires n_heads % n_kv == 0
            n_kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv=n_kv,
            head_dim=hd,
            d_ff=d_model * 2,
            vocab=vocab,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            window=min(self.window, 32) if self.window else None,
            enc_layers=min(self.enc_layers, 2),
            frontend_seq=min(self.frontend_seq, 8) if self.frontend_seq else 0,
            dtype="float32",
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
