"""Model configuration of the LM substrate (the port's own copy).

The same fields and defaults as the reference's `ModelConfig`, so a
config built here and one built there describe the same model; the port
runs the dense GQA subset (`configs/registry.py` registers only those).
`reduced()` derives the small same-family config the CPU tests use.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # attention
    attn_type: str = "gqa"      # gqa | mla | none
    rope_theta: float = 1e4
    # MLA (deepseek-family)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_type: str = ""          # rwkv6 | mamba
    attn_period: int = 0
    attn_period_offset: int = 0
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2
    # encoder-decoder
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1024
    # multimodal stub frontends
    modality_prefix: int = 0
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mtp: bool = False
    scale_emb: float = 1.0      # minicpm embedding scale
    scale_depth: float = 0.0    # minicpm residual scale (0 = off)
    scale_logits: float = 1.0   # minicpm: 1 / (d_model / dim_model_base)
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    fsdp_over_pod: bool = False
    # the paper's technique as a serving backend
    analog_mvm: bool = False
    analog_tech: str = "PCM"
    supports_long_context: bool = False
    # embedding/head tables are padded to a multiple of this; logits of
    # the pad entries are masked. The logical vocab is unchanged.
    pad_vocab_to: int = 256

    @property
    def vocab_padded(self) -> int:
        m = self.pad_vocab_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def moe_enabled(self) -> bool:
        return self.n_experts > 0

    def is_moe_layer(self, idx: int) -> bool:
        if not self.moe_enabled or idx < self.first_k_dense:
            return False
        return (idx % self.moe_every) == self.moe_offset

    def is_attn_layer(self, idx: int) -> bool:
        if self.ssm_type == "rwkv6":
            return False
        if self.attn_period:
            return (idx % self.attn_period) == self.attn_period_offset
        return True

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's rule)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if not self.attn_period else self.attn_period),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_head_dim=32 if self.attn_type == "mla" else self.qk_nope_head_dim,
            qk_rope_head_dim=16 if self.attn_type == "mla" else self.qk_rope_head_dim,
            v_head_dim=32 if self.attn_type == "mla" else self.v_head_dim,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            experts_per_token=min(self.experts_per_token, 2) if self.n_experts else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            first_k_dense=min(self.first_k_dense, 1),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=32,
            modality_prefix=min(self.modality_prefix, 8),
            d_state=min(self.d_state, 8),
            param_dtype="float32",
            compute_dtype="float32",
        )
