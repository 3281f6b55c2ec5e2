"""minicpm-2b — llama-like MHA with mu-p style scaling [arXiv:2404.06395; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab=122753,
    rope_theta=1e4,
    tie_embeddings=True,
    scale_emb=12.0,               # embedding scale
    scale_depth=1.4,              # residual branch scaled by scale_depth/sqrt(L)
    scale_logits=256.0 / 2304.0,  # mu-p logit scale (dim_model_base=256)
)
