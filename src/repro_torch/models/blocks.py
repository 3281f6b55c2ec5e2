"""Layer kinds, stage grouping and one layer's apply, for dense GQA stacks.

The reference scans each stage's stacked parameters with `lax.scan`; the
port keeps one `Layer` module per layer in an `nn.ModuleList` and walks
it in Python. Only the dense stage (attention + SwiGLU MLP) is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import Attention, KVCache, gqa_apply
from repro_torch.models.common import RMSNorm, dtype_of, residual_scale
from repro_torch.models.mlp import MLP, mlp_apply


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str             # attn (mamba | rwkv: not ported)
    ffn: Optional[str]     # mlp (moe | rwkv_cm: not ported)
    cross: bool = False
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class Stage:
    kinds: Tuple[LayerKind, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.kinds) * self.repeats


def build_stages(cfg: ModelConfig) -> "list[Stage]":
    """The stage structure of a dense GQA config (one attn + mlp stage)."""
    unported = [
        what for what, on in (
            ("rwkv/mamba mixers", bool(cfg.ssm_type) or bool(cfg.attn_period)),
            ("MoE", cfg.moe_enabled),
            ("encoder-decoder", cfg.is_encoder_decoder),
            (f"{cfg.attn_type} attention", cfg.attn_type != "gqa"),
            ("the VLM frontend", cfg.family == "vlm"),
            ("multi-token prediction", cfg.mtp),
        ) if on
    ]
    if unported:
        raise NotImplementedError(f"{cfg.name}: {', '.join(unported)} not ported yet")
    return [Stage((LayerKind("attn", "mlp"),), cfg.n_layers)]


class Layer(nn.Module):
    """Parameters of one attn + mlp layer: ln1, mix, ln2, ffn."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        norm_dt = dtype_of(cfg.param_dtype)
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=norm_dt, device=device)
        self.mix = Attention(cfg, device=device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=norm_dt, device=device)
        self.ffn = MLP(cfg, device=device)

    def init(self, generator: torch.Generator) -> None:
        self.mix.init(generator)
        self.ffn.init(generator)


def apply_layer(
    p: Layer,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: LayerKind,
    positions: torch.Tensor,
    *,
    cache: Optional[KVCache] = None,
    fill_cache: bool = False,
) -> torch.Tensor:
    """One layer: x + rs * attn(ln1(x)), then + rs * mlp(ln2(x))."""
    rs = residual_scale(cfg)
    h = p.ln1(x)
    out = gqa_apply(p.mix, h, cfg, positions, causal=kind.causal, cache=cache,
                    fill_cache=fill_cache)
    x = x + rs * out
    h = p.ln2(x)
    return x + rs * mlp_apply(p.ffn, h, cfg)
