"""Shared model pieces: dtypes, RMSNorm, RoPE, embedding and LM head, init.

Weights keep the reference's layouts (`tok (V, E)`, `head (E, V)`), so
the einsums read alike. The reference keeps every weight in
`param_dtype` and casts it to `compute_dtype` on every call; the port
casts the digital path's weights once, when they are made or loaded
(`digital_dtype`), which is the same rounding.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def digital_dtype(cfg: ModelConfig) -> torch.dtype:
    """Storage dtype of a weight the digital path reads: the compute dtype."""
    return dtype_of(cfg.compute_dtype)


def weight(
    shape: Sequence[int], dtype: torch.dtype, device: "torch.device | str"
) -> nn.Parameter:
    """An uninitialised frozen parameter (filled by `init_normal_` or a load)."""
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def init_normal_(
    p: torch.Tensor, generator: torch.Generator, scale: Optional[float] = None
) -> None:
    """Fan-in normal init: ``scale * N(0, 1)`` drawn in float32, ``scale``
    defaulting to ``shape[0] ** -0.5``, cast to the parameter's dtype."""
    if scale is None:
        scale = p.shape[0] ** -0.5
    draw = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=p.device)
    p.copy_(draw.mul_(scale))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS normalisation in float32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, dtype: torch.dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = weight((dim,), dtype, device)
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x, self.eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split-half rotation. x (B, S, H, D) [D even];
    positions (B, S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs              # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class Embedding(nn.Module):
    """Token table `tok (V_padded, E)` and, untied, the head `head (E, V_padded)`."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.cfg = cfg
        dt = digital_dtype(cfg)
        v = cfg.vocab_padded
        self.tok = weight((v, cfg.d_model), dt, device)
        self.head = None if cfg.tie_embeddings else weight((cfg.d_model, v), dt, device)

    def init(self, generator: torch.Generator) -> None:
        init_normal_(self.tok, generator, scale=1.0)
        if self.head is not None:
            init_normal_(self.head, generator, scale=self.cfg.d_model ** -0.5)

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) int -> (B, S, E) in the compute dtype, times `scale_emb`."""
        x = self.tok[tokens].to(dtype_of(self.cfg.compute_dtype))
        return x * self.cfg.scale_emb

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, E) -> float32 (B, S, V_padded); pad entries pushed to -1e30."""
        cfg = self.cfg
        w = self.tok.to(x.dtype).t() if self.head is None else self.head.to(x.dtype)
        logits = cfg.scale_logits * torch.einsum("bse,ev->bsv", x, w).float()
        if cfg.vocab_padded != cfg.vocab:
            pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
            logits = logits + torch.where(pad, NEG_INF, 0.0)
        return logits


def residual_scale(cfg: ModelConfig) -> float:
    """MiniCPM-style depth-scaled residual branches."""
    if cfg.scale_depth > 0:
        return cfg.scale_depth / (cfg.n_layers ** 0.5)
    return 1.0
