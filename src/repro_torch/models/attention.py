"""GQA attention (+RoPE): train, prefill and decode.

Prefill and train attention is plain torch (`sdpa`, the reference's
`_sdpa`); decode attends through the `decode_attention` kernel. The KV
cache is updated in place (the reference returns a new cache), and a
decode write at a position past the cache is dropped, as JAX's scatter
drops it: the serving engine decodes idle slots too, whose lengths keep
growing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models.common import NEG_INF, digital_dtype, init_normal_, rope, weight


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S, KV, D)
    v: torch.Tensor       # (B, S, KV, D)
    length: torch.Tensor  # (B,) int32 — tokens currently in the cache


class Attention(nn.Module):
    """`wq (E, H, D)`, `wk (E, KV, D)`, `wv (E, KV, D)`, `wo (H, D, E)`."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        e, h, kv, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = digital_dtype(cfg)
        self.wq = weight((e, h, d), dt, device)
        self.wk = weight((e, kv, d), dt, device)
        self.wv = weight((e, kv, d), dt, device)
        self.wo = weight((h, d, e), dt, device)

    def init(self, generator: torch.Generator) -> None:
        for p in (self.wq, self.wk, self.wv, self.wo):
            init_normal_(p, generator)


def sdpa(q, k, v, mask, scale: float) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,KV,D'); mask: None | (q_pos, k_pos) causal
    pair | (B, Sk) boolean KV validity | (B, Sq, Sk) boolean. Float32 math,
    masked scores -1e30, output in q's dtype."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, sq, kvh, g, d)
    scores = torch.einsum("bqngd,bknd->bnqgk", qf, k.float()) * scale
    if mask is not None:
        if isinstance(mask, tuple):
            q_pos, k_pos = mask
            ok = q_pos[:, None, :, None, None] >= k_pos[:, None, None, None, :]
        elif mask.ndim == 2:
            ok = mask[:, None, None, None, :]
        else:
            ok = mask[:, None, :, None, :]
        scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnqgk,bknd->bqngd", p, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def _write_at(buf: torch.Tensor, length: torch.Tensor, new: torch.Tensor) -> None:
    """buf[b, length[b]] = new[b] in place; rows with length >= S are dropped."""
    s = buf.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)
    pos = length.clamp(max=s - 1).long()
    keep = (length >= s)[:, None, None]
    buf[rows, pos] = torch.where(keep, buf[rows, pos], new.to(buf.dtype))


def gqa_apply(
    p: Attention,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    cache: Optional[KVCache] = None,
    fill_cache: bool = False,
) -> torch.Tensor:
    """Attention of x (B, S, E); returns (B, S, E).

    Modes:
      train:   cache=None.
      prefill: cache=KVCache, fill_cache=True: attends over x and writes
               its K/V into the cache's first S positions.
      decode:  cache=KVCache, x is (B, 1, E): writes the new K/V at each
               row's `length` and attends over the first length + 1
               positions. The caller advances `length`.
    """
    b, s, _ = x.shape
    scale = cfg.head_dim ** -0.5
    q = torch.einsum("bse,ehd->bshd", x, p.wq.to(x.dtype))
    k = torch.einsum("bse,ehd->bshd", x, p.wk.to(x.dtype))
    v = torch.einsum("bse,ehd->bshd", x, p.wv.to(x.dtype))
    if cache is None or fill_cache:
        if causal:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        out = sdpa(q, k, v, (positions, positions) if causal else None, scale)
        if fill_cache:
            if s > cache.k.shape[1]:
                raise ValueError(f"prefill of {s} tokens into a cache of {cache.k.shape[1]}")
            cache.k[:, :s] = k.to(cache.k.dtype)
            cache.v[:, :s] = v.to(cache.v.dtype)
    else:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        _write_at(cache.k, cache.length, k[:, 0])
        _write_at(cache.v, cache.length, v[:, 0])
        out = decode_attention(q[:, 0], cache.k, cache.v, cache.length + 1,
                               scale=scale)[:, None]
    return torch.einsum("bshd,hde->bse", out, p.wo.to(x.dtype))
