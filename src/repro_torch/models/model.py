"""The dense GQA language model: embeddings, layers, head; serving API.

  model = build_model(cfg, device=...)   # parameters allocated, not drawn
  model.init(generator)                  # fan-in normal draws
  model.forward(tokens)                  -> logits (B, S, V_padded)
  model.prefill(tokens, cache_len)       -> (logits (B, 1, V_padded), cache)
  model.decode_step(cache, tokens)       -> (logits (B, 1, V_padded), cache)
  model.init_cache(batch, cache_len)     -> zeroed cache

Logits are float32 with the pad entries at -1e30. The cache is a
`ModelCache`: every layer's K and V stacked, and one length per
sequence. The reference keeps a length per layer and again as the
position `pos`; on a dense stack they are always equal, so one tensor
serves as all of them. `decode_step` updates the cache in place (the
reference returns a new one) and returns it.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import Layer, LayerKind, apply_layer, build_stages
from repro_torch.models.common import Embedding, RMSNorm, dtype_of


@dataclasses.dataclass
class ModelCache:
    k: torch.Tensor       # (L, B, S, KV, D) in the compute dtype
    v: torch.Tensor       # (L, B, S, KV, D)
    length: torch.Tensor  # (B,) int32: tokens in the cache = next position

    def layer(self, i: int) -> KVCache:
        return KVCache(self.k[i], self.v[i], self.length)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.cfg = cfg
        self.stages = build_stages(cfg)
        self.kinds: "list[LayerKind]" = [
            kind for st in self.stages for _ in range(st.repeats) for kind in st.kinds
        ]
        self.embed = Embedding(cfg, device=device)
        self.layers = nn.ModuleList(Layer(cfg, device=device) for _ in self.kinds)
        self.final_ln = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype_of(cfg.param_dtype),
                                device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def init(self, generator: torch.Generator) -> None:
        """Draw every matrix (norm scales stay at one)."""
        self.embed.init(generator)
        for layer in self.layers:
            layer.init(generator)

    def _embed(self, tokens: torch.Tensor, positions_offset=None):
        tokens = tokens.to(self.device).long()
        b, s = tokens.shape
        x = self.embed.lookup(tokens)
        steps = torch.arange(s, dtype=torch.int32, device=self.device)
        if positions_offset is None:
            positions = steps.expand(b, s)
        else:
            positions = positions_offset[:, None] + steps
        return x, positions

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Training-mode forward (causal, no cache): (B, S) -> (B, S, V_padded)."""
        x, positions = self._embed(tokens)
        for layer, kind in zip(self.layers, self.kinds):
            x = apply_layer(layer, x, self.cfg, kind, positions)
        return self.embed.logits(self.final_ln(x))

    def init_cache(self, batch: int, cache_len: int) -> ModelCache:
        cfg = self.cfg
        shape = (len(self.layers), batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        cdt = dtype_of(cfg.compute_dtype)
        return ModelCache(
            k=torch.zeros(shape, dtype=cdt, device=self.device),
            v=torch.zeros(shape, dtype=cdt, device=self.device),
            length=torch.zeros((batch,), dtype=torch.int32, device=self.device),
        )

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: int):
        """Prompts (B, S) -> (last position's logits (B, 1, V_padded), cache)."""
        x, positions = self._embed(tokens)
        b, s = x.shape[:2]
        cache = self.init_cache(b, cache_len)
        for i, (layer, kind) in enumerate(zip(self.layers, self.kinds)):
            x = apply_layer(layer, x, self.cfg, kind, positions,
                            cache=cache.layer(i), fill_cache=True)
        cache.length.fill_(s)
        logits = self.embed.logits(self.final_ln(x[:, -1:]))
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache: ModelCache, tokens: torch.Tensor):
        """tokens (B, 1) at positions `cache.length` -> (logits (B, 1, V_padded),
        the same cache, advanced by one token)."""
        x, positions = self._embed(tokens, positions_offset=cache.length)
        for i, (layer, kind) in enumerate(zip(self.layers, self.kinds)):
            x = apply_layer(layer, x, self.cfg, kind, positions, cache=cache.layer(i))
        cache.length += 1
        return self.embed.logits(self.final_ln(x)), cache


def build_model(cfg: ModelConfig, *, device: "str | torch.device | None" = None) -> Model:
    """A model of `cfg` with its parameters allocated on `device` (None:
    the GPU), not yet drawn: call `init` or load weights."""
    return Model(cfg, device=resolve_device(device))
