"""Plain torch version of flash-decoding attention (one query step).

GQA layout, as the reference's `decode_attention/ref.py`: q (B, H, Dk),
k (B, S, Hkv, Dk), v (B, S, Hkv, Dv) with H = G * Hkv. `kv_len` masks
the valid cache prefix per batch element (a length past S keeps all S
positions). Float32 math, output in q's dtype. Masked scores are -inf,
as in the reference's plain version; a row needs at least one valid
position.
"""
from __future__ import annotations

from typing import Optional

import torch


def decode_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, h, dk = q.shape
    _, s, hkv, _ = k.shape
    dv = v.shape[-1]
    g = h // hkv
    if scale is None:
        scale = dk ** -0.5
    qf = q.reshape(b, hkv, g, dk).float()
    scores = torch.einsum("bngd,bsnd->bngs", qf, k.float()) * scale
    if kv_len is not None:
        mask = torch.arange(s, device=q.device)[None, :] < kv_len[:, None]   # (B, S)
        scores = torch.where(mask[:, None, None, :], scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngs,bsnd->bngd", p, v.float())
    return out.reshape(b, h, dv).to(q.dtype)
