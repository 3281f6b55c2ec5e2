"""Plain torch version of flash-decoding attention (one query step).

GQA layout, as the reference's `decode_attention/ref.py`: q (B, H, Dk),
k (B, S, Hkv, Dk), v (B, S, Hkv, Dv) with H = G * Hkv. `kv_len` masks
the valid cache prefix per batch element (a length past S keeps all S
positions). Float32 math, output in q's dtype. Masked scores are -inf,
as in the reference's plain version; a row needs at least one valid
position.

`decode_attention_split_ref` is the algebra of the kernel's split-KV
route written out plainly: per-split partials (m, l, acc) with the
kernel's -1e30 mask, combined in split order. It is for the tests, not
for the main path.
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


NEG_INF = -1e30   # the kernel's mask value


def decode_attention_split_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[torch.Tensor],
    splits: int,
    chunk: int,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The split-KV route's combine: split r takes positions
    [r*chunk, (r+1)*chunk) and publishes m_r = max of its scores (masked
    ones at -1e30), l_r = sum exp(s - m_r), acc_r = sum exp(s - m_r) v; a
    split holding no valid position publishes (-1e30, 0, 0). Then
    m* = max m_r, l = sum exp(m_r - m*) l_r, out = sum exp(m_r - m*) acc_r / l,
    summed in split order. Same layout and result as `decode_attention_ref`."""
    b, h, dk = q.shape
    _, s, hkv, dv = v.shape
    g = h // hkv
    if scale is None:
        scale = dk ** -0.5
    lens = torch.full((b,), s) if kv_len is None else kv_len.clamp(max=s)
    qf = q.reshape(b, hkv, g, dk).float()
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < lens[:, None].to(q.device)                    # (B, S)
    ms, ls, accs = [], [], []
    for r in range(splits):
        lo, hi = r * chunk, min((r + 1) * chunk, s)
        sc = torch.einsum("bngd,bsnd->bngs", qf, k[:, lo:hi].float()) * scale
        mask = valid[:, None, None, lo:hi]
        sc = torch.where(mask, sc, NEG_INF)
        m = sc.amax(-1) if hi > lo else torch.full((b, hkv, g), NEG_INF, device=q.device)
        # In a split with no valid position m = -1e30 and exp(0) = 1: mask p too.
        p = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bngs,bsnd->bngd", p, v[:, lo:hi].float()))
    m_all = torch.stack(ms).amax(0)
    l_tot = torch.zeros_like(m_all)
    acc = torch.zeros((b, hkv, g, dv), device=q.device)
    for m, l, a in zip(ms, ls, accs):
        f = torch.exp(m - m_all)
        l_tot = l_tot + f * l
        acc = acc + f[..., None] * a
    return (acc / l_tot[..., None]).reshape(b, h, dv).to(q.dtype)
