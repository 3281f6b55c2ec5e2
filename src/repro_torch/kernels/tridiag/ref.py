"""Plain torch version of the batched tridiagonal (Thomas) solve.

The counterpart of the reference's `tridiag_scan`: a Python loop over
the N unknowns of vectorised ops over the batch. The `tridiag` kernel's
wrapper runs it for CPU tensors, and the kernel is held against it on
the card.
"""
from __future__ import annotations

import torch


def tridiag_ref(
    dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Solve tridiagonal systems along the last axis.

    dl[..., 0] and du[..., -1] are ignored. Shapes all broadcast to
    (..., N); returns (..., N).
    """
    shape = torch.broadcast_shapes(dl.shape, d.shape, du.shape, b.shape)
    dl, d, du, b = (t.expand(shape) for t in (dl, d, du, b))
    n = shape[-1]
    if n == 1:
        return b / d
    cp = [du[..., 0] / d[..., 0]]
    dp = [b[..., 0] / d[..., 0]]
    for j in range(1, n):
        dl_j = dl[..., j]
        denom = d[..., j] - dl_j * cp[-1]
        cp.append(du[..., j] / denom)
        dp.append((b[..., j] - dl_j * dp[-1]) / denom)
    x = [dp[n - 1]]
    for j in range(n - 2, -1, -1):
        x.append(dp[j] - cp[j] * x[-1])
    return torch.stack(x[::-1], dim=-1)
