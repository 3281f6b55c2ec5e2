"""Plain torch version of the fused Gauss–Seidel sweep loop.

`gs_fused_ref` computes what the `gs_fused` kernel computes, on the same
inputs, as Python loops over the unknowns of vectorised ops over the
batch. `_thomas_coeffs` precomputes the sweep-invariant Thomas
coefficients both versions consume. The kernel's wrapper runs
`gs_fused_ref` for CPU tensors, and the kernel is held against it on the
card.
"""
from __future__ import annotations

import math

import torch


def _thomas_coeffs(d: torch.Tensor, off) -> "tuple[torch.Tensor, torch.Tensor]":
    """Sweep-invariant Thomas forward coefficients along the last axis.

    For systems with constant off-diagonals ``off`` (dl = du = off;
    dl[..., 0] / du[..., -1] unused) and diagonal ``d``, returns
    ``(cp, inv_den)`` such that forward elimination reduces to
    ``dp_j = (b_j - off * dp_{j-1}) * inv_den_j`` and back-substitution
    to ``x_j = dp_j - cp_j * x_{j+1}`` — no divisions left in the sweeps.
    """
    off_b = torch.broadcast_to(torch.as_tensor(off, dtype=d.dtype, device=d.device), d.shape)
    inv = 1.0 / d[..., 0]
    cps, invs = [off_b[..., 0] * inv], [inv]
    for j in range(1, d.shape[-1]):
        inv = 1.0 / (d[..., j] - off_b[..., j] * cps[-1])
        cps.append(off_b[..., j] * inv)
        invs.append(inv)
    return torch.stack(cps, dim=-1), torch.stack(invs, dim=-1)


def gs_fused_ref(
    g: torch.Tensor,
    src: torch.Tensor,
    injc: torch.Tensor,
    cpr: torch.Tensor,
    idr: torch.Tensor,
    cpc: torch.Tensor,
    idc: torch.Tensor,
    odr: torch.Tensor,
    odc: torch.Tensor,
    om: torch.Tensor,
    vc0: torch.Tensor,
    *,
    sweeps: int,
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """The fused SOR block Gauss–Seidel solve of B systems.

    Args:
      g: (B, M, N) device conductances.
      src: (B, M, N) row right-hand-side sources (driver + row injection).
      injc: (B, M, N) column right-hand-side injections.
      cpr, idr: (B, M, N) row-system cp / inv_den (along N).
      cpc, idc: (B, M, N) column-system cp / inv_den (along M).
      odr, odc: (B,) row / column off-diagonals (-g_row, -g_col).
      om: (B,) SOR factors.
      vc0: (B, M, N) initial column voltages.
      sweeps: relaxed sweeps to run (then one un-relaxed sweep).

    Returns:
      (vr, vc, res): (B, M, N), (B, M, N) and the last relaxed sweep's
      max |Δvc| per system, (B,) (inf when sweeps == 0).
    """
    m, n = g.shape[-2], g.shape[-1]
    a_r = odr[:, None]          # (B, 1) over the rows of one column step
    a_c = odc[:, None]          # (B, 1) over the columns of one row step
    w = om[:, None, None]

    def row_solve(vcs):
        bt = g * vcs + src
        dp = [bt[..., 0] * idr[..., 0]]
        for j in range(1, n):
            dp.append((bt[..., j] - a_r * dp[-1]) * idr[..., j])
        x = [dp[-1]]
        for j in range(n - 2, -1, -1):
            x.append(dp[j] - cpr[..., j] * x[-1])
        return torch.stack(x[::-1], dim=-1)

    def col_solve(vr):
        bc = g * vr + injc
        dp = [bc[:, 0, :] * idc[:, 0, :]]
        for i in range(1, m):
            dp.append((bc[:, i, :] - a_c * dp[-1]) * idc[:, i, :])
        x = [dp[-1]]
        for i in range(m - 2, -1, -1):
            x.append(dp[i] - cpc[:, i, :] * x[-1])
        return torch.stack(x[::-1], dim=-2)

    vcs = vc0
    res = torch.full(g.shape[:1], math.inf, dtype=g.dtype, device=g.device)
    for _ in range(sweeps):
        vc_gs = col_solve(row_solve(vcs))
        vc_new = vcs + w * (vc_gs - vcs)
        res = torch.amax(torch.abs(vc_new - vcs), dim=(-1, -2))
        vcs = vc_new
    vr = row_solve(vcs)
    return vr, col_solve(vr), res
