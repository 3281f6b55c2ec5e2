"""Plain torch version of the quantised differential analog MVM.

Semantics (normalised units; `ops.analog_linear` maps device physics
onto these), as the reference's `imac_mvm/ref.py`:
  * inputs x in [0, 1] are DAC-quantised to 2^dac_bits - 1 uniform steps,
  * weights w in [-1, 1] are programmed as a differential conductance
    pair on `levels` uniform levels; the effective weight is
    sign(w) * Q_levels(|w|) (sign(0) = 0),
  * y = DAC(x) @ Q(w), accumulated in float32.

Rounding is half to even (`torch.round`), and both quantisers divide
(`round(x * n) / n`, `round(|w| / step) * step`) as the reference's
ref.py does; the CUDA kernel uses the same form. Every divisor is a
tensor, not a Python number: on CUDA, torch divides by a Python number
by multiplying with its reciprocal, which can differ by one ulp and flip
a level at a .5 boundary.
"""
from __future__ import annotations

import torch


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def dac_quant(x: torch.Tensor, dac_bits: int) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    if dac_bits <= 0:
        return x
    n = (1 << dac_bits) - 1
    return torch.round(x * n) / _const(n, x)


def weight_quant(w: torch.Tensor, levels: int) -> torch.Tensor:
    w = torch.clamp(w, -1.0, 1.0)
    if levels <= 1:
        return w
    # The reference's step is a Python float (double) rounded to float32.
    step = _const(1.0 / (levels - 1), w)
    return torch.sign(w) * torch.round(torch.abs(w) / step) * step


def imac_mvm_ref(
    x: torch.Tensor, w: torch.Tensor, *, dac_bits: int = 8, levels: int = 16
) -> torch.Tensor:
    """x: (M, K) in [0, 1]; w: (K, N) in [-1, 1] -> (M, N) float32."""
    xq = dac_quant(x.float(), dac_bits)
    wq = weight_quant(w.float(), levels)
    return xq @ wq
