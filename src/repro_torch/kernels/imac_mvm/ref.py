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

With integer quantisers (dac_bits >= 1, levels >= 2) the product is an
integer one: `dac_levels` and `weight_levels` give the levels (the same
ops as the quantisers, without the final scale), and
`imac_mvm_levels_ref` forms their exact sum and scales it once. It is
the plain version of the kernel's integer route, which equals it bit
for bit.
"""
from __future__ import annotations

import struct

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


def dac_levels(x: torch.Tensor, dac_bits: int) -> torch.Tensor:
    """The DAC levels round(clip(x, 0, 1) * n), n = 2^dac_bits - 1, as
    float32 integers: ``dac_levels(x, b) / n`` is ``dac_quant(x, b)``."""
    if dac_bits <= 0:
        raise ValueError("dac_levels: clipping only (dac_bits <= 0) has no levels")
    return torch.round(torch.clamp(x, 0.0, 1.0) * ((1 << dac_bits) - 1))


def weight_levels(w: torch.Tensor, levels: int) -> torch.Tensor:
    """The weight levels sign(w) * round(|w| / step) after clip(w, -1, 1),
    as float32 integers: ``weight_levels(w, lv) * step`` is
    ``weight_quant(w, lv)``."""
    if levels <= 1:
        raise ValueError("weight_levels: clipping only (levels <= 1) has no levels")
    w = torch.clamp(w, -1.0, 1.0)
    step = _const(1.0 / (levels - 1), w)
    return torch.sign(w) * torch.round(torch.abs(w) / step)


def level_scale(dac_bits: int, levels: int) -> float:
    """c = float64(step) / n: one integer level product in output units,
    with the level step rounded to float32 as the quantisers use it."""
    step = struct.unpack("f", struct.pack("f", 1.0 / (levels - 1)))[0]
    return step / ((1 << dac_bits) - 1)


def imac_mvm_ref(
    x: torch.Tensor, w: torch.Tensor, *, dac_bits: int = 8, levels: int = 16
) -> torch.Tensor:
    """x: (M, K) in [0, 1]; w: (K, N) in [-1, 1] -> (M, N) float32."""
    xq = dac_quant(x.float(), dac_bits)
    wq = weight_quant(w.float(), levels)
    return xq @ wq


def imac_mvm_levels_ref(
    x: torch.Tensor, w: torch.Tensor, *, dac_bits: int = 8, levels: int = 16
) -> torch.Tensor:
    """The integer form of `imac_mvm_ref`: float32 (M, N) =
    float(float64(dac_levels(x) @ weight_levels(w)) * c).

    The level products sum exactly in float64 (every partial sum is an
    integer below 2^53 for the kernel's levels and K), so the result is
    the correctly rounded value of the exact sum in any order, on the CPU
    or the card. A NaN in a row of x or a column of w gives NaN there.
    """
    isum = dac_levels(x.float(), dac_bits).double() @ weight_levels(w.float(), levels).double()
    return (isum * level_scale(dac_bits, levels)).float()
