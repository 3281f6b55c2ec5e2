"""Wrapper of the `imac_mvm` CUDA kernel, and `analog_linear` on top of it.

`imac_mvm` computes ``DAC(x) @ Q(w)`` (see `ref.py`): for CPU tensors it
runs the plain version, for CUDA tensors it launches the kernel through
`imac_mvm_2d`, or raises. There is no fallback from the kernel to the
plain version. The kernel masks the ragged M/K/N edges itself, so
nothing is padded (the reference pads to 128-wide tiles).

`analog_linear` is the substrate's AnalogLinear: y = x @ w + b simulated
on ideal analog crossbars, with the reference's per-call normalisation.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.devices import DeviceTech, get_tech
from repro_torch.kernels import _build
from repro_torch.kernels.imac_mvm.ref import imac_mvm_ref

#: Kernel launches made by `imac_mvm_2d` in this process.
launches = 0

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_signature_set = False


def _lib() -> ctypes.CDLL:
    global _signature_set
    lib = _build.load("imac_mvm")
    if not _signature_set:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.imac_mvm_launch.argtypes = [
            ptr, i32, ptr, ptr, i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr,
        ]
        lib.imac_mvm_launch.restype = ctypes.c_int
        _signature_set = True
    return lib


def quant_args(dac_bits: int, levels: int) -> "tuple[int, int, float]":
    """The kernel's quantiser arguments: (DAC steps, levels, level step).

    DAC steps is 2^dac_bits - 1, or 0 for clipping only. The level step
    is 1/(levels - 1) computed in double and rounded to float32, as the
    reference's Python-float step is.
    """
    dac_n = (1 << dac_bits) - 1 if dac_bits > 0 else 0
    step = 1.0 / (levels - 1) if levels > 1 else 0.0
    return dac_n, levels, step


def imac_mvm_2d(
    x: torch.Tensor, w: torch.Tensor, *, dac_bits: int = 8, levels: int = 16
) -> torch.Tensor:
    """Launch the kernel: x (M, K) float32 or bfloat16, w (K, N) float32,
    both contiguous CUDA tensors -> (M, N) float32."""
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"imac_mvm: x on {x.device}, w on {w.device}; the kernel needs "
                         "both on one CUDA device")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"imac_mvm: x is {x.dtype}, the kernel takes float32 or bfloat16")
    if w.dtype != torch.float32:
        raise TypeError(f"imac_mvm: w is {w.dtype}, the kernel takes float32")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"imac_mvm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("imac_mvm: x and w must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    if (m + 63) // 64 > 65535:
        raise ValueError(f"imac_mvm: {m} rows exceed the kernel's grid (65535 row tiles)")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    dac_n, lv, step = quant_args(dac_bits, levels)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().imac_mvm_launch(
        x.data_ptr(), _X_DTYPES[x.dtype], w.data_ptr(), y.data_ptr(),
        m, k, n, dac_n, lv, step, x.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"imac_mvm kernel launch failed with CUDA error {err}")
    launches += 1
    return y


def imac_mvm(
    x: torch.Tensor, w: torch.Tensor, *, dac_bits: int = 8, levels: int = 16
) -> torch.Tensor:
    """Quantised differential analog MVM. x: (..., K) in [0, 1] digital
    units; w: (K, N) in [-1, 1] normalised weights. Returns float32 (..., N)."""
    if w.ndim != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"imac_mvm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = imac_mvm_ref(xf, w, dac_bits=dac_bits, levels=levels)
    elif x.device.type == "cuda":
        y = imac_mvm_2d(xf.contiguous(), w.contiguous(), dac_bits=dac_bits, levels=levels)
    else:
        raise ValueError(f"imac_mvm: unsupported device {x.device}")
    return y.reshape(*lead, w.shape[1])


def analog_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    tech: "DeviceTech | str" = "PCM",
    *,
    dac_bits: int = 8,
    levels: Optional[int] = None,
    noise: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Drop-in y = x @ w + b simulated on ideal analog crossbars.

    As the reference: activations are normalised into [0, 1] by one
    global min/max over the whole call (dynamic-range DAC), weights into
    [-1, 1] by ``max|w| + 1e-12``; the technology sets the level count
    (``levels or tech.levels or 16``) and the read noise, which is drawn
    only when a generator is passed as `noise`. Returns x's dtype.
    """
    tech = get_tech(tech)
    levels = levels or tech.levels or 16
    w_scale = torch.linalg.vector_norm(w, ord=float("inf")) + 1e-12   # max|w|, one pass
    x_lo = torch.min(x)
    x_hi = torch.max(x)
    x_rng = torch.clamp_min(x_hi - x_lo, 1e-12)
    xn = (x - x_lo) / x_rng
    wn = w / w_scale
    y = imac_mvm(xn, wn, dac_bits=dac_bits, levels=levels)
    # Undo normalisation: x = xn*rng + lo -> x@w = (xn@wn)*rng*scale + lo*colsum.
    colsum = torch.sum(w, dim=0)
    y = y * (x_rng * w_scale) + x_lo * colsum
    if noise is not None and tech.read_noise_rel > 0:
        y = y + tech.read_noise_rel * torch.abs(y) * torch.randn(
            y.shape, generator=noise, dtype=y.dtype, device=y.device
        )
    if b is not None:
        y = y + b
    return y.to(x.dtype)
