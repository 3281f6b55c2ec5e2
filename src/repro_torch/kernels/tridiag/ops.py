"""Wrapper of the `tridiag` CUDA kernel (batched Thomas solve).

`tridiag` takes the solver's native (..., N) layout. For CPU tensors it
runs the plain version (`ref.tridiag_ref`); for CUDA tensors it lays the
batch out (N, B) — the transpose the reference's wrapper does, so that
neighbouring threads read neighbouring addresses — and launches the
kernel through `tridiag_nb`, or raises. There is no fallback from the
kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tridiag.ref import tridiag_ref

#: Kernel launches made by `tridiag_nb` in this process.
launches = 0

_signature_set = False


def _lib() -> ctypes.CDLL:
    global _signature_set
    lib = _build.load("tridiag")
    if not _signature_set:
        ptr = ctypes.c_void_p
        lib.tridiag_launch.argtypes = [ptr] * 7 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ptr,
        ]
        lib.tridiag_launch.restype = ctypes.c_int
        _signature_set = True
    return lib


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device or t.device.type != "cuda":
        raise ValueError(f"tridiag: {name} on {t.device}, expected {like.device} (CUDA)")
    if t.dtype != torch.float32:
        raise TypeError(f"tridiag: {name} is {t.dtype}, the kernel takes float32")
    if t.shape != like.shape or t.ndim != 2:
        raise ValueError(f"tridiag: {name} has shape {tuple(t.shape)}, expected {tuple(like.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"tridiag: {name} must be contiguous")


def tridiag_nb(
    dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Launch the kernel on systems laid out (N, B).

    Args:
      dl, d, du, b: (N, B) contiguous float32 CUDA tensors (systems along
        axis 1; dl[0] and du[N-1] ignored).

    Returns:
      x: (N, B) solutions.
    """
    global launches
    for name, t in (("dl", dl), ("du", du), ("b", b), ("d", d)):
        _check(name, t, d)
    n, batch = d.shape
    x = torch.empty_like(d)
    if batch == 0 or n == 0:
        return x
    cp = torch.empty_like(d)
    dp = torch.empty_like(d)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = _lib().tridiag_launch(
        dl.data_ptr(), d.data_ptr(), du.data_ptr(), b.data_ptr(),
        x.data_ptr(), cp.data_ptr(), dp.data_ptr(),
        n, batch, d.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"tridiag kernel launch failed with CUDA error {err}")
    launches += 1
    return x


def tridiag(
    dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Batched tridiagonal solve along the last axis.

    Same semantics as `ref.tridiag_ref` (dl[..., 0] and du[..., -1]
    ignored; inputs broadcast to one (..., N) shape). CPU tensors take
    the plain version; CUDA tensors take the kernel.
    """
    device = d.device
    if device.type == "cpu":
        return tridiag_ref(dl, d, du, b)
    if device.type != "cuda":
        raise ValueError(f"tridiag: unsupported device {device}")
    shape = torch.broadcast_shapes(dl.shape, d.shape, du.shape, b.shape)
    n = shape[-1]
    batch = math.prod(shape[:-1])

    def lanes(a: torch.Tensor) -> torch.Tensor:
        return a.expand(shape).reshape(batch, n).t().contiguous()  # (N, B)

    x = tridiag_nb(lanes(dl), lanes(d), lanes(du), lanes(b))
    return x.t().reshape(shape)
