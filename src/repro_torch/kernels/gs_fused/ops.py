"""Wrapper of the `gs_fused` CUDA kernel: the ``"fused"`` solver backend.

`fused_solve` assembles the sweep-invariant tridiagonal coefficients of
the crossbar's segment-RC network — companion `Stamps` included —,
precomputes the Thomas multipliers and inverse denominators once per
solve, flattens every leading batch axis into one system axis and runs
`gs_fused`: the plain version (`ref.gs_fused_ref`) for CPU tensors, the
kernel for CUDA tensors. It runs exactly ``cp.gs_iters`` sweeps and
ignores ``cp.tol``, as the reference's fused backend does.

Residency limit. The kernel keeps `SMEM_BUFFERS` buffers of M x (N | 1)
floats per system in shared memory, plus a 32-float reduction buffer.
A tile that needs more than the device's opt-in shared memory per block
(`cudaDevAttrMaxSharedMemoryPerBlockOptin`, 227 KB on H100) is solved by
the ``"tridiag"`` backend instead — the per-half-sweep `tridiag` kernel —
as the reference falls back to ``"pallas"``. Each fallback is counted in
`fallbacks` and the first one is logged. CPU tensors are held to the
H100's limit so that the same tiles fall back on either device.
"""
from __future__ import annotations

import ctypes
import logging
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gs_fused.ref import _thomas_coeffs, gs_fused_ref

logger = logging.getLogger(__name__)

#: Kernel launches made by `gs_fused` in this process.
launches = 0
#: Solves sent to the "tridiag" backend past the residency limit.
fallbacks = 0

#: Shared buffers of M x (N | 1) floats the kernel keeps per system.
SMEM_BUFFERS = 10
#: Static shared memory of the kernel's block reduction (bytes).
SMEM_STATIC_BYTES = 32 * 4
#: cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100 (bytes).
H100_SMEM_OPTIN_BYTES = 232_448

_signature_set = False
_fallback_logged = False


def _lib() -> ctypes.CDLL:
    global _signature_set
    lib = _build.load("gs_fused")
    if not _signature_set:
        ptr = ctypes.c_void_p
        lib.gs_fused_launch.argtypes = [ptr] * 14 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ptr,
        ]
        lib.gs_fused_launch.restype = ctypes.c_int
        lib.gs_fused_max_smem.argtypes = [ctypes.c_int]
        lib.gs_fused_max_smem.restype = ctypes.c_int
        lib.gs_fused_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.gs_fused_smem_bytes.restype = ctypes.c_longlong
        _signature_set = True
    return lib


def smem_bytes(m: int, n: int) -> int:
    """Shared memory one block needs for an m x n tile (bytes)."""
    return 4 * SMEM_BUFFERS * m * (n | 1) + SMEM_STATIC_BYTES


def smem_limit(device: torch.device) -> int:
    """Opt-in shared memory per block of `device` (the H100's for the CPU)."""
    if device.type == "cpu":
        return H100_SMEM_OPTIN_BYTES
    value = _lib().gs_fused_max_smem(device.index if device.index is not None else 0)
    if value < 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed with CUDA error {-value}")
    return value


def fits(m: int, n: int, device: torch.device) -> bool:
    """Whether an m x n tile stays resident in one block's shared memory."""
    return smem_bytes(m, n) <= smem_limit(device)


_MN_ARGS = ("g", "src", "injc", "cpr", "idr", "cpc", "idc")
_SCALAR_ARGS = ("odr", "odc", "om")


def gs_fused(
    g, src, injc, cpr, idr, cpc, idc, odr, odc, om, vc0, *, sweeps: int
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """The fused sweep loop over B systems (see `ref.gs_fused_ref`).

    (B, M, N) tensors: g, src, injc, cpr, idr, cpc, idc, vc0; (B,)
    tensors: odr, odc, om. CPU tensors take the plain version; CUDA
    tensors must be float32 and contiguous, and launch the kernel.

    Returns:
      (vr, vc, res): (B, M, N), (B, M, N), (B,).
    """
    global launches
    args = (g, src, injc, cpr, idr, cpc, idc, odr, odc, om, vc0)
    if g.device.type == "cpu":
        return gs_fused_ref(*args, sweeps=sweeps)
    if g.device.type != "cuda":
        raise ValueError(f"gs_fused: unsupported device {g.device}")
    if g.ndim != 3:
        raise ValueError(f"gs_fused: g has shape {tuple(g.shape)}, expected (B, M, N)")
    batch, m, n = g.shape
    names = _MN_ARGS + _SCALAR_ARGS + ("vc0",)
    for name, t in zip(names, args):
        want = (batch,) if name in _SCALAR_ARGS else (batch, m, n)
        if t.device != g.device:
            raise ValueError(f"gs_fused: {name} on {t.device}, expected {g.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gs_fused: {name} is {t.dtype}, the kernel takes float32")
        if tuple(t.shape) != want:
            raise ValueError(f"gs_fused: {name} has shape {tuple(t.shape)}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"gs_fused: {name} must be contiguous")
    if not fits(m, n, g.device):
        raise ValueError(
            f"gs_fused: a {m}x{n} tile needs {smem_bytes(m, n)} bytes of shared "
            f"memory, more than the {smem_limit(g.device)} one block may use"
        )
    vr = torch.empty_like(g)
    vc = torch.empty_like(g)
    res = torch.empty_like(odr)
    if batch == 0:
        return vr, vc, res
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = _lib().gs_fused_launch(
        *(t.data_ptr() for t in args),
        vr.data_ptr(), vc.data_ptr(), res.data_ptr(),
        m, n, int(sweeps), batch, g.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"gs_fused kernel launch failed with CUDA error {err}")
    launches += 1
    return vr, vc, res


def prepare(g, v_in, cp, stamps=None):
    """Host-side preparation of the fused solve.

    Broadcasts the batch, assembles the row / column diagonals (wire
    chain + devices + companion shunts, as `solver._row_system` /
    `_col_system` do), precomputes their Thomas coefficients and the
    right-hand-side constants, and flattens the batch.

    Returns:
      (batch, args): the broadcast batch shape and the tuple of `gs_fused`
      positional arguments, all contiguous.
    """
    from repro_torch.core.solver import Stamps, _align

    st = stamps or Stamps()
    m, n = g.shape[-2], g.shape[-1]
    dtype, device = g.dtype, g.device
    batch = torch.broadcast_shapes(
        g.shape[:-2],
        v_in.shape[:-1],
        *(x.shape[:-2] for x in st.fields() if x is not None),
    )
    nd = len(batch) + 2
    g_b = g.expand(batch + (m, n))
    v_b = v_in.to(dtype).expand(batch + (m,))

    def scal(value):
        """Electrical scalar -> per-system (..., 1, 1) tensor."""
        return _align(value, nd, dtype, device).expand(batch + (1, 1))

    g_row, g_col = scal(cp.g_row), scal(cp.g_col)
    g_source, g_tia = scal(cp.g_source), scal(cp.g_tia)
    omega = scal(cp.omega)

    def maybe(x):
        return None if x is None else x.to(dtype).expand(batch + (m, n))

    gsh_row, gsh_col = maybe(st.g_shunt_row), maybe(st.g_shunt_col)
    inj_row, inj_col = maybe(st.i_inj_row), maybe(st.i_inj_col)
    vc0 = maybe(st.v_init)

    idx_n = torch.arange(n, device=device)
    if n == 1:
        chain_r = g_source
    else:
        chain_r = torch.where(
            idx_n == 0,
            g_row + g_source,
            torch.where(idx_n == n - 1, g_row, 2.0 * g_row),
        )
    d_row = chain_r + g_b
    if gsh_row is not None:
        d_row = d_row + gsh_row

    idx_m = torch.arange(m, device=device)[:, None]
    if m == 1:
        chain_c = g_tia
    else:
        chain_c = torch.where(
            idx_m == 0,
            g_col,
            torch.where(idx_m == m - 1, g_col + g_tia, 2.0 * g_col),
        )
    d_col = chain_c + g_b
    if gsh_col is not None:
        d_col = d_col + gsh_col

    cp_row, id_row = _thomas_coeffs(d_row, -g_row)
    cp_colt, id_colt = _thomas_coeffs(d_col.transpose(-1, -2), -g_col)

    zero = torch.zeros((), dtype=dtype, device=device)
    src_row = torch.where(idx_n == 0, g_source * v_b[..., :, None], zero)
    src_row = src_row.expand(batch + (m, n))
    if inj_row is not None:
        src_row = src_row + inj_row
    injc = inj_col if inj_col is not None else torch.zeros(batch + (m, n), dtype=dtype, device=device)
    if vc0 is None:
        vc0 = torch.zeros(batch + (m, n), dtype=dtype, device=device)

    total = math.prod(batch)

    def flat(a):
        return a.reshape(total, m, n).contiguous()

    def flat_scal(a):
        return a.reshape(total).contiguous()

    args = (
        flat(g_b), flat(src_row), flat(injc),
        flat(cp_row), flat(id_row),
        flat(cp_colt.transpose(-1, -2)), flat(id_colt.transpose(-1, -2)),
        flat_scal(-g_row), flat_scal(-g_col), flat_scal(omega),
        flat(vc0),
    )
    return batch, args


def fused_solve(g, v_in, cp, stamps=None):
    """Solve crossbar tiles with the fused multi-sweep kernel.

    Drop-in replacement for the generic sweep loop in
    `repro_torch.core.solver._sweep_solve`: same batching (leading axes
    broadcast, per-config electrical scalars allowed), same companion
    stamps, same final un-relaxed sweep. Runs the full ``cp.gs_iters``
    budget; ``cp.tol`` does not apply.

    Args:
      g: (..., M, N) device conductances.
      v_in: (..., M) driver voltages.
      cp: `CircuitParams` (floats or leading-axis tensors).
      stamps: optional `Stamps`.

    Returns:
      `CrossbarSolution` with ``sweeps == cp.gs_iters``.
    """
    from repro_torch.core.solver import (
        CrossbarSolution,
        SolveOptions,
        _align,
        solve_crossbar,
    )

    global fallbacks, _fallback_logged
    m, n = g.shape[-2], g.shape[-1]
    if not fits(m, n, g.device):
        fallbacks += 1
        if not _fallback_logged:
            _fallback_logged = True
            logger.warning(
                "fused solver backend: a %dx%d tile needs %d bytes of shared "
                "memory, more than one block may use; falling back to the "
                "per-half-sweep 'tridiag' backend.",
                m, n, smem_bytes(m, n),
            )
        return solve_crossbar(
            g, v_in, cp, stamps=stamps, options=SolveOptions(backend="tridiag")
        )

    batch, args = prepare(g, v_in, cp, stamps)
    vr, vc, res = gs_fused(*args, sweeps=int(cp.gs_iters))
    vr = vr.reshape(batch + (m, n))
    vc = vc.reshape(batch + (m, n))
    i_out = _align(cp.g_tia, vc.ndim - 1, g.dtype, g.device) * vc[..., m - 1, :]
    return CrossbarSolution(
        i_out=i_out,
        vr=vr,
        vc=vc,
        residual=res.reshape(batch),
        sweeps=int(cp.gs_iters),
    )
