"""Crossbar DC circuit solver — the "SPICE engine" of IMAC-Sim.

A crossbar partition with M row wires and N column wires, per-segment
wire resistance, row drivers behind a source resistance and column TIAs
(virtual grounds) forms a 2MN-node linear resistive network.

Holding the column node voltages fixed, every row is an independent
tridiagonal system (wire chain + memristor loads); symmetrically for
columns. Alternating batched tridiagonal (Thomas) solves is a block
Gauss–Seidel on a symmetric diagonally-dominant M-matrix, over-relaxed
(SOR) on the column voltages. All rows × all tiles × all samples solve
in one batched kernel call per half-sweep.

How the solve runs is chosen by `SolveOptions` through the registry in
`repro_torch.core.backends`: ``"tridiag"`` (default) drives the sweep
loop here with the `tridiag` kernel as the inner solve; ``"fused"``
hands the whole loop to the `gs_fused` kernel.

`solve_dense_mna` is the small-array oracle (full MNA matrix +
`torch.linalg.solve`), for tests only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.backends import SolverBackend, TridiagFn, get_backend


@dataclasses.dataclass(frozen=True)
class CircuitParams:
    """Electrical parameters of one crossbar tile's periphery + wires.

    The electrical fields may be python floats or tensors with leading
    batch axes (e.g. (C,) per-config values of a stacked sweep).

    Attributes:
      r_row: row-wire resistance per bitcell segment (ohms).
      r_col: column-wire resistance per segment (ohms).
      r_source: row driver output resistance (ohms).
      r_tia: TIA input resistance / virtual-ground quality (ohms).
      gs_iters: block Gauss–Seidel sweep budget.
      omega: SOR over-relaxation factor (1.0 = plain Gauss–Seidel).
      tol: >0: stop sweeping once the batch-global max |Δvc| < tol (V).
    """

    r_row: "float | torch.Tensor" = 13.8
    r_col: "float | torch.Tensor" = 13.8
    r_source: "float | torch.Tensor" = 100.0
    r_tia: "float | torch.Tensor" = 10.0
    gs_iters: int = 64
    omega: "float | torch.Tensor" = 1.8
    tol: float = 0.0

    @property
    def g_row(self):
        return 1.0 / self.r_row

    @property
    def g_col(self):
        return 1.0 / self.r_col

    @property
    def g_source(self):
        return 1.0 / self.r_source

    @property
    def g_tia(self):
        return 1.0 / self.r_tia


class CrossbarSolution(NamedTuple):
    """Solved node voltages and outputs of a crossbar tile batch."""

    i_out: torch.Tensor     # (..., N) column currents into the TIAs
    vr: torch.Tensor        # (..., M, N) row-wire node voltages
    vc: torch.Tensor        # (..., M, N) column-wire node voltages
    residual: torch.Tensor  # (...) last sweep's max |Δvc| per system
    # Sweeps actually run: the trip count under the tol early exit (a
    # batch-global condition, so the whole batch sweeps together), else
    # the gs_iters budget.
    sweeps: int = 0


@dataclasses.dataclass(frozen=True)
class Stamps:
    """Companion-model stamps added to the crossbar MNA assembly.

    All fields are optional (None = absent) and, when present, broadcast
    against the solve's ``(..., M, N)`` batch.

    Attributes:
      g_shunt_row: per-node extra conductance to ground on row-wire nodes.
      g_shunt_col: same, on column-wire nodes.
      i_inj_row: per-node current injection into row-wire nodes.
      i_inj_col: same, into column-wire nodes.
      v_init: initial column-node voltages (warm start).
    """

    g_shunt_row: Optional[torch.Tensor] = None
    g_shunt_col: Optional[torch.Tensor] = None
    i_inj_row: Optional[torch.Tensor] = None
    i_inj_col: Optional[torch.Tensor] = None
    v_init: Optional[torch.Tensor] = None

    def fields(self) -> "tuple[Optional[torch.Tensor], ...]":
        return (
            self.g_shunt_row,
            self.g_shunt_col,
            self.i_inj_row,
            self.i_inj_col,
            self.v_init,
        )


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """How to run the solve (not what to solve).

    Attributes:
      backend: a registry name (``"tridiag"``, ``"fused"``), a
        `SolverBackend`, a bare TridiagFn, or None for
        `backends.default_backend_name()` ($REPRO_SOLVER_BACKEND or
        ``"tridiag"``).
    """

    backend: Union[str, SolverBackend, TridiagFn, None] = None

    def resolved(self) -> SolverBackend:
        return get_backend(self.backend)


DEFAULT_OPTIONS = SolveOptions()


def _align(value, ndim: int, dtype=None, device=None) -> torch.Tensor:
    """Align a circuit scalar against a tensor of rank `ndim`.

    Electrical parameters may be python floats or tensors with leading
    batch axes (e.g. (C,) per-config resistances). Leading-axis tensors
    are reshaped so their axes line up with the target's *leading* axes
    and broadcast over the rest.
    """
    v = torch.as_tensor(value, dtype=dtype, device=device)
    if v.ndim == 0 or v.ndim == ndim:
        return v
    return v.reshape(tuple(v.shape) + (1,) * (ndim - v.ndim))


def _row_system(
    g: torch.Tensor,
    vc: torch.Tensor,
    v_in: torch.Tensor,
    cp: CircuitParams,
    g_shunt=None,
    i_inj=None,
):
    """Tridiagonal systems for all rows given column voltages.

    g, vc: (..., M, N); v_in: (..., M). Systems run along N. The
    off-diagonals are returned as broadcast views of -g_row (read only).
    """
    n = g.shape[-1]
    dtype, device = g.dtype, g.device
    g_row = _align(cp.g_row, g.ndim, dtype, device)
    g_source = _align(cp.g_source, g.ndim, dtype, device)
    if n == 1:
        chain = g_source
    else:
        idx = torch.arange(n, device=device)
        chain = torch.where(
            idx == 0,
            g_row + g_source,
            torch.where(idx == n - 1, g_row, 2.0 * g_row),
        )
    d = chain + g
    if g_shunt is not None:
        d = d + g_shunt
    off = torch.broadcast_to(-g_row, g.shape)
    b = g * vc
    # The driver enters column 0 of each row: an out-of-place add.
    src = _align(cp.g_source, g.ndim - 1, dtype, device) * v_in
    b = b + F.pad(src[..., None], (0, n - 1))
    if i_inj is not None:
        b = b + i_inj
    return off, d, off, b


def _col_system(
    g: torch.Tensor,
    vr: torch.Tensor,
    cp: CircuitParams,
    g_shunt=None,
    i_inj=None,
):
    """Tridiagonal systems for all columns given row voltages.

    Transposed view: systems run along M. g, vr: (..., M, N); stamps in
    the untransposed layout. Returns tensors shaped (..., N, M).
    """
    m = g.shape[-2]
    dtype, device = g.dtype, g.device
    gt = g.transpose(-1, -2)     # (..., N, M)
    vrt = vr.transpose(-1, -2)
    g_col = _align(cp.g_col, gt.ndim, dtype, device)
    g_tia = _align(cp.g_tia, gt.ndim, dtype, device)
    if m == 1:
        chain = g_tia
    else:
        idx = torch.arange(m, device=device)
        chain = torch.where(
            idx == 0,
            g_col,
            torch.where(idx == m - 1, g_col + g_tia, 2.0 * g_col),
        )
    d = chain + gt
    if g_shunt is not None:
        d = d + g_shunt.transpose(-1, -2)
    off = torch.broadcast_to(-g_col, gt.shape)
    b = gt * vrt  # TIA node is grounded: no extra rhs term.
    if i_inj is not None:
        b = b + i_inj.transpose(-1, -2)
    return off, d, off, b


def solve_crossbar(
    g: torch.Tensor,
    v_in: torch.Tensor,
    cp: CircuitParams,
    *,
    stamps: Optional[Stamps] = None,
    options: Optional[SolveOptions] = None,
) -> CrossbarSolution:
    """Solve crossbar tiles (DC, or one implicit transient step).

    The electrical fields of `cp` may be python floats or tensors with
    leading batch axes aligned to g's leading axes; `gs_iters` and `tol`
    are plain numbers. The ``"fused"`` backend runs the full `gs_iters`
    budget and ignores `tol`; the ``"tridiag"`` backend honours it.

    Args:
      g: (..., M, N) memristor conductances (S). 0 = absent device.
      v_in: (..., M) driver voltages behind r_source.
      cp: circuit parameters.
      stamps: optional companion-model stamps / warm start.
      options: backend selection.

    Returns:
      CrossbarSolution; i_out[..., j] = current into column j's TIA.
    """
    backend = (options or DEFAULT_OPTIONS).resolved()
    if backend.make_solve is not None:
        return backend.make_solve(options)(g, v_in, cp, stamps)
    return _sweep_solve(g, v_in, cp, backend.make_tridiag(options), stamps)


def _sweep_solve(
    g: torch.Tensor,
    v_in: torch.Tensor,
    cp: CircuitParams,
    tridiag: TridiagFn,
    stamps: Optional[Stamps],
) -> CrossbarSolution:
    """The generic sweep loop: batched inner tridiag + SOR in torch."""
    st = stamps or Stamps()
    m, n = g.shape[-2], g.shape[-1]
    batch = torch.broadcast_shapes(
        g.shape[:-2],
        v_in.shape[:-1],
        *(x.shape[:-2] for x in st.fields() if x is not None),
    )
    g = g.expand(batch + (m, n))
    v_in = v_in.expand(batch + (m,))
    vc = (
        torch.zeros(g.shape, dtype=g.dtype, device=g.device)
        if st.v_init is None
        else st.v_init.to(g.dtype).expand(g.shape)
    )
    omega = _align(cp.omega, g.ndim, g.dtype, g.device)

    def sweep(vc):
        dl, d, du, b = _row_system(g, vc, v_in, cp, st.g_shunt_row, st.i_inj_row)
        vr = tridiag(dl, d, du, b)
        dl, d, du, b = _col_system(g, vr, cp, st.g_shunt_col, st.i_inj_col)
        vct = tridiag(dl, d, du, b)
        return vr, vct.transpose(-1, -2)

    def relax(vc):
        _, vc_gs = sweep(vc)
        vc_new = vc + omega * (vc_gs - vc)
        res = torch.amax(torch.abs(vc_new - vc), dim=(-1, -2))
        return vc_new, res

    residual = torch.full(batch, math.inf, dtype=g.dtype, device=g.device)
    if cp.tol > 0.0:
        # Early exit on the batch-global max residual, checked before
        # every sweep as the reference's while_loop does. Reading the
        # max is one host sync per sweep.
        sweeps = 0
        while sweeps < cp.gs_iters and float(torch.max(residual)) > cp.tol:
            vc, residual = relax(vc)
            sweeps += 1
    else:
        for _ in range(cp.gs_iters):
            vc, residual = relax(vc)
        sweeps = int(cp.gs_iters)
    vr, vc = sweep(vc)  # final row solve consistent with converged vc
    i_out = _align(cp.g_tia, vc.ndim - 1, g.dtype, g.device) * vc[..., m - 1, :]
    return CrossbarSolution(
        i_out=i_out, vr=vr, vc=vc, residual=residual, sweeps=sweeps
    )


def suggest_iters(m: int, n: int) -> int:
    """Sweeps needed for <~1e-3 relative output error (empirical). The GS
    rate degrades as total device conductance per line approaches the
    wire conductance, which scales with line length."""
    return max(48, int(0.75 * max(m, n)))


def solve_ideal(g: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
    """Ideal crossbar (no parasitics): i_out = g^T v. (..., M, N) x (..., M)."""
    return torch.einsum("...mn,...m->...n", g, v_in)


# ---------------------------------------------------------------------------
# Dense MNA oracle (small arrays; tests only).
# ---------------------------------------------------------------------------


def mna_system(
    g: torch.Tensor,
    v_in: torch.Tensor,
    cp: CircuitParams,
    stamps: "Stamps | None" = None,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Dense-MNA assembly of one tile: (A, rhs) with A (2MN, 2MN).

    Node order: row nodes r(i,j) = i*N+j first, then column nodes
    c(i,j) = M*N + i*N + j. Ground (TIA virtual ground, source return)
    is eliminated. Optional `stamps` add per-node shunts on the diagonal
    and injections on the right-hand side (`v_init` is ignored).
    """
    m, n = g.shape
    mn = m * n
    nn = 2 * mn
    dtype, device = g.dtype, g.device
    a = torch.zeros((nn, nn), dtype=dtype, device=device)
    rhs = torch.zeros((nn,), dtype=dtype, device=device)

    def stamp(p, q, cond):
        a[p, p] += cond
        a[q, q] += cond
        a[p, q] -= cond
        a[q, p] -= cond

    for i in range(m):  # row wires
        for j in range(n - 1):
            stamp(i * n + j, i * n + j + 1, cp.g_row)
    for j in range(n):  # column wires
        for i in range(m - 1):
            stamp(mn + i * n + j, mn + (i + 1) * n + j, cp.g_col)
    for i in range(m):  # memristors
        for j in range(n):
            stamp(i * n + j, mn + i * n + j, g[i, j])
    for i in range(m):  # sources, to v_in through g_source
        a[i * n, i * n] += cp.g_source
        rhs[i * n] += cp.g_source * v_in[i]
    for j in range(n):  # TIAs, to ground through g_tia
        p = mn + (m - 1) * n + j
        a[p, p] += cp.g_tia
    if stamps is not None:
        diag = torch.arange(nn, device=device)
        for block, g_sh, i_inj in (
            (slice(0, mn), stamps.g_shunt_row, stamps.i_inj_row),
            (slice(mn, nn), stamps.g_shunt_col, stamps.i_inj_col),
        ):
            if g_sh is not None:
                flat = torch.broadcast_to(g_sh.to(dtype), (m, n)).reshape(mn)
                a[diag[block], diag[block]] += flat
            if i_inj is not None:
                flat = torch.broadcast_to(i_inj.to(dtype), (m, n)).reshape(mn)
                rhs[block] += flat
    return a, rhs


def solve_dense_mna(
    g: torch.Tensor,
    v_in: torch.Tensor,
    cp: CircuitParams,
    stamps: "Stamps | None" = None,
) -> CrossbarSolution:
    """Oracle: full MNA solve of one tile. g: (M, N), v_in: (M,)."""
    m, n = g.shape
    a, rhs = mna_system(g, v_in, cp, stamps)
    x = torch.linalg.solve(a, rhs)
    vr = x[: m * n].reshape(m, n)
    vc = x[m * n :].reshape(m, n)
    i_out = cp.g_tia * vc[m - 1, :]
    return CrossbarSolution(
        i_out=i_out,
        vr=vr,
        vc=vc,
        residual=torch.zeros((), dtype=g.dtype, device=g.device),
        sweeps=0,
    )


# ---------------------------------------------------------------------------
# Power extraction from a solved tile.
# ---------------------------------------------------------------------------


def crossbar_power(
    g: torch.Tensor,
    v_in: torch.Tensor,
    sol: CrossbarSolution,
    cp: CircuitParams,
) -> torch.Tensor:
    """Total dissipated power (W) of solved tiles; reduces last two dims."""
    vr, vc = sol.vr, sol.vc
    dtype, device = vr.dtype, vr.device
    p_dev = torch.sum(g * (vr - vc) ** 2, dim=(-1, -2))
    ndim = p_dev.ndim
    dr = torch.diff(vr, dim=-1)
    p_row = _align(cp.g_row, ndim, dtype, device) * torch.sum(dr**2, dim=(-1, -2))
    dc = torch.diff(vc, dim=-2)
    p_col = _align(cp.g_col, ndim, dtype, device) * torch.sum(dc**2, dim=(-1, -2))
    p_src = _align(cp.g_source, ndim, dtype, device) * torch.sum(
        (v_in - vr[..., :, 0]) ** 2, dim=-1
    )
    p_tia = _align(cp.g_tia, ndim, dtype, device) * torch.sum(
        vc[..., -1, :] ** 2, dim=-1
    )
    return p_dev + p_row + p_col + p_src + p_tia


def ideal_power(g: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
    """Power of the ideal crossbar (columns at virtual ground)."""
    return torch.einsum("...mn,...m->...", g, v_in**2)
