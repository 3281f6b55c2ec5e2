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


def _row_coeffs(g: torch.Tensor, cp: CircuitParams, g_shunt=None):
    """Sweep-invariant coefficients (dl, d, du) of the row systems.

    g: (..., M, N), at whatever broadcast shape it has (the sweep loop
    passes it before the sample expand). Systems run along N. d has the
    broadcast shape of g, the wire chain and `g_shunt`; the off-diagonals
    are -g_row at its aligned shape (a scalar, or (C, 1, ..., 1)).
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
    off = -g_row
    return off, d, off


def _row_drive(g: torch.Tensor, v_in: torch.Tensor, cp: CircuitParams) -> torch.Tensor:
    """The drivers' current into column 0 of each row, g_source * v_in (..., M)."""
    return _align(cp.g_source, g.ndim - 1, g.dtype, g.device) * v_in


def _row_rhs(g: torch.Tensor, vc: torch.Tensor, drive: torch.Tensor,
             i_inj=None) -> torch.Tensor:
    """Right-hand side of the row systems given column voltages (..., M, N)
    and the drivers' current (`_row_drive`)."""
    b = g * vc
    b[..., 0] += drive           # column 0 of each row (b is this function's own)
    if i_inj is not None:
        b = b + i_inj
    return b


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
    off, d, _ = _row_coeffs(g, cp, g_shunt)
    off = torch.broadcast_to(off, g.shape)
    return off, d, off, _row_rhs(g, vc, _row_drive(g, v_in, cp), i_inj)


def _col_coeffs(g: torch.Tensor, cp: CircuitParams, g_shunt=None):
    """Sweep-invariant coefficients (dl, d, du) of the column systems.

    Systems run along M: d is returned as the transposed view (..., N, M)
    of the (..., M, N) sum it is built as (g_shunt in the untransposed
    layout); the off-diagonals are -g_col at its aligned shape.
    """
    m = g.shape[-2]
    dtype, device = g.dtype, g.device
    g_col = _align(cp.g_col, g.ndim, dtype, device)
    g_tia = _align(cp.g_tia, g.ndim, dtype, device)
    if m == 1:
        chain = g_tia
    else:
        idx = torch.arange(m, device=device)[:, None]
        chain = torch.where(
            idx == 0,
            g_col,
            torch.where(idx == m - 1, g_col + g_tia, 2.0 * g_col),
        )
    d = chain + g
    if g_shunt is not None:
        d = d + g_shunt
    off = -g_col
    return off, d.transpose(-1, -2), off


def _col_rhs(g: torch.Tensor, vr: torch.Tensor, i_inj=None) -> torch.Tensor:
    """Right-hand side of the column systems, as the transposed view
    (..., N, M) of its (..., M, N) layout. The TIA node is grounded: no
    extra rhs term."""
    b = g * vr
    if i_inj is not None:
        b = b + i_inj
    return b.transpose(-1, -2)


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
    off, d, _ = _col_coeffs(g, cp, g_shunt)
    off = torch.broadcast_to(off, g.transpose(-1, -2).shape)
    return off, d, off, _col_rhs(g, vr, i_inj)


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


#: Sweeps run between two host reads of the residual under ``tol``.
GROUP_SWEEPS = 8

#: Host reads of the residual made by `_sweep_solve` in this process.
residual_reads = 0


def _sweep_solve(
    g: torch.Tensor,
    v_in: torch.Tensor,
    cp: CircuitParams,
    tridiag: TridiagFn,
    stamps: Optional[Stamps],
) -> CrossbarSolution:
    """The generic sweep loop: batched inner tridiag + SOR in torch.

    The coefficients of both half-sweeps (and the drivers' current) are
    built once, the coefficients at g's own broadcast shape (before the
    sample expand), and handed to `tridiag` as broadcast views; only the
    right-hand sides are rebuilt each half-sweep. The column systems are
    transposed views, so the column solve writes its x straight into the
    (..., M, N) layout.

    Under ``tol`` the sweeps run in groups of `GROUP_SWEEPS` with no host
    read inside a group: each sweep tests ``max(residual) > tol`` on the
    device, and a sweep that fails the test leaves vc, the residual and
    the sweep count exactly as they were (its relax factor is 0, and
    ``vc + 0 * step == vc``). The host reads once a group, so the result
    and the sweep count are those of a test before every sweep.
    """
    global residual_reads
    st = stamps or Stamps()
    m, n = g.shape[-2], g.shape[-1]
    batch = torch.broadcast_shapes(
        g.shape[:-2],
        v_in.shape[:-1],
        *(x.shape[:-2] for x in st.fields() if x is not None),
    )
    full = batch + (m, n)
    # g aligned to the batch rank without expanding: the coefficients'
    # own shape, with (C,) circuit scalars on the right leading axes.
    g_own = g[(None,) * (len(full) - g.ndim)]
    rows = [torch.broadcast_to(t, full) for t in _row_coeffs(g_own, cp, st.g_shunt_row)]
    cols = [torch.broadcast_to(t, batch + (n, m))
            for t in _col_coeffs(g_own, cp, st.g_shunt_col)]
    g = g.expand(full)
    drive = _row_drive(g, v_in.expand(batch + (m,)), cp)
    vc = (
        torch.zeros(g.shape, dtype=g.dtype, device=g.device)
        if st.v_init is None
        else st.v_init.to(g.dtype).expand(g.shape)
    )
    omega = _align(cp.omega, g.ndim, g.dtype, g.device)

    def sweep(vc):
        vr = tridiag(*rows, _row_rhs(g, vc, drive, st.i_inj_row))
        vct = tridiag(*cols, _col_rhs(g, vr, st.i_inj_col))
        return vr, vct.transpose(-1, -2)

    def relax(vc, omega):
        _, vc_gs = sweep(vc)
        # omega * (vc_gs - vc), in the buffer of vc_gs (this loop's own).
        step = vc_gs.sub_(vc).mul_(omega)
        vc_new = vc + step
        res = torch.linalg.vector_norm(vc_new - vc, ord=math.inf, dim=(-1, -2))
        return vc_new, res

    residual = torch.full(batch, math.inf, dtype=g.dtype, device=g.device)
    if cp.tol > 0.0:
        count = torch.zeros((), dtype=torch.int64, device=g.device)
        done = sweeps = 0
        while done < cp.gs_iters:
            group = min(GROUP_SWEEPS, cp.gs_iters - done)
            for _ in range(group):
                active = torch.max(residual) > cp.tol
                vc, res = relax(vc, omega * active)
                residual = torch.where(active, res, residual)
                count += active
            done += group
            sweeps, going = torch.stack((count, (torch.max(residual) > cp.tol).long())).tolist()
            residual_reads += 1
            if not going:
                break
    else:
        for _ in range(cp.gs_iters):
            vc, residual = relax(vc, omega)
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
