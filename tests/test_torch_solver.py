"""Parity of the port's crossbar solver with the reference package.

The same numpy inputs go through the reference (JAX, ``"scan"`` backend)
and the port (torch, ``"tridiag"`` backend, whose kernel wrapper runs its
plain version on CPU tensors). Tolerance: rtol=1e-5 on i_out, vc and
power (the arithmetic is the same float32 sequence), and equal sweep
counts under the ``tol`` early exit.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import backends as jbackends
from repro.core import solver as jsolver
from repro.core.devices import MRAM as J_MRAM
from repro_torch.core import backends as tbackends
from repro_torch.core import solver as tsolver

RTOL = 1e-5
# Only guards exact zeros: every compared quantity is >> 1e-12 in size.
ATOL = 1e-12


def _tile(seed, lead, m, n):
    rng = np.random.default_rng(seed)
    g = rng.uniform(J_MRAM.g_off, J_MRAM.g_on, lead + (m, n)).astype(np.float32)
    v = rng.uniform(0.0, 0.8, lead + (m,)).astype(np.float32)
    return g, v


def _cps(**kw):
    return jsolver.CircuitParams(**kw), tsolver.CircuitParams(**kw)


def _solve_both(g, v, jcp, tcp, jstamps=None, tstamps=None, backend="tridiag"):
    # One jit of the reference solve compiles faster than running it eagerly.
    ref = jax.jit(lambda g, v: jsolver.solve_crossbar(
        g, v, jcp, stamps=jstamps, options=jsolver.SolveOptions(backend="scan"),
    ))(jnp.asarray(g), jnp.asarray(v))
    got = tsolver.solve_crossbar(
        torch.as_tensor(g), torch.as_tensor(v), tcp, stamps=tstamps,
        options=tsolver.SolveOptions(backend=backend),
    )
    return ref, got


def _assert_solution_close(ref, got, g, v, jcp, tcp):
    np.testing.assert_allclose(got.i_out.numpy(), np.asarray(ref.i_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.vc.numpy(), np.asarray(ref.vc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.vr.numpy(), np.asarray(ref.vr), rtol=RTOL, atol=ATOL)
    p_ref = jsolver.crossbar_power(jnp.asarray(g), jnp.asarray(v), ref, jcp)
    p_got = tsolver.crossbar_power(torch.as_tensor(g), torch.as_tensor(v), got, tcp)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_ref), rtol=RTOL)
    assert got.sweeps == int(ref.sweeps)


@pytest.mark.parametrize("m,n", [(1, 1), (1, 8), (8, 1), (5, 7)])
def test_tridiag_matches_scan(m, n):
    g, v = _tile(m * 100 + n, (), m, n)
    jcp, tcp = _cps(gs_iters=96, tol=0.0)
    ref, got = _solve_both(g, v, jcp, tcp)
    _assert_solution_close(ref, got, g, v, jcp, tcp)
    assert got.sweeps == 96


def test_tridiag_matches_scan_batched():
    """g (3, 6, 5) broadcast against v (5, 3, 6): batch (5, 3)."""
    rng = np.random.default_rng(7)
    g = rng.uniform(J_MRAM.g_off, J_MRAM.g_on, (3, 6, 5)).astype(np.float32)
    v = rng.uniform(0.0, 0.8, (5, 3, 6)).astype(np.float32)
    jcp, tcp = _cps(gs_iters=96, tol=0.0)
    ref, got = _solve_both(g, v, jcp, tcp)
    assert tuple(got.i_out.shape) == (5, 3, 5)
    assert tuple(got.residual.shape) == (5, 3)
    _assert_solution_close(ref, got, g, v, jcp, tcp)


def _stamps(seed, m, n):
    rng = np.random.default_rng(seed)
    fields = dict(
        g_shunt_row=rng.uniform(1e-4, 1e-2, (m, n)),
        g_shunt_col=rng.uniform(1e-4, 1e-2, (m, n)),
        i_inj_row=1e-4 * rng.standard_normal((m, n)),
        i_inj_col=1e-4 * rng.standard_normal((m, n)),
        v_init=0.1 * rng.uniform(size=(m, n)),
    )
    fields = {k: x.astype(np.float32) for k, x in fields.items()}
    return (
        jsolver.Stamps(**{k: jnp.asarray(x) for k, x in fields.items()}),
        tsolver.Stamps(**{k: torch.as_tensor(x) for k, x in fields.items()}),
    )


def test_tridiag_matches_scan_with_stamps():
    m, n = 6, 5
    g, v = _tile(21, (), m, n)
    jst, tst = _stamps(22, m, n)
    jcp, tcp = _cps(gs_iters=96, tol=0.0)
    ref, got = _solve_both(g, v, jcp, tcp, jst, tst)
    _assert_solution_close(ref, got, g, v, jcp, tcp)


def test_tridiag_matches_scan_per_config_scalars():
    """(C,) electrical scalars, the stacked-sweep shape."""
    g, v = _tile(31, (3,), 4, 6)
    r = np.asarray([5.0, 13.8, 40.0], np.float32)
    rs = np.asarray([80.0, 100.0, 150.0], np.float32)
    om = np.asarray([1.0, 1.5, 1.8], np.float32)
    jcp = jsolver.CircuitParams(r_row=jnp.asarray(r), r_col=jnp.asarray(r),
                                r_source=jnp.asarray(rs), omega=jnp.asarray(om),
                                gs_iters=96, tol=0.0)
    tcp = tsolver.CircuitParams(r_row=torch.as_tensor(r), r_col=torch.as_tensor(r),
                                r_source=torch.as_tensor(rs), omega=torch.as_tensor(om),
                                gs_iters=96, tol=0.0)
    ref, got = _solve_both(g, v, jcp, tcp)
    assert tuple(got.i_out.shape) == (3, 6)
    _assert_solution_close(ref, got, g, v, jcp, tcp)


@pytest.mark.parametrize("m,n,tol", [(5, 7, 1e-5), (8, 8, 1e-4), (12, 9, 3e-5)])
def test_tridiag_tol_early_exit_matches_scan(m, n, tol):
    """The batch-global early exit runs exactly the reference's sweeps."""
    g, v = _tile(m * 7 + n, (4,), m, n)
    jcp, tcp = _cps(gs_iters=200, tol=tol)
    ref, got = _solve_both(g, v, jcp, tcp)
    assert 0 < got.sweeps < 200
    _assert_solution_close(ref, got, g, v, jcp, tcp)


def test_dense_mna_matches_reference():
    g, v = _tile(3, (), 5, 7)
    jcp, tcp = _cps(gs_iters=96)
    ref = jsolver.solve_dense_mna(jnp.asarray(g), jnp.asarray(v), jcp)
    got = tsolver.solve_dense_mna(torch.as_tensor(g), torch.as_tensor(v), tcp)
    np.testing.assert_allclose(got.i_out.numpy(), np.asarray(ref.i_out), rtol=1e-4, atol=1e-10)
    np.testing.assert_allclose(got.vc.numpy(), np.asarray(ref.vc), rtol=1e-4, atol=1e-9)
    a_ref, rhs_ref = jsolver.mna_system(jnp.asarray(g), jnp.asarray(v), jcp)
    a_got, rhs_got = tsolver.mna_system(torch.as_tensor(g), torch.as_tensor(v), tcp)
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_ref), rtol=1e-6)
    np.testing.assert_allclose(rhs_got.numpy(), np.asarray(rhs_ref), rtol=1e-6)


def test_dense_mna_with_stamps_matches_reference():
    m, n = 4, 3
    g, v = _tile(4, (), m, n)
    jst, tst = _stamps(5, m, n)
    jcp, tcp = _cps(gs_iters=96)
    ref = jsolver.solve_dense_mna(jnp.asarray(g), jnp.asarray(v), jcp, jst)
    got = tsolver.solve_dense_mna(torch.as_tensor(g), torch.as_tensor(v), tcp, tst)
    np.testing.assert_allclose(got.vc.numpy(), np.asarray(ref.vc), rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("backend", ["tridiag", "fused"])
@pytest.mark.parametrize("m,n", [(1, 1), (1, 8), (8, 1), (5, 7)])
def test_port_backends_match_dense_oracle(backend, m, n):
    """Each port backend against the port's dense MNA, at the reference's
    own oracle tolerances (tests/test_backends.py)."""
    g, v = _tile(m * 100 + n, (), m, n)
    cp = tsolver.CircuitParams(r_row=13.8, r_col=13.8, gs_iters=96, tol=0.0)
    g_t, v_t = torch.as_tensor(g), torch.as_tensor(v)
    oracle = tsolver.solve_dense_mna(g_t, v_t, cp)
    got = tsolver.solve_crossbar(g_t, v_t, cp, options=tsolver.SolveOptions(backend=backend))
    np.testing.assert_allclose(got.i_out.numpy(), oracle.i_out.numpy(), rtol=5e-4, atol=1e-9)
    np.testing.assert_allclose(got.vc.numpy(), oracle.vc.numpy(), rtol=5e-3, atol=1e-6)


def test_ideal_solve_and_power_match_reference():
    g, v = _tile(9, (2,), 6, 4)
    ji = jsolver.solve_ideal(jnp.asarray(g), jnp.asarray(v))
    ti = tsolver.solve_ideal(torch.as_tensor(g), torch.as_tensor(v))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6)
    jp = jsolver.ideal_power(jnp.asarray(g), jnp.asarray(v))
    tp = tsolver.ideal_power(torch.as_tensor(g), torch.as_tensor(v))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)


def test_row_system_does_not_write_into_inputs():
    g, v = _tile(11, (2,), 3, 4)
    g_t, v_t = torch.as_tensor(g), torch.as_tensor(v)
    vc = torch.zeros_like(g_t)
    dl, d, du, b = tsolver._row_system(g_t, vc, v_t, tsolver.CircuitParams())
    assert bool(torch.all(vc == 0))
    np.testing.assert_array_equal(g_t.numpy(), g)
    jdl, jd, jdu, jb = jsolver._row_system(jnp.asarray(g), jnp.zeros(g.shape), jnp.asarray(v),
                                           jsolver.CircuitParams())
    for got, want in ((dl, jdl), (d, jd), (du, jdu), (b, jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)


def test_col_system_matches_reference():
    g, v = _tile(12, (2,), 3, 4)
    vr = np.random.default_rng(13).uniform(0, 0.8, g.shape).astype(np.float32)
    st = np.random.default_rng(14).uniform(1e-4, 1e-3, g.shape).astype(np.float32)
    got = tsolver._col_system(torch.as_tensor(g), torch.as_tensor(vr), tsolver.CircuitParams(),
                              torch.as_tensor(st), torch.as_tensor(st))
    want = jsolver._col_system(jnp.asarray(g), jnp.asarray(vr), jsolver.CircuitParams(),
                               jnp.asarray(st), jnp.asarray(st))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)


def test_align_matches_reference():
    for value, ndim in ((2.5, 3), (np.arange(3, dtype=np.float32), 4),
                        (np.ones((2, 3), np.float32), 2)):
        got = tsolver._align(torch.as_tensor(value), ndim, torch.float32)
        want = jsolver._align(jnp.asarray(value), ndim, jnp.float32)
        assert tuple(got.shape) == tuple(want.shape)


@pytest.mark.parametrize("m,n", [(1, 1), (31, 30), (512, 512)])
def test_suggest_iters_matches_reference(m, n):
    assert tsolver.suggest_iters(m, n) == jsolver.suggest_iters(m, n)


def test_registry_has_two_backends_and_tridiag_default():
    assert tbackends.available_backends() == ("fused", "tridiag")
    assert tbackends.get_backend(None).name == "tridiag"
    assert tsolver.SolveOptions().resolved().name == "tridiag"
    with pytest.raises(KeyError, match="tridiag"):
        tbackends.get_backend("scan")


def test_fused_ignores_tol_and_reports_budget():
    g, v = _tile(41, (2,), 5, 6)
    cp = tsolver.CircuitParams(gs_iters=40, tol=1e-3)
    got = tsolver.solve_crossbar(torch.as_tensor(g), torch.as_tensor(v), cp,
                                 options=tsolver.SolveOptions(backend="fused"))
    early = tsolver.solve_crossbar(torch.as_tensor(g), torch.as_tensor(v), cp)
    assert got.sweeps == 40
    assert early.sweeps < 40


def test_default_backend_name_reads_the_environment_like_the_reference(monkeypatch):
    monkeypatch.delenv("REPRO_SOLVER_BACKEND", raising=False)
    assert tbackends.ENV_BACKEND == jbackends.ENV_BACKEND == "REPRO_SOLVER_BACKEND"
    assert tbackends.default_backend_name() == "tridiag"      # the reference's is "scan"
    monkeypatch.setenv("REPRO_SOLVER_BACKEND", "fused")
    assert tbackends.default_backend_name() == jbackends.default_backend_name() == "fused"
    assert tbackends.get_backend(None).name == "fused"
    assert tsolver.SolveOptions().resolved().name == "fused"


def test_callable_backend_matches_reference():
    """A bare tridiagonal solve is wrapped as an inner-solve backend named
    after it, in both packages, and the solve runs through it."""
    from repro_torch.kernels.tridiag.ref import tridiag_ref

    def thomas(dl, d, du, b):
        return tridiag_ref(dl, d, du, b)

    tb, jb = tbackends.get_backend(thomas), jbackends.get_backend(thomas)
    assert tb.name == jb.name == "thomas" and tb.make_solve is None and jb.make_solve is None
    assert tb.make_tridiag(None) is thomas
    g, v = _tile(17, (2,), 5, 6)
    jcp, tcp = _cps(gs_iters=48, tol=0.0)
    ref, got = _solve_both(g, v, jcp, tcp, backend=thomas)
    _assert_solution_close(ref, got, g, v, jcp, tcp)


def _split_cases():
    """(g, v, vc, stamps, per-config cp) cases: plain, stamps, (C,) scalars."""
    g, v = _tile(51, (2,), 4, 6)
    vc = np.random.default_rng(52).uniform(0.0, 0.8, g.shape).astype(np.float32)
    jcp, tcp = _cps()
    yield "plain", g, v, vc, (None, None), (jcp, tcp)
    jst, tst = _stamps(53, 4, 6)
    yield "stamps", g, v, vc, (jst, tst), (jcp, tcp)
    r = np.asarray([5.0, 40.0], np.float32)
    rs = np.asarray([80.0, 150.0], np.float32)
    kw = dict(r_row=r, r_col=r * 2, r_source=rs, r_tia=rs / 10)
    yield ("per-config", g, v, vc, (None, None),
           (jsolver.CircuitParams(**{k: jnp.asarray(x) for k, x in kw.items()}),
            tsolver.CircuitParams(**{k: torch.as_tensor(x) for k, x in kw.items()})))


@pytest.mark.parametrize("case", ["plain", "stamps", "per-config"])
def test_split_assembly_matches_reference_systems(case):
    """Sweep-invariant coefficients + per-sweep right-hand side, broadcast
    to the systems' shape, equal the reference's `_row_system` and
    `_col_system`, and the port's compositions return them."""
    _, g, v, vc, (jst, tst), (jcp, tcp) = next(c for c in _split_cases() if c[0] == case)
    fields = ("g_shunt_row", "i_inj_row", "g_shunt_col", "i_inj_col")
    jf = {k: getattr(jst, k) if jst else None for k in fields}
    tf = {k: getattr(tst, k) if tst else None for k in fields}
    g_t, v_t, vc_t = map(torch.as_tensor, (g, v, vc))
    want_row = jsolver._row_system(jnp.asarray(g), jnp.asarray(vc), jnp.asarray(v), jcp,
                                   jf["g_shunt_row"], jf["i_inj_row"])
    want_col = jsolver._col_system(jnp.asarray(g), jnp.asarray(vc), jcp,
                                   jf["g_shunt_col"], jf["i_inj_col"])
    coeffs = tsolver._row_coeffs(g_t, tcp, tf["g_shunt_row"])
    rhs = tsolver._row_rhs(g_t, vc_t, tsolver._row_drive(g_t, v_t, tcp), tf["i_inj_row"])
    split_row = [torch.broadcast_to(t, rhs.shape) for t in (*coeffs, rhs)]
    coeffs = tsolver._col_coeffs(g_t, tcp, tf["g_shunt_col"])
    rhs = tsolver._col_rhs(g_t, vc_t, tf["i_inj_col"])
    split_col = [torch.broadcast_to(t, rhs.shape) for t in (*coeffs, rhs)]
    composed_row = tsolver._row_system(g_t, vc_t, v_t, tcp, tf["g_shunt_row"], tf["i_inj_row"])
    composed_col = tsolver._col_system(g_t, vc_t, tcp, tf["g_shunt_col"], tf["i_inj_col"])
    for got, again, want in ((split_row, composed_row, want_row),
                             (split_col, composed_col, want_col)):
        for a, b, w in zip(got, again, want):
            assert tuple(a.shape) == tuple(b.shape) == w.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
            np.testing.assert_array_equal(b.numpy(), np.asarray(w))
    # The right-hand side of the column systems is the transposed view of
    # an (..., M, N) tensor: the column solve writes x in that layout.
    assert rhs.transpose(-1, -2).is_contiguous()


def _max_residuals(g, v, tcp, sweeps):
    """The batch-global max residual after each of 1..sweeps sweeps."""
    return [float(torch.max(tsolver.solve_crossbar(
        torch.as_tensor(g), torch.as_tensor(v),
        tsolver.CircuitParams(gs_iters=k, omega=tcp.omega, tol=0.0)).residual))
        for k in range(1, sweeps + 1)]


@pytest.mark.parametrize("stop", [1, 5, 8, 16, None])
def test_grouped_early_exit_matches_reference(stop):
    """Under tol the sweeps run in groups with one host read a group; the
    sweep count and the solution are the reference's (and bitwise those of
    a fixed budget of that many sweeps), at tolerances that stop on sweep
    1, mid-group, at a group's end, one group later, and never."""
    k = tsolver.GROUP_SWEEPS
    assert k == 8
    g, v = _tile(61, (3,), 6, 5)
    budget = 20                   # not a multiple of the group: a short last group
    _, tcp = _cps()
    if stop is None:
        tol = 1e-30
    else:
        r = _max_residuals(g, v, tcp, stop)
        # The first sweep whose residual falls to tol is `stop`.
        assert r[-1] < min(r[:-1], default=math.inf)
        tol = math.sqrt(r[-1] * min(r[:-1])) if stop > 1 else 2 * r[0]
    jcp, tcp = _cps(gs_iters=budget, tol=tol)
    before = tsolver.residual_reads
    ref, got = _solve_both(g, v, jcp, tcp)
    reads = tsolver.residual_reads - before
    want = budget if stop is None else stop
    assert int(ref.sweeps) == want
    _assert_solution_close(ref, got, g, v, jcp, tcp)
    assert reads == -(-want // k)
    fixed = tsolver.solve_crossbar(torch.as_tensor(g), torch.as_tensor(v),
                                   tsolver.CircuitParams(gs_iters=want, tol=0.0))
    for field in ("vc", "vr", "i_out", "residual"):
        assert torch.equal(getattr(got, field), getattr(fixed, field)), field
