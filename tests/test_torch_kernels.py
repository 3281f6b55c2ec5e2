"""The port's kernel modules: wrappers, plain versions, build, fallback.

On the CPU each wrapper runs its plain version; those are held against
the reference's Pallas kernels run in interpret mode, on the same numpy
inputs. The kernels themselves run only on a GPU: the tests marked
``cuda`` hold them against their plain versions there and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import solver as jsolver
from repro.core.devices import MRAM as J_MRAM
from repro.kernels.gs_fused import ops as j_fused_ops
from repro.kernels.tridiag import ops as j_tridiag_ops
from repro_torch.core import solver as tsolver
from repro_torch.kernels import _build
from repro_torch.kernels.gs_fused import ops as fused_ops
from repro_torch.kernels.gs_fused import ref as fused_ref
from repro_torch.kernels.tridiag import ops as tridiag_ops
from repro_torch.kernels.tridiag import ref as tridiag_ref


def _dd_system(seed, shape):
    """Random diagonally dominant tridiagonal systems of `shape` (..., N)."""
    rng = np.random.default_rng(seed)
    d = (2.0 + rng.uniform(size=shape)).astype(np.float32)
    dl = (-0.5 * rng.uniform(size=shape)).astype(np.float32)
    du = (-0.5 * rng.uniform(size=shape)).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return dl, d, du, b


@pytest.mark.parametrize("shape", [(5, 1), (3, 7), (130, 9), (2, 3, 4, 16)])
def test_tridiag_cpu_matches_reference_kernel(shape):
    """CPU wrapper (plain version) vs the Pallas kernel in interpret mode."""
    system = _dd_system(sum(shape), shape)
    want = j_tridiag_ops.tridiag(*map(jnp.asarray, system), interpret=True)
    got = tridiag_ops.tridiag(*map(torch.as_tensor, system))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_tridiag_ref_broadcasts_operands():
    dl, d, du, b = _dd_system(3, (4, 6))
    off = torch.tensor(-0.3)
    got = tridiag_ref.tridiag_ref(off.expand(4, 6), torch.as_tensor(d), off, torch.as_tensor(b))
    want = jsolver.tridiag_scan(jnp.full((4, 6), -0.3), jnp.asarray(d),
                                jnp.full((4, 6), -0.3), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_other_devices():
    """No silent path off the CPU: a non-CPU, non-CUDA tensor raises."""
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        tridiag_ops.tridiag(meta, meta, meta, meta)
    with pytest.raises(ValueError, match="device"):
        fused_ops.gs_fused(*([torch.empty((2, 3, 3), device="meta")] * 7
                             + [torch.empty((2,), device="meta")] * 3
                             + [torch.empty((2, 3, 3), device="meta")]), sweeps=1)


def _tile(seed, lead, m, n):
    rng = np.random.default_rng(seed)
    g = rng.uniform(J_MRAM.g_off, J_MRAM.g_on, lead + (m, n)).astype(np.float32)
    v = rng.uniform(0.0, 0.8, lead + (m,)).astype(np.float32)
    return g, v


def _fused_both(g, v, jcp, tcp, jst=None, tst=None):
    ref = j_fused_ops.fused_solve(jnp.asarray(g), jnp.asarray(v), jcp, jst, interpret=True)
    got = fused_ops.fused_solve(torch.as_tensor(g), torch.as_tensor(v), tcp, tst)
    return ref, got


def _assert_close(ref, got):
    # atol: ~8 float32 ulps of the field's largest value, for the entries
    # that cancel to near zero (injected currents push voltages through 0).
    for field in ("i_out", "vr", "vc"):
        want = np.asarray(getattr(ref, field))
        np.testing.assert_allclose(
            getattr(got, field).numpy(), want,
            rtol=1e-5, atol=1e-6 * float(np.abs(want).max()), err_msg=field,
        )
    assert got.sweeps == int(ref.sweeps)


@pytest.mark.parametrize("m,n", [(1, 1), (1, 8), (8, 1), (5, 7)])
def test_fused_cpu_matches_reference_kernel(m, n):
    g, v = _tile(m * 100 + n, (), m, n)
    jcp = jsolver.CircuitParams(gs_iters=96, tol=0.0)
    tcp = tsolver.CircuitParams(gs_iters=96, tol=0.0)
    _assert_close(*_fused_both(g, v, jcp, tcp))


def test_fused_cpu_matches_reference_kernel_batched_stamps_per_config():
    """Batch broadcasting, companion stamps and (C,) scalars together."""
    m, n = 6, 5
    g, v = _tile(7, (3,), m, n)
    v = np.broadcast_to(v, (2, 3, m)).copy()
    rng = np.random.default_rng(8)
    fields = dict(
        g_shunt_row=rng.uniform(1e-4, 1e-2, (m, n)),
        g_shunt_col=rng.uniform(1e-4, 1e-2, (m, n)),
        i_inj_row=1e-4 * rng.standard_normal((m, n)),
        i_inj_col=1e-4 * rng.standard_normal((m, n)),
        v_init=0.1 * rng.uniform(size=(m, n)),
    )
    fields = {k: x.astype(np.float32) for k, x in fields.items()}
    jst = jsolver.Stamps(**{k: jnp.asarray(x) for k, x in fields.items()})
    tst = tsolver.Stamps(**{k: torch.as_tensor(x) for k, x in fields.items()})
    r = np.asarray([[5.0], [13.8]], np.float32)  # (2, 1): per leading entry
    jcp = jsolver.CircuitParams(r_row=jnp.asarray(r), r_col=jnp.asarray(r), gs_iters=64, tol=0.0)
    tcp = tsolver.CircuitParams(r_row=torch.as_tensor(r), r_col=torch.as_tensor(r),
                                gs_iters=64, tol=0.0)
    ref, got = _fused_both(g, v, jcp, tcp, jst, tst)
    assert tuple(got.i_out.shape) == (2, 3, n)
    _assert_close(ref, got)


def test_thomas_coeffs_match_reference():
    rng = np.random.default_rng(9)
    d = (1.0 + rng.uniform(size=(3, 4, 7))).astype(np.float32)
    off = np.float32(-0.2)
    jcp, jinv = j_fused_ops._thomas_coeffs(jnp.asarray(d), off)
    tcp, tinv = fused_ref._thomas_coeffs(torch.as_tensor(d), off)
    np.testing.assert_allclose(tcp.numpy(), np.asarray(jcp), rtol=1e-6)
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-6)


def test_gs_fused_ref_zero_sweeps_reports_inf_residual():
    g, v = _tile(10, (2,), 3, 4)
    _, args = fused_ops.prepare(torch.as_tensor(g), torch.as_tensor(v), tsolver.CircuitParams())
    _, _, res = fused_ops.gs_fused(*args, sweeps=0)
    assert bool(torch.all(torch.isinf(res)))


@pytest.mark.parametrize("m,n,fits", [(31, 30, True), (64, 64, True), (75, 75, True),
                                       (76, 76, False), (128, 128, False)])
def test_residency_limit_from_shared_memory(m, n, fits):
    assert fused_ops.smem_bytes(m, n) == 4 * 10 * m * (n | 1) + 128
    assert fused_ops.fits(m, n, torch.device("cpu")) is fits


def test_fused_falls_back_to_tridiag_past_the_limit(caplog):
    """A 96x80 tile exceeds 227 KB: it is solved by the "tridiag" backend."""
    g, v = _tile(12, (), 96, 80)
    cp = tsolver.CircuitParams(gs_iters=64, tol=0.0)
    before = fused_ops.fallbacks
    got = tsolver.solve_crossbar(torch.as_tensor(g), torch.as_tensor(v), cp,
                                 options=tsolver.SolveOptions(backend="fused"))
    assert fused_ops.fallbacks == before + 1
    want = tsolver.solve_crossbar(torch.as_tensor(g), torch.as_tensor(v), cp)
    np.testing.assert_array_equal(got.vc.numpy(), want.vc.numpy())


def test_build_command_targets_hopper(tmp_path):
    for name in _build.KERNELS:
        assert _build.source(name).is_file()
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags and "-O3" in flags
    path = _build.library_path("tridiag")
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "repro_torch")
    assert path != _build.library_path("gs_fused")


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 1), (1003, 7), (4096, 30)])
def test_tridiag_kernel_matches_plain_on_card(cuda, shape):
    system = [torch.as_tensor(a, device=cuda) for a in _dd_system(1, shape)]
    before = tridiag_ops.launches
    got = tridiag_ops.tridiag(*system)
    want = tridiag_ref.tridiag_ref(*system)
    torch.cuda.synchronize()
    assert tridiag_ops.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_tridiag_kernel_rejects_float64(cuda):
    system = [torch.as_tensor(a, device=cuda, dtype=torch.float64) for a in _dd_system(2, (8, 4))]
    with pytest.raises(TypeError, match="float32"):
        tridiag_ops.tridiag(*system)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(1, 1), (5, 7), (31, 30), (64, 64)])
def test_gs_fused_kernel_matches_plain_on_card(cuda, m, n):
    g, v = _tile(m + n, (64,), m, n)
    _, args = fused_ops.prepare(torch.as_tensor(g, device=cuda), torch.as_tensor(v, device=cuda),
                                tsolver.CircuitParams(gs_iters=48))
    before = fused_ops.launches
    vr, vc, res = fused_ops.gs_fused(*args, sweeps=8)
    rvr, rvc, rres = fused_ref.gs_fused_ref(*args, sweeps=8)
    torch.cuda.synchronize()
    assert fused_ops.launches == before + 1
    torch.testing.assert_close(vr, rvr, rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(vc, rvc, rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(res, rres, rtol=1e-4, atol=1e-9)
