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


def _views(kind):
    """Operands (dl, d, du, b) of one broadcast shape, as views of
    arange-filled storage (every element's value is its address)."""
    def arange(*shape):
        return torch.arange(float(np.prod(shape))).reshape(shape)

    if kind == "backend rows":          # stride-0 samples, scalar off-diagonals
        d = arange(1, 3, 5, 4)
        return torch.tensor(-0.5), d, torch.tensor(-0.5), arange(6, 3, 5, 4)
    if kind == "backend columns":       # transposed views of (..., M, N)
        d = arange(1, 3, 5, 4).transpose(-1, -2)
        return torch.tensor(-0.5), d, torch.tensor(-0.5), arange(6, 3, 5, 4).transpose(-1, -2)
    if kind == "per-config":            # (C, 1, 1, 1) scalars, (N,) coefficient
        off = arange(2)[:, None, None, None]
        return off, arange(4), off, arange(2, 3, 5, 4)
    if kind == "sliced and permuted":
        b = arange(3, 8, 5, 6)[:, ::2, :, 1::2].permute(1, 0, 2, 3)
        return arange(5, 3)[None, None], arange(4, 3, 1, 3), arange(3), b
    if kind == "dense":
        return arange(7, 4), arange(7, 4), arange(7, 4), arange(7, 4)
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["backend rows", "backend columns", "per-config",
                                  "sliced and permuted", "dense"])
def test_kernel_layout_addresses_the_broadcast_elements(kind):
    """The (sizes, strides) handed to the kernel walk exactly the elements
    of each operand's broadcast view, in order, with no copy."""
    system = _views(kind)
    shape = torch.broadcast_shapes(*(t.shape for t in system))
    x = torch.empty_like(system[3]) if system[3].shape == shape else torch.empty(shape)
    x.copy_(torch.arange(float(x.numel())).reshape(shape))
    tensors = (*system, x)
    sizes, batch_strides, element_strides = tridiag_ops.kernel_layout(shape, tensors)
    n = shape[-1]
    assert int(np.prod(sizes)) == int(np.prod(shape[:-1]))
    for t, bs, es in zip(tensors, batch_strides, element_strides):
        walked = torch.as_strided(t, sizes + [n], bs + [es], t.storage_offset())
        assert torch.equal(walked, t.expand(shape).reshape(sizes + [n]))
    if kind == "dense":
        assert sizes == [7]
    if kind == "backend rows":
        assert sizes == [6, 15] and batch_strides[1] == [0, 4] and batch_strides[0] == [0, 0]


def test_kernel_layout_refuses_more_than_six_axes():
    b = torch.zeros((2,) * 7 + (3,)).permute(6, 5, 4, 3, 2, 1, 0, 7)
    with pytest.raises(ValueError, match="at most 6"):
        tridiag_ops.kernel_layout(b.shape, (b, b, b, b, b))


def _plan_of(system):
    shape = torch.broadcast_shapes(*(t.shape for t in system))
    x = torch.empty_like(system[3]) if system[3].shape == shape else torch.empty(shape, device="meta")
    return tridiag_ops.launch_plan(*tridiag_ops.kernel_layout(shape, (*system, x)), shape[-1])


def _backend_systems_meta(lead, m, n, chunk):
    """The backend's row and column operands, as `_sweep_solve` builds them,
    on meta tensors (strides without memory)."""
    cp = tsolver.CircuitParams()
    g = torch.empty(lead + (m, n), device="meta")[None]
    full = (chunk,) + lead + (m, n)
    vc = torch.empty(full, device="meta")
    v = torch.empty((chunk,) + lead + (m,), device="meta")
    rows = [torch.broadcast_to(t, full) for t in tsolver._row_coeffs(g, cp)]
    rows.append(tsolver._row_rhs(g.expand(full), vc, tsolver._row_drive(g.expand(full), v, cp)))
    cols = [torch.broadcast_to(t, full[:-2] + (n, m)) for t in tsolver._col_coeffs(g, cp)]
    cols.append(tsolver._col_rhs(g.expand(full), vc))
    return rows, cols


def test_launch_plan_keeps_the_main_path_on_chip():
    """Layer 1 (256 x 104 tiles of 31x30): b and d staged, each slab one run
    of memory, the off-diagonals read at one address; the rows walked
    element-fastest, the columns system-fastest; on chip up to 8 warps an
    SM. The 401x120 tile's columns (N = 401) take the workspace."""
    limit = tridiag_ops.on_chip_limit()
    assert limit == 228 * 1024 // 4 - 1024 - tridiag_ops.STATIC_SMEM_BYTES
    rows, cols = _backend_systems_meta((104,), 31, 30, 256)
    row, col = _plan_of(rows), _plan_of(cols)
    assert (row.systems, row.slabs, row.spad, row.dense_off) == (64, 1, 65, False)
    assert row.efast == (0, 1, 0, 1, 1) and row.contig[1:4:2] == (1, 1) and row.on_chip
    assert row.smem_bytes == 4 * 2 * 30 * 65 and row.grid == 256 * -(-104 * 31 // 64)
    assert (col.systems, col.slabs, col.spad, col.dense_off) == (30, 2, 61, False)
    assert col.efast == (0, 0, 0, 0, 0) and col.contig[1:] == (1, 0, 1, 1) and col.on_chip
    assert col.smem_bytes == 4 * 2 * 31 * 61 and col.grid == 256 * 104 // 2
    dense = [torch.empty((825_344, 30), device="meta")] * 4
    plan = _plan_of(dense)
    assert plan.dense_off and plan.contig == (1,) * 5
    assert plan.on_chip and plan.smem_bytes == 4 * 4 * 30 * 65
    rows, cols = _backend_systems_meta((2,), 401, 120, 16)
    assert not _plan_of(cols).on_chip
    assert _plan_of(cols).smem_bytes > limit


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


def _card_systems(kind, cuda):
    """The kernel's card cases: the backend's own operands at layer 1 (and
    with (C,) per-config scalars), the 401x120 tile's columns (N = 401,
    past the on-chip limit), ragged, N = 1 and dense operands."""
    import dataclasses

    if kind in ("layer-1 rows", "layer-1 columns", "per-config rows", "per-config columns",
                "N=401 columns"):
        cp = tsolver.CircuitParams()
        if kind.startswith("layer-1"):
            g, _ = _tile(5, (104,), 31, 30)
            g, lead = g[None], (256, 104)
        elif kind.startswith("per-config"):
            g, _ = _tile(6, (3, 1, 16), 31, 30)
            r = torch.tensor([5.0, 13.8, 40.0], device=cuda)
            cp = dataclasses.replace(cp, r_row=r, r_col=2 * r, r_source=10 * r)
            lead = (3, 64, 16)
        else:
            g, _ = _tile(7, (1, 2), 401, 120)
            lead = (16, 2)
        m = g.shape[-2]
        v = np.random.default_rng(8).uniform(0.0, 0.8, lead + (m,)).astype(np.float32)
        captured = []

        def capture(*system):
            captured.append(system)
            return tridiag_ops.tridiag(*system)

        tsolver.solve_crossbar(torch.as_tensor(g, device=cuda), torch.as_tensor(v, device=cuda),
                               dataclasses.replace(cp, gs_iters=1, tol=0.0),
                               options=tsolver.SolveOptions(backend=capture))
        return captured[0] if "rows" in kind else captured[1]
    if kind == "sliced and permuted":
        dl, d, du, b = (torch.as_tensor(a, device=cuda) for a in _dd_system(11, (9, 64, 20, 30)))
        return (dl[:, ::2].permute(1, 0, 2, 3), d[:, ::2].permute(1, 0, 2, 3)[..., :1, :],
                du[0, ::2, 0, :][:, None, None, :], b[:, ::2].permute(1, 0, 2, 3))
    shape = {"ragged": (1003, 7), "N=1": (5, 1), "dense": (2, 104 * 31, 30)}[kind]
    return [torch.as_tensor(a, device=cuda) for a in _dd_system(9, shape)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["layer-1 rows", "layer-1 columns", "per-config rows",
                                  "per-config columns", "N=401 columns", "ragged", "N=1",
                                  "dense", "sliced and permuted"])
def test_tridiag_kernel_matches_plain_on_views_on_card(cuda, kind):
    system = _card_systems(kind, cuda)
    before = tridiag_ops.launches
    got = tridiag_ops.tridiag(*system)
    want = tridiag_ref.tridiag_ref(*system)
    torch.cuda.synchronize()
    assert tridiag_ops.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
    if kind == "layer-1 columns":
        assert got.transpose(-1, -2).is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["layer-1 rows", "layer-1 columns"])
def test_tridiag_kernel_launch_makes_no_copy_on_card(cuda, kind):
    """One call on the backend's views is one device kernel: no operand
    copy, no plain-version fallback."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    system = _card_systems(kind, cuda)
    tridiag_ops.tridiag(*system)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tridiag_ops.tridiag(*system)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "tridiag" in kernels[0].key and kernels[0].count == 1


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
