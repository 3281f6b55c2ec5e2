"""The LM kernels of the port: `imac_mvm`, `analog_linear`, `decode_attention`.

On the CPU each wrapper runs its plain version; those are held against
the reference's Pallas kernels run in interpret mode and against its
plain (ref.py) versions, on the same numpy inputs. The kernels
themselves run only on a GPU: the tests marked ``cuda`` hold them
against their plain versions there and skip here.

Tolerances: rtol 1e-5, plus an atol for entries that cancel to near 0
in a sum of K products of unit-range operands (1e-6 * K for imac_mvm,
1e-5 for attention outputs, which are averages of unit-normal values);
both versions accumulate in float32 in different orders. bfloat16
attention is held at 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.devices import custom_tech as j_custom_tech
from repro.kernels.decode_attention.ops import decode_attention as j_decode_attention
from repro.kernels.decode_attention.ref import decode_attention_ref as j_decode_ref
from repro.kernels.imac_mvm import ref as j_mvm_ref
from repro.kernels.imac_mvm.ops import analog_linear as j_analog_linear
from repro.kernels.imac_mvm.ops import imac_mvm as j_imac_mvm
from repro_torch.core.devices import custom_tech
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.imac_mvm import ops as mvm_ops
from repro_torch.kernels.imac_mvm import ref as mvm_ref


def _mvm_inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (m, k)).astype(np.float32)
    w = rng.uniform(-1.0, 1.0, (k, n)).astype(np.float32)
    return x, w


def _close(got, want, *, k=1, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=1e-6 * k)


# ---------------------------------------------------------------- imac_mvm


@pytest.mark.parametrize(
    "m,k,n",
    [(1, 1, 1), (4, 7, 5), (130, 257, 96), (128, 128, 128), (256, 64, 33),
     (3, 300, 129), (17, 129, 1), (65, 16, 200)],   # the last three: ragged M/K/N
)
def test_imac_mvm_matches_reference_kernel(m, k, n):
    x, w = _mvm_inputs(m * 1000 + k + n, m, k, n)
    got = mvm_ops.imac_mvm(torch.as_tensor(x), torch.as_tensor(w), dac_bits=8, levels=16)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    want = j_imac_mvm(jnp.asarray(x), jnp.asarray(w), dac_bits=8, levels=16, interpret=True)
    _close(got, want, k=k)
    _close(got, j_mvm_ref.imac_mvm_ref(jnp.asarray(x), jnp.asarray(w), dac_bits=8, levels=16), k=k)


@pytest.mark.parametrize("dac_bits,levels", [(0, 1), (4, 4), (8, 16), (2, 32), (8, 256), (4, 1)])
def test_imac_mvm_quantization_params(dac_bits, levels):
    x, w = _mvm_inputs(dac_bits * 100 + levels, 17, 40, 9)
    got = mvm_ops.imac_mvm(torch.as_tensor(x), torch.as_tensor(w), dac_bits=dac_bits,
                           levels=levels)
    want = j_imac_mvm(jnp.asarray(x), jnp.asarray(w), dac_bits=dac_bits, levels=levels,
                      interpret=True)
    _close(got, want, k=40)


def test_imac_mvm_batch_dims_and_bfloat16_input():
    x, w = _mvm_inputs(5, 15, 20, 8)
    x3 = x.reshape(3, 5, 20)
    got = mvm_ops.imac_mvm(torch.as_tensor(x3), torch.as_tensor(w))
    assert tuple(got.shape) == (3, 5, 8)
    _close(got, j_imac_mvm(jnp.asarray(x3), jnp.asarray(w), interpret=True), k=20)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    want = j_imac_mvm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(w),
                      interpret=True)
    _close(mvm_ops.imac_mvm(xb, torch.as_tensor(w)), want, k=20)


def test_quantisers_match_reference_exactly_at_level_boundaries():
    """The divide form of ref.py, half-to-even rounding, sign(0) = 0 and
    clipping, element by element — including exact .5 boundaries."""
    n, levels = 255, 16
    step = np.float32(1.0 / (levels - 1))
    x = np.concatenate([
        (np.arange(n + 1, dtype=np.float32) + np.float32(0.5)) / np.float32(n),
        np.float32([-0.3, 0.0, 1.0, 1.7]),
        np.random.default_rng(0).uniform(0, 1, 500).astype(np.float32),
    ])
    w = np.concatenate([
        (np.arange(-levels, levels + 1, dtype=np.float32) + np.float32(0.5)) * step,
        np.float32([-2.0, -1.0, -0.0, 0.0, 1.0, 3.0]),
        np.random.default_rng(1).uniform(-1, 1, 500).astype(np.float32),
    ])
    for bits in (0, 4, 8):
        np.testing.assert_array_equal(
            mvm_ref.dac_quant(torch.as_tensor(x), bits).numpy(),
            np.asarray(j_mvm_ref.dac_quant(jnp.asarray(x), bits)))
    for lv in (1, 4, 16, 256):
        got = mvm_ref.weight_quant(torch.as_tensor(w), lv).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_mvm_ref.weight_quant(jnp.asarray(w), lv)))
    assert mvm_ref.weight_quant(torch.zeros(3), 16).tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("dac_bits,levels", [(8, 16), (0, 1), (3, 5)])
def test_quant_args_are_the_references_constants(dac_bits, levels):
    dac_n, lv, step = mvm_ops.quant_args(dac_bits, levels)
    assert dac_n == ((1 << dac_bits) - 1 if dac_bits > 0 else 0) and lv == levels
    if levels > 1:
        assert np.float32(step) == np.float32(1.0 / (levels - 1))


def _boundary_inputs(n, levels):
    """x at every DAC .5 boundary of n steps, w at every level .5 boundary,
    the clip edges, signed zeros and random values."""
    step = np.float32(1.0 / (levels - 1))
    x = np.concatenate([
        (np.arange(n + 1, dtype=np.float32) + np.float32(0.5)) / np.float32(n),
        np.float32([-0.3, 0.0, 1.0, 1.7]),
        np.random.default_rng(0).uniform(0, 1, 500).astype(np.float32),
    ])
    w = np.concatenate([
        (np.arange(-levels, levels + 1, dtype=np.float32) + np.float32(0.5)) * step,
        np.float32([-2.0, -1.0, -0.0, 0.0, 1.0, 3.0]),
        np.random.default_rng(1).uniform(-1, 1, 500).astype(np.float32),
    ])
    return torch.as_tensor(x), torch.as_tensor(w)


@pytest.mark.parametrize("dac_bits,levels", [(1, 2), (4, 4), (8, 16), (8, 128), (3, 5)])
def test_levels_times_their_scale_are_the_quantisers(dac_bits, levels):
    """The integer route's levels, scaled, are the quantisers' values
    exactly, .5 boundaries included; they are integers in u8 / s8 range."""
    n = (1 << dac_bits) - 1
    x, w = _boundary_inputs(n, levels)
    ix, r = mvm_ref.dac_levels(x, dac_bits), mvm_ref.weight_levels(w, levels)
    step = torch.tensor(1.0 / (levels - 1), dtype=torch.float32)
    assert torch.equal(ix / torch.tensor(float(n)), mvm_ref.dac_quant(x, dac_bits))
    assert torch.equal(r * step, mvm_ref.weight_quant(w, levels))
    assert torch.equal(ix, ix.round()) and 0 <= float(ix.min()) and float(ix.max()) <= n <= 255
    assert torch.equal(r, r.round()) and float(r.abs().max()) <= levels - 1 <= 127
    assert mvm_ref.level_scale(dac_bits, levels) == float(np.float32(1.0 / (levels - 1))) / n


def test_levels_refuse_clip_only_quantisers():
    with pytest.raises(ValueError, match="dac_bits"):
        mvm_ref.dac_levels(torch.zeros(3), 0)
    with pytest.raises(ValueError, match="levels"):
        mvm_ref.weight_levels(torch.zeros(3), 1)


@pytest.mark.parametrize("m,k,n", [(17, 129, 5), (33, 300, 129), (64, 16, 200), (3, 40, 9)])
@pytest.mark.parametrize("dac_bits,levels", [(8, 16), (4, 4), (1, 2), (8, 128)])
def test_imac_mvm_levels_ref_matches_plain_and_reference(m, k, n, dac_bits, levels):
    """The exact integer form against the float32 plain version and the
    reference's plain version, at the kernel-vs-plain tolerance; bfloat16 x
    goes through float32 as on the card."""
    x, w = _mvm_inputs(m * 7 + k + n, m, k, n)
    x[0, 0], w[1, 0] = 1.3, -1.4                  # clipped on both sides
    tx, tw = torch.as_tensor(x), torch.as_tensor(w)
    got = mvm_ref.imac_mvm_levels_ref(tx, tw, dac_bits=dac_bits, levels=levels)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    _close(got, mvm_ref.imac_mvm_ref(tx, tw, dac_bits=dac_bits, levels=levels), k=k)
    _close(got, j_mvm_ref.imac_mvm_ref(jnp.asarray(x), jnp.asarray(w), dac_bits=dac_bits,
                                       levels=levels), k=k)
    xb = tx.to(torch.bfloat16)
    _close(mvm_ref.imac_mvm_levels_ref(xb, tw, dac_bits=dac_bits, levels=levels),
           mvm_ref.imac_mvm_ref(xb, tw, dac_bits=dac_bits, levels=levels), k=k)


def test_imac_mvm_levels_ref_gives_nan_rows_and_columns():
    """As the float32 version: NaN in row i of x or column j of w gives NaN
    in row i or column j of y; +-inf clips."""
    x, w = _mvm_inputs(3, 20, 50, 12)
    x[4, 7], w[9, 3] = np.nan, np.nan
    x[6, 0], w[0, 8] = np.inf, -np.inf
    got = mvm_ref.imac_mvm_levels_ref(torch.as_tensor(x), torch.as_tensor(w))
    want = mvm_ref.imac_mvm_ref(torch.as_tensor(x), torch.as_tensor(w))
    assert torch.equal(got.isnan(), want.isnan())
    assert bool(got[4].isnan().all()) and bool(got[:, 3].isnan().all())
    assert int(got.isnan().sum()) == 12 + 20 - 1
    _close(torch.nan_to_num(got), torch.nan_to_num(want), k=50)


@pytest.mark.parametrize("dac_bits,levels", [(8, None), (12, 256), (4, 4)])
def test_analog_linear_matches_reference(dac_bits, levels):
    rng = np.random.default_rng(dac_bits)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    w = (0.3 * rng.standard_normal((32, 16))).astype(np.float32)
    b = (0.1 * rng.standard_normal(16)).astype(np.float32)
    got = mvm_ops.analog_linear(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                                tech="PCM", dac_bits=dac_bits, levels=levels)
    want = j_analog_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), tech="PCM",
                           dac_bits=dac_bits, levels=levels, interpret=True)
    _close(got, want, k=32 * 4)   # the output is rescaled by x_rng * max|w| ~ 4


@pytest.mark.parametrize("kind", ["float", "array"])
def test_analog_linear_takes_the_references_w_scale(kind):
    """A given `w_scale` replaces max|w| + 1e-12 on both sides."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    w = (0.3 * rng.standard_normal((32, 16))).astype(np.float32)
    b = (0.1 * rng.standard_normal(16)).astype(np.float32)
    scale = 1.75                                  # above max|w|: weights map inside [-1, 1]
    t_scale = scale if kind == "float" else torch.tensor(scale)
    j_scale = scale if kind == "float" else jnp.float32(scale)
    got = mvm_ops.analog_linear(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                                w_scale=t_scale)
    want = j_analog_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), w_scale=j_scale,
                           interpret=True)
    _close(got, want, k=32 * 4)
    default = mvm_ops.analog_linear(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b))
    assert not torch.equal(got, default)
    same = mvm_ops.analog_linear(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                                 w_scale=torch.as_tensor(np.abs(w).max()) + 1e-12)
    assert torch.equal(same, default)


def test_analog_linear_approximates_digital():
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((6, 32)).astype(np.float32))
    w = torch.as_tensor((0.3 * rng.standard_normal((32, 16))).astype(np.float32))
    b = torch.as_tensor((0.1 * rng.standard_normal(16)).astype(np.float32))
    y = mvm_ops.analog_linear(x, w, b, dac_bits=12, levels=256)
    want = x @ w + b
    assert float((y - want).abs().max() / want.abs().max()) < 0.05


def test_analog_linear_read_noise_only_with_a_generator():
    tech = custom_tech(5e4, 1e6, levels=32, read_noise_rel=0.05)
    assert j_custom_tech(5e4, 1e6, levels=32, read_noise_rel=0.05).levels == tech.levels
    x, w = _mvm_inputs(3, 8, 24, 10)
    x, w = torch.as_tensor(x), torch.as_tensor(w)
    quiet = mvm_ops.analog_linear(x, w, None, tech=tech)
    noisy = mvm_ops.analog_linear(x, w, None, tech=tech, noise=torch.Generator().manual_seed(0))
    again = mvm_ops.analog_linear(x, w, None, tech=tech, noise=torch.Generator().manual_seed(0))
    assert not torch.equal(quiet, noisy) and torch.equal(noisy, again)
    rel = ((noisy - quiet).abs() / quiet.abs().clamp_min(1e-6)).max()
    assert float(rel) < 0.5
    # PCM has no read noise: a generator changes nothing.
    pcm = mvm_ops.analog_linear(x, w, None, noise=torch.Generator().manual_seed(0))
    assert torch.equal(pcm, mvm_ops.analog_linear(x, w, None))


# The split-K route's launch plan. `_h100_clusters` stands in for the card's
# occupancy query (cudaOccupancyMaxActiveClusters): 4 blocks per SM for the
# M <= 8 buckets and 2 above (their registers), less what clusters of
# `splits` blocks waste on 132 SMs.


def _h100_clusters(m_bucket, bn, splits, x_rows):
    return (4 if m_bucket <= 8 else 2) * 132 // splits


YI_FFN = [(4096, 11008), (11008, 4096)]


@pytest.mark.parametrize("m", [1, 4, 8, 12, 16])
@pytest.mark.parametrize("k,n", [*YI_FFN, (4097, 4095), (300, 129), (1, 1), (100_000, 64),
                                 (257, 5)])
def test_launch_plan_covers_every_row_and_column(m, k, n):
    # Clip-only quantisers keep M = 9-16 on the split-K route.
    plan = mvm_ops.launch_plan(m, k, n, _h100_clusters, dac_bits=0, levels=1)
    assert plan.route == "splitk" and m <= plan.m_bucket and plan.m_bucket in mvm_ops.M_BUCKETS
    assert 1 <= plan.splits <= 8                 # the portable cluster size
    rows = np.zeros(k, dtype=int)
    for s in range(plan.splits):
        lo, hi = s * plan.k_chunk, min((s + 1) * plan.k_chunk, k)
        assert lo < hi                           # no split is empty
        rows[lo:hi] += 1
    assert (rows == 1).all()                     # every K row in exactly one split
    tiles = -(-n // plan.bn)
    cols = np.zeros(tiles * plan.bn, dtype=int)
    for t in range(tiles):
        cols[t * plan.bn:(t + 1) * plan.bn] += 1
    assert (cols[:n] == 1).all() and (tiles - 1) * plan.bn < n
    assert plan.blocks == tiles * plan.splits
    assert 1 <= plan.x_rows <= plan.k_chunk
    assert 4 * plan.m_bucket * plan.x_rows <= mvm_ops.XS_MAX_BYTES
    assert plan.waves == -(-plan.blocks // plan.resident)


@pytest.mark.parametrize("m", [4, 12])
@pytest.mark.parametrize("k,n", YI_FFN)
def test_launch_plan_runs_two_blocks_per_sm_at_the_serving_shapes(m, k, n):
    plan = mvm_ops.launch_plan(m, k, n, _h100_clusters, sms=132, dac_bits=0, levels=1)
    assert plan.route == "splitk" and plan.blocks >= 2 * 132


def test_launch_plan_fills_whole_waves():
    # 496 blocks at once (62 clusters of 8): K=11008, N=4096 in 64-column
    # tiles x 8 splits is 512 blocks, a second wave of 16; 7 splits fit one.
    plan = mvm_ops.launch_plan(4, 11008, 4096, lambda mb, bn, splits, xr: 496 // splits)
    assert plan.blocks <= plan.resident and plan.waves == 1 and plan.blocks >= 264
    assert (plan.bn, plan.splits) != (64, 8)


def test_launch_plan_skips_what_does_not_fit_and_raises_when_nothing_does():
    plan = mvm_ops.launch_plan(4, 4096, 11008, lambda mb, bn, splits, xr: 0 if bn == 128 else 9)
    assert plan.bn == 64
    with pytest.raises(ValueError, match="no split-K plan"):
        mvm_ops.launch_plan(4, 4096, 11008, lambda *a: 0)


def _h100_int8_clusters(wgs, splits):
    """Stands in for the integer route's occupancy query: 2 blocks per SM
    with one consumer warpgroup, 1 with two (their shared memory)."""
    return (2 if wgs == 1 else 1) * 132 // splits


# M > 16 takes one of two routes: the integer route for integer quantisers
# (1 <= dac_bits <= 8, 2 <= levels <= 128) and K <= 66,000, the 64x64 tile
# otherwise. The first three cases keep their ids from before the integer
# route, with quantisers that still take the tile.
@pytest.mark.parametrize("m,k,n,dac_bits,levels,route", [
    pytest.param(17, 4096, 11008, 8, 256, "tile64", id="17-4096-11008"),
    pytest.param(2048, 4096, 11008, 0, 1, "tile64", id="2048-4096-11008"),
    pytest.param(1003, 300, 129, 9, 16, "tile64", id="1003-300-129"),
    pytest.param(32, 70_000, 129, 8, 16, "tile64", id="k-past-the-exact-range"),
    pytest.param(17, 4096, 11008, 8, 16, "int8", id="int8-17-4096-11008"),
    pytest.param(2048, 4096, 11008, 4, 128, "int8", id="int8-2048-4096-11008"),
    pytest.param(1003, 300, 129, 1, 2, "int8", id="int8-1003-300-129"),
])
def test_launch_plan_takes_the_64x64_tile_past_m_16(m, k, n, dac_bits, levels, route):
    plan = mvm_ops.launch_plan(m, k, n, _h100_clusters, dac_bits=dac_bits, levels=levels,
                               int8_clusters=_h100_int8_clusters)
    assert plan.route == route
    if route == "tile64":
        assert plan.m_bucket == 0 and plan.blocks == -(-n // 64) * -(-m // 64)
    else:
        bm = plan.m_bucket
        assert bm == (64 if m <= 64 else 128) and plan.bn == 128
        assert plan.blocks == -(-m // bm) * -(-n // 128) * plan.splits


@pytest.mark.parametrize("m,dac_bits,levels,route", [
    (1, 8, 16, "splitk"), (8, 8, 16, "splitk"), (9, 8, 16, "int8"), (12, 8, 16, "int8"),
    (16, 8, 16, "int8"), (16, 0, 1, "splitk"), (12, 8, 256, "splitk"), (17, 8, 16, "int8"),
    (32, 8, 16, "int8"), (32, 8, 128, "int8"), (32, 8, 129, "tile64"), (32, 9, 16, "tile64"),
    (32, 0, 16, "tile64"), (32, 8, 1, "tile64"), (4096, 1, 2, "int8"),
])
def test_launch_plan_picks_the_route_by_m_and_quantisers(m, dac_bits, levels, route):
    plan = mvm_ops.launch_plan(m, 4096, 11008, _h100_clusters, dac_bits=dac_bits, levels=levels,
                               int8_clusters=_h100_int8_clusters)
    assert plan.route == route
    assert mvm_ops.integer_quantisers(dac_bits, levels) == (1 <= dac_bits <= 8 and
                                                            2 <= levels <= 128)


@pytest.mark.parametrize("m", [9, 12, 17, 32, 64, 65, 128, 2048])
@pytest.mark.parametrize("k,n", [*YI_FFN, (4097, 129), (300, 129), (1, 1), (65_999, 64)])
def test_int8_plan_covers_every_row_column_and_k_step(m, k, n):
    plan = mvm_ops.launch_plan(m, k, n, _h100_clusters, int8_clusters=_h100_int8_clusters)
    assert plan.route == "int8" and 1 <= plan.splits <= 8 and plan.k_chunk % 128 == 0
    kp = mvm_ops.int8_padded_k(k)
    assert kp % 16 == 0 and k <= kp < k + 16
    steps = -(-kp // 128)
    chunk = plan.k_chunk // 128
    covered = np.zeros(steps, dtype=int)
    for s in range(plan.splits):
        lo, hi = s * chunk, min((s + 1) * chunk, steps)
        assert lo < hi                           # no split is empty
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if plan.splits > 1:                          # split only below one wave
        assert -(-m // plan.m_bucket) * -(-n // 128) < _h100_int8_clusters(plan.m_bucket // 64, 1)
        assert chunk >= mvm_ops.INT8_MIN_SPLIT_STEPS
    assert plan.waves == -(-plan.blocks // plan.resident)


def test_int8_plan_fills_the_card_at_the_long_context_tick():
    """M = 32 slots: 86 or 32 column tiles for 132 SMs, so K is split."""
    for k, n in YI_FFN:
        plan = mvm_ops.launch_plan(32, k, n, _h100_clusters, int8_clusters=_h100_int8_clusters)
        assert plan.route == "int8" and plan.splits > 1 and plan.blocks >= 132


def test_int8_route_refuses_k_past_its_exact_range():
    mvm_ops.check_int8_k(mvm_ops.INT8_MAX_K)
    assert 255 * 127 * mvm_ops.INT8_MAX_K < 2**31
    with pytest.raises(ValueError, match="2\\^31"):
        mvm_ops.check_int8_k(mvm_ops.INT8_MAX_K + 1)
    with pytest.raises(ValueError, match="int8_clusters"):
        mvm_ops.launch_plan(32, 4096, 11008, _h100_clusters)


@pytest.mark.parametrize("m,n,kp", [(17, 129, 4112), (32, 11008, 4096), (2048, 4096, 11008),
                                    (1, 1, 16)])
def test_int8_workspace_parts_are_aligned_and_disjoint(m, n, kp):
    w_off, flags_off, size = mvm_ops._workspace_offsets(m, n, kp)
    assert w_off % 256 == 0 and flags_off % 256 == 0    # TMA wants 16-byte aligned bases
    assert m * kp <= w_off and w_off + n * kp <= flags_off and size == flags_off + 4 * (m + n)


def test_imac_mvm_refuses_other_devices_and_shapes():
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        mvm_ops.imac_mvm(meta, torch.empty((3, 2), device="meta"))
    with pytest.raises(ValueError, match="shapes"):
        mvm_ops.imac_mvm(torch.zeros(4, 3), torch.zeros(4, 2))


# --------------------------------------------------------- decode_attention


def _attn_inputs(seed, b, h, hkv, s, dk, dv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dk)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dv)).astype(np.float32)
    lens = rng.integers(1, s + 1, (b,)).astype(np.int32)
    return q, k, v, lens


@pytest.mark.parametrize(
    "b,h,hkv,s,dk,dv",
    [
        (2, 8, 2, 256, 64, 64),     # GQA
        (1, 16, 1, 512, 128, 96),   # MQA, Dk != Dv (MLA-style)
        (2, 4, 4, 128, 64, 64),     # MHA
        (1, 4, 2, 640, 128, 128),   # non-power-of-two S
        (3, 8, 4, 200, 32, 48),     # S not a multiple of 128, Dk != Dv
        (4, 32, 4, 40, 16, 16),     # the serving layout's G = 8
    ],
)
def test_decode_attention_matches_reference_kernel(b, h, hkv, s, dk, dv):
    q, k, v, lens = _attn_inputs(b * 100 + s, b, h, hkv, s, dk, dv)
    got = da_ops.decode_attention(*map(torch.as_tensor, (q, k, v, lens)))
    assert tuple(got.shape) == (b, h, dv)
    jargs = tuple(map(jnp.asarray, (q, k, v, lens)))
    want = j_decode_attention(*jargs, bs=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_decode_ref(*jargs)), rtol=1e-5, atol=1e-5)


def test_decode_attention_bfloat16():
    q, k, v, lens = _attn_inputs(0, 2, 8, 4, 256, 64, 64)
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = da_ops.decode_attention(tq, tk, tv, torch.as_tensor(lens))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tq, tk, tv))
    want = j_decode_attention(jq, jk, jv, jnp.asarray(lens), bs=128, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_decode_attention_lengths_past_the_cache_keep_all_positions():
    q, k, v, _ = _attn_inputs(4, 2, 4, 2, 24, 16, 16)
    t = tuple(map(torch.as_tensor, (q, k, v)))
    full = da_ops.decode_attention(*t)
    past = da_ops.decode_attention(*t, torch.tensor([24, 30], dtype=torch.int32))
    torch.testing.assert_close(past, full, rtol=0, atol=0)
    want = j_decode_ref(*map(jnp.asarray, (q, k, v)), jnp.asarray([24, 30], jnp.int32))
    np.testing.assert_allclose(past.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# The split-KV route's combine, written out plainly (ref.py), against the
# reference: lengths of 1, inside split 0, exactly on a split boundary,
# past S, and splits left empty by short lengths.
@pytest.mark.parametrize(
    "b,h,hkv,s,dk,dv,lens,splits,chunk",
    [
        (4, 32, 4, 256, 16, 16, [1, 9, 28, 256], 4, 64),     # serving: splits 1-3 empty
        (3, 8, 2, 200, 32, 48, [64, 65, 128], 4, 64),        # on and just past a boundary
        (2, 8, 1, 300, 64, 64, [300, 999], 3, 128),          # full, past S
        (2, 16, 2, 100, 32, 32, [1, 40], 2, 64),             # G = 8, S not a multiple of 64
        (1, 4, 4, 40, 16, 16, [33], 1, 64),                  # one split, MHA
        (2, 8, 2, 512, 32, 32, [1, 512], 8, 64),             # eight splits, seven empty in row 0
    ],
)
def test_decode_attention_split_combine_matches_reference(b, h, hkv, s, dk, dv, lens, splits,
                                                          chunk):
    q, k, v, _ = _attn_inputs(b * 7 + s, b, h, hkv, s, dk, dv)
    lens = np.asarray(lens, np.int32)
    got = da_ref.decode_attention_split_ref(*map(torch.as_tensor, (q, k, v, lens)), splits, chunk)
    assert tuple(got.shape) == (b, h, dv)
    jargs = tuple(map(jnp.asarray, (q, k, v, lens)))
    want = j_decode_attention(*jargs, bs=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_decode_ref(*jargs)), rtol=1e-5, atol=1e-5)


# The split-KV launch plan. `_h100_split_clusters` stands in for the card's
# occupancy query (cudaOccupancyMaxActiveClusters): 2 blocks per SM (the
# kernel's 100 KB of shared memory), less what clusters of `splits` blocks
# waste on 132 SMs.


def _h100_split_clusters(splits):
    return 2 * 132 // splits


@pytest.mark.parametrize("rows,s", [(128, 8192), (128, 4096), (16, 256), (16, 300), (1, 1),
                                    (3, 63), (5, 65), (1024, 4096), (2, 100_000), (7, 129),
                                    (128, 8191), (128, 8193), (16, 4096), (4, 64), (4, 65),
                                    (64, 2048), (256, 512), (12, 1000), (1, 513), (33, 7777)])
def test_split_plan_covers_every_position(rows, s):
    tile = da_ops.SPLIT_TILE
    plan = da_ops.split_plan(rows, s, tile, _h100_split_clusters)
    assert plan.route == "splitkv" and 1 <= plan.splits <= 8   # the portable cluster size
    assert plan.chunk % tile == 0 and plan.chunk >= tile
    cover = np.zeros(s, dtype=int)
    for r in range(plan.splits):
        lo, hi = r * plan.chunk, min((r + 1) * plan.chunk, s)
        assert lo < hi                                          # no split past the cache
        cover[lo:hi] += 1
    assert (cover == 1).all()                                   # every position in one split
    assert plan.blocks == rows * plan.splits
    assert plan.resident == _h100_split_clusters(plan.splits) * plan.splits
    assert plan.waves == -(-plan.blocks // plan.resident)


@pytest.mark.parametrize("s", [16384, 8192, 4096, 2048])
def test_split_plan_fills_the_card_in_one_wave_at_long_context(s):
    # 128 rows: 2 splits put 256 blocks on the 264 the card holds at once,
    # one wave; more splits would need several (the card times them slower).
    plan = da_ops.split_plan(32 * 4, s, da_ops.SPLIT_TILE, _h100_split_clusters)
    assert plan.waves == 1 and plan.blocks > 132
    assert (plan.splits, plan.blocks) == (2, 256)


def test_split_plan_takes_the_shortest_critical_path_past_one_wave():
    # 1024 rows cannot run in one wave: 1 split is 4 waves of 4096
    # positions, 2 splits 8 of 2048, 4 splits 16 of 1024 (the same
    # positions on the critical path); the fewest waves win the tie.
    plan = da_ops.split_plan(1024, 4096, 64, lambda splits: 264 // splits)
    assert plan.waves * plan.chunk == 16384 and plan.splits == 1


@pytest.mark.parametrize("s", [1, 2, 17, 63, 64])
def test_split_plan_takes_one_split_up_to_a_tile(s):
    plan = da_ops.split_plan(16, s, da_ops.SPLIT_TILE, _h100_split_clusters)
    assert plan.splits == 1 and plan.chunk == da_ops.SPLIT_TILE


def test_split_plan_at_the_serving_shape_takes_the_most_splits_of_a_tile():
    # 16 rows of S=256 cannot fill 2 blocks per SM; 4 splits of 64 is the
    # most whose range holds a whole tile.
    plan = da_ops.split_plan(16, 256, 64, _h100_split_clusters)
    assert (plan.splits, plan.chunk, plan.blocks) == (4, 64, 64)


def test_split_plan_skips_what_does_not_fit_and_raises_when_nothing_does():
    plan = da_ops.split_plan(128, 8192, 64, lambda splits: 0 if splits > 2 else 9)
    assert plan.splits == 2
    with pytest.raises(ValueError, match="no split-KV plan"):
        da_ops.split_plan(128, 8192, 64, lambda splits: 0)


@pytest.mark.parametrize("dtype,g,dk,dv,aligned,split", [
    (torch.bfloat16, 8, 128, 128, True, True), (torch.bfloat16, 8, 64, 64, True, True),
    (torch.bfloat16, 1, 128, 128, True, True), (torch.bfloat16, 16, 128, 128, True, False),
    (torch.bfloat16, 8, 576, 512, True, False), (torch.bfloat16, 8, 32, 48, True, False),
    (torch.bfloat16, 8, 128, 128, False, False),
    # float32 (the reduced configs) takes the rows route at every shape.
    (torch.float32, 8, 128, 128, True, False), (torch.float32, 8, 64, 64, True, False),
    (torch.float32, 2, 32, 32, True, False), (torch.float16, 8, 128, 128, True, False)])
def test_split_route_is_chosen_by_shape(dtype, g, dk, dv, aligned, split):
    assert da_ops.takes_split_route(dtype, g, dk, dv, aligned) is split


@pytest.mark.parametrize("g,dk,dv,bs", [(8, 128, 128, 64), (8, 576, 512, 32), (16, 576, 512, 32),
                                        (1, 64, 64, 64)])
def test_decode_block_fits_shared_memory(g, dk, dv, bs):
    assert da_ops.block_size(g, dk, dv) == bs
    assert da_ops.smem_bytes(g, dk, dv, bs) <= da_ops.H100_SMEM_OPTIN_BYTES


def test_decode_attention_refuses_bad_inputs():
    with pytest.raises(ValueError, match="group"):
        da_ops.decode_attention(torch.zeros(1, 6, 8), torch.zeros(1, 4, 4, 8),
                                torch.zeros(1, 4, 4, 8))
    with pytest.raises(ValueError, match="kv_len"):
        da_ops.decode_attention(torch.zeros(2, 4, 8), torch.zeros(2, 4, 2, 8),
                                torch.zeros(2, 4, 2, 8), torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        da_ops.decode_attention(*(torch.empty(s, device="meta")
                                  for s in ((1, 2, 8), (1, 4, 1, 8), (1, 4, 1, 8))))
    with pytest.raises(ValueError, match="block size|shared memory"):
        da_ops.block_size(256, 1024, 1024)


def test_build_lists_the_lm_kernels():
    for name in ("imac_mvm", "decode_attention"):
        assert name in _build.KERNELS and _build.source(name).is_file()


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# M at and around the split-K route's buckets and its edge (16 | 17), the
# integer route's one- and two-warpgroup row tiles (32, 33, 64; 1003), K
# not a multiple of the splits or of 16, N not a multiple of 4 (one-float
# w loads); and the prefills' M = 8 (bucket 8, full) and 10 (bucket 12,
# partial) at yi-9b's FFN shapes.
_CARD_SHAPES = [(4, 4096, 11008), (12, 11008, 4096), (1003, 300, 129), (1, 1, 1)] + [
    (m, k, n) for m in (1, 4, 12, 16, 17, 32, 33, 64) for k in (4097, 11008)
    for n in (129, 4095)] + [
    (m, k, n) for m in (8, 10) for k, n in YI_FFN]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", _CARD_SHAPES)
@pytest.mark.parametrize("dac_bits,levels", [(8, 16), (0, 1), (4, 256)])
def test_imac_mvm_kernel_matches_plain_on_card(cuda, m, k, n, dac_bits, levels):
    x, w = (torch.as_tensor(a, device=cuda) for a in _mvm_inputs(m + k + n, m, k, n))
    before = mvm_ops.launches
    got = mvm_ops.imac_mvm(x, w, dac_bits=dac_bits, levels=levels)
    want = mvm_ref.imac_mvm_ref(x, w, dac_bits=dac_bits, levels=levels)
    torch.cuda.synchronize()
    assert mvm_ops.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4, 4096, 11008), (12, 11008, 4096), (16, 4097, 4095),
                                   (300, 300, 129), (32, 4096, 11008)])
def test_imac_mvm_kernel_relaunch_is_bit_identical_on_card(cuda, dtype, m, k, n):
    x, w = (torch.as_tensor(a, device=cuda) for a in _mvm_inputs(k, m, k, n))
    x = x.to(dtype)
    first, again = mvm_ops.imac_mvm(x, w), mvm_ops.imac_mvm(x, w)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(9, 4096, 11008), (12, 11008, 4096), (17, 4097, 129),
                                   (32, 4096, 11008), (32, 11008, 4096), (33, 300, 129),
                                   (64, 11008, 4095), (1003, 300, 129),
                                   (9, 1, 1), (20, 17, 3), (130, 16, 8)])  # boxes past K, N
@pytest.mark.parametrize("dac_bits,levels", [(8, 16), (4, 4), (1, 2), (8, 128)])
def test_imac_mvm_int8_route_is_the_levels_ref_bit_for_bit_on_card(cuda, dtype, m, k, n,
                                                                   dac_bits, levels):
    x, w = (torch.as_tensor(a, device=cuda) for a in _mvm_inputs(m + n, m, k, n))
    x = x.to(dtype)
    assert mvm_ops.plan_for(x, w, dac_bits=dac_bits, levels=levels).route == "int8"
    got = mvm_ops.imac_mvm(x, w, dac_bits=dac_bits, levels=levels)
    want = mvm_ref.imac_mvm_levels_ref(x, w, dac_bits=dac_bits, levels=levels)
    plain = mvm_ref.imac_mvm_ref(x, w, dac_bits=dac_bits, levels=levels)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6 * k)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(40, 300, 129), (32, 4096, 11008)])
def test_imac_mvm_int8_route_gives_nan_rows_and_columns_on_card(cuda, m, k, n):
    x, w = (torch.as_tensor(a, device=cuda) for a in _mvm_inputs(m, m, k, n))
    x[3, 7], w[11, 5] = float("nan"), float("nan")
    x[5, 0], w[0, 9] = float("inf"), -float("inf")
    got = mvm_ops.imac_mvm(x, w)
    want = mvm_ref.imac_mvm_ref(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan()) and int(got.isnan().sum()) == m + n - 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * k, equal_nan=True)
    torch.testing.assert_close(got, mvm_ref.imac_mvm_levels_ref(x, w), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", YI_FFN)
def test_imac_mvm_device_plan_takes_the_int8_route_at_32_slots_on_card(cuda, k, n):
    x = torch.zeros((32, k), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((k, n), device=cuda)
    plan = mvm_ops.plan_for(x, w)
    assert plan.route == "int8" and plan.resident > 0 and plan.waves >= 1
    assert mvm_ops.plan_for(x, w, levels=256).route == "tile64"


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 12])
@pytest.mark.parametrize("k,n", YI_FFN)
def test_imac_mvm_device_plan_runs_two_blocks_per_sm_on_card(cuda, m, k, n):
    x = torch.zeros((m, k), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((k, n), device=cuda)
    plan = mvm_ops.plan_for(x, w, dac_bits=0, levels=1)   # M = 12 takes int8 at 8/16
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan.route == "splitk" and plan.blocks >= 2 * sms and plan.resident > 0


def _card_attn_inputs(device, dtype, b, h, hkv, s, dk, dv, lens):
    """Inputs on the card; `lens` "random" (1..S), "ragged" (1, S, a split
    boundary, one past it and S + 7 first, then random) or "serving" (the
    serving path's lengths, 9..28)."""
    q, k, v, rand = _attn_inputs(s, b, h, hkv, s, dk, dv)
    if lens == "ragged":
        fill = [1, s, s // 8, s // 8 + 1, s + 7][:b]
        rand[:len(fill)] = fill
    elif lens == "serving":
        rand = np.random.default_rng(b).integers(9, 29, (b,)).astype(np.int32)
    q, k, v = (torch.as_tensor(a, device=device).to(dtype) for a in (q, k, v))
    return q, k, v, torch.as_tensor(rand, device=device)


_CARD_ATTN = [(4, 32, 4, 256, 128, 128, "random"),
              (4, 32, 4, 256, 128, 128, "serving"),      # the serving path's shape and lengths
              (32, 32, 4, 8192, 128, 128, "ragged"),
              (32, 32, 4, 4096, 128, 128, "ragged"),     # yi-9b's 4K context, 32 slots
              (3, 24, 4, 1000, 64, 64, "ragged"),        # head dim 64, G = 6
              (2, 8, 1, 300, 576, 512, "random"),        # MLA-like: the rows route
              (3, 8, 4, 200, 32, 48, "random"),
              (3, 8, 4, 200, 30, 20, "random")]          # unaligned rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,dk,dv,lens", _CARD_ATTN)
def test_decode_attention_kernel_matches_plain_on_card(cuda, dtype, b, h, hkv, s, dk, dv, lens):
    q, k, v, lens = _card_attn_inputs(cuda, dtype, b, h, hkv, s, dk, dv, lens)
    before = da_ops.launches
    got = da_ops.decode_attention(q, k, v, lens)
    want = da_ref.decode_attention_ref(q, k, v, lens)
    torch.cuda.synchronize()
    assert da_ops.launches == before + 1
    _assert_attention_close(got, want)


def _assert_attention_close(got, want):
    """float32 within rtol = atol = 1e-5; bfloat16 within one bfloat16 ulp
    (<= 2^-7 of the value, so 1e-2 |want|) plus 1e-3 of the row's largest
    |want|: both round the same float32 sums to bfloat16."""
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    got, want = got.float(), want.float()
    tol = 1e-2 * want.abs() + 1e-3 * want.abs().amax(-1, keepdim=True)
    err = (got - want).abs()
    assert bool((err <= tol).all()), f"max abs error {float(err.max()):.3g}"


@pytest.mark.cuda
def test_decode_attention_keeps_p_low_half_on_card(cuda):
    # Even positions score m, odd ones m - 6.9e-4 (p = 0.99931 rounds to 1
    # in bfloat16) and v = +/-1 by parity: out = +/-(1 - p) / (1 + p)
    # = +/-3.45e-4 comes only from the low half of the kernel's P.
    b, s, hkv, g, d = 4, 256, 4, 8, 128
    parity = torch.arange(s, device=cuda) % 2
    sign = torch.as_tensor(np.random.default_rng(0).choice([-1.0, 1.0], d), device=cuda)
    q = torch.zeros((b, hkv * g, d), device=cuda)
    q[..., 0] = 2.0
    k = torch.zeros((b, s, hkv, d), device=cuda)
    k[..., 0] = (1.0 - 2.0 ** -8 * parity)[None, :, None]
    v = (1.0 - 2.0 * parity)[None, :, None, None] * sign * torch.ones((b, s, hkv, d), device=cuda)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    lens = torch.full((b,), s, dtype=torch.int32, device=cuda)
    assert da_ops.plan_for(q, k, v).route == "splitkv"
    want = da_ref.decode_attention_ref(q, k, v, lens)
    assert 3e-4 < float(want.float().abs().min()) <= float(want.float().abs().max()) < 4e-4
    _assert_attention_close(da_ops.decode_attention(q, k, v, lens), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,dk,dv,lens", [(4, 32, 4, 256, 128, 128, "serving"),
                                                   (32, 32, 4, 4096, 128, 128, "ragged"),
                                                   (2, 8, 1, 300, 576, 512, "random")])
def test_decode_attention_relaunch_is_bit_identical_on_card(cuda, dtype, b, h, hkv, s, dk, dv,
                                                            lens):
    q, k, v, lens = _card_attn_inputs(cuda, dtype, b, h, hkv, s, dk, dv, lens)
    first, again = da_ops.decode_attention(q, k, v, lens), da_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [8192, 4096])
def test_decode_attention_device_plan_fills_the_card_in_one_wave_on_card(cuda, dtype, s):
    q = torch.zeros((32, 32, 128), device=cuda, dtype=dtype)
    k = torch.zeros((32, s, 4, 128), device=cuda, dtype=dtype)
    plan = da_ops.plan_for(q, k, k)
    if dtype == torch.float32:                # no float32 caller at this shape: the rows route
        assert plan == da_ops.Plan("rows", 0, 0, 32 * 4)
        return
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan.route == "splitkv" and plan.waves == 1 and plan.blocks > sms
