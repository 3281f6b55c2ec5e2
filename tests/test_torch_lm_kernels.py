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
    plan = mvm_ops.launch_plan(m, k, n, _h100_clusters)
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
    plan = mvm_ops.launch_plan(m, k, n, _h100_clusters, sms=132)
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


@pytest.mark.parametrize("m,k,n", [(17, 4096, 11008), (2048, 4096, 11008), (1003, 300, 129)])
def test_launch_plan_takes_the_64x64_tile_past_m_16(m, k, n):
    plan = mvm_ops.launch_plan(m, k, n, _h100_clusters)
    assert plan.route == "tile64" and plan.m_bucket == 0
    assert plan.blocks == -(-n // 64) * -(-m // 64)


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


# M at and around the split-K route's buckets and its edge (16 | 17), K not
# a multiple of the splits, N not a multiple of 4 (one-float w loads); and
# the prefills' M = 8 (bucket 8, full) and 10 (bucket 12, partial) at
# yi-9b's FFN shapes.
_CARD_SHAPES = [(4, 4096, 11008), (12, 11008, 4096), (1003, 300, 129), (1, 1, 1)] + [
    (m, k, n) for m in (1, 4, 12, 16, 17) for k in (4097, 11008) for n in (129, 4095)] + [
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
                                   (300, 300, 129)])
def test_imac_mvm_kernel_relaunch_is_bit_identical_on_card(cuda, dtype, m, k, n):
    x, w = (torch.as_tensor(a, device=cuda) for a in _mvm_inputs(k, m, k, n))
    x = x.to(dtype)
    first, again = mvm_ops.imac_mvm(x, w), mvm_ops.imac_mvm(x, w)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 12])
@pytest.mark.parametrize("k,n", YI_FFN)
def test_imac_mvm_device_plan_runs_two_blocks_per_sm_on_card(cuda, m, k, n):
    x = torch.zeros((m, k), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((k, n), device=cuda)
    plan = mvm_ops.plan_for(x, w)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan.route == "splitk" and plan.blocks >= 2 * sms and plan.resident > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,dk,dv", [(4, 32, 4, 256, 128, 128), (2, 8, 1, 300, 576, 512),
                                              (3, 8, 4, 200, 32, 48),
                                              (3, 8, 4, 200, 30, 20)])   # unaligned rows
def test_decode_attention_kernel_matches_plain_on_card(cuda, dtype, b, h, hkv, s, dk, dv):
    q, k, v, lens = (torch.as_tensor(a, device=cuda)
                     for a in _attn_inputs(s, b, h, hkv, s, dk, dv))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = da_ops.launches
    got = da_ops.decode_attention(q, k, v, lens)
    want = da_ref.decode_attention_ref(q, k, v, lens)
    torch.cuda.synchronize()
    assert da_ops.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
