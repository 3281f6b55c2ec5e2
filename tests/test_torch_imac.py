"""Parity of the port's IMAC layer modules with the reference package.

Covers partitioning, mapWB (with the reference's variation draw injected),
devices, `linear_forward` in both modes (with the reference's read-noise
draw injected), `IMACNetwork`, the digital MLP and the digits. Inputs are
numpy arrays handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import devices as jdevices
from repro.core import imac as jimac
from repro.core import mapping as jmapping
from repro.core import partition as jpartition
from repro.core import solver as jsolver
from repro.core.digital import mlp_forward as j_mlp_forward
from repro.core.interconnect import DEFAULT_INTERCONNECT as J_WIRES
from repro.core.interconnect import scaled_interconnect as j_scaled_interconnect
from repro.core.neurons import get_neuron as j_get_neuron
from repro_torch.core import devices as tdevices
from repro_torch.core import imac as timac
from repro_torch.core import mapping as tmapping
from repro_torch.core import partition as tpartition
from repro_torch.core import solver as tsolver
from repro_torch.core.digital import accuracy, init_mlp, mlp_forward, train_mlp
from repro_torch.core.interconnect import DEFAULT_INTERCONNECT as T_WIRES
from repro_torch.core.interconnect import scaled_interconnect
from repro_torch.core.neurons import get_neuron as t_get_neuron
from repro_torch.data.digits import make_digits, train_test_split
from repro_torch.device import resolve_device
from repro_torch.weights import params_from_numpy


def _params(seed, topology, scale=0.4):
    rng = np.random.default_rng(seed)
    return [
        (rng.normal(0, scale, (a, b)).astype(np.float32),
         rng.normal(0, 0.1, (b,)).astype(np.float32))
        for a, b in zip(topology[:-1], topology[1:])
    ]


# ---------------------------------------------------------------------------
# Partitioning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fan_in,fan_out,hp,vp", [(400, 120, 13, 4), (20, 7, 3, 2), (5, 3, 1, 1)])
def test_partition_matches_reference(fan_in, fan_out, hp, vp):
    jp = jpartition.plan_partition(fan_in, fan_out, hp, vp)
    tp = tpartition.plan_partition(fan_in, fan_out, hp, vp)
    assert tpartition.auto_partition(fan_in, fan_out, 32, 32) == \
        jpartition.auto_partition(fan_in, fan_out, 32, 32)
    assert (tp.rows, tp.cols, tp.row_pad, tp.col_pad) == (jp.rows, jp.cols, jp.row_pad, jp.col_pad)
    rng = np.random.default_rng(fan_in)
    g = rng.uniform(size=(2, fan_in + 1, fan_out)).astype(np.float32)
    tiles = tpartition.tile_matrix(torch.as_tensor(g), tp)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jpartition.tile_matrix(jnp.asarray(g), jp)))
    np.testing.assert_array_equal(tpartition.untile_matrix(tiles[0], tp).numpy(), g[0])
    v = rng.uniform(size=(3, fan_in + 1)).astype(np.float32)
    np.testing.assert_array_equal(
        tpartition.tile_inputs(torch.as_tensor(v), tp).numpy(),
        np.asarray(jpartition.tile_inputs(jnp.asarray(v), jp)),
    )
    per_tile = rng.uniform(size=(2, 3, hp * vp, tp.cols)).astype(np.float32)
    np.testing.assert_allclose(
        tpartition.combine_outputs(torch.as_tensor(per_tile), tp).numpy(),
        np.asarray(jpartition.combine_outputs(jnp.asarray(per_tile), jp)), rtol=1e-6,
    )


@pytest.mark.parametrize("topology,rows,cols,hp,vp", [
    ((400, 120, 84, 10), 32, 32, None, None),       # the paper's Table III arithmetic
    ((400, 120, 84, 10), 64, 16, None, None),
    ((20, 7, 3), 8, 8, (3, 1), (2, 1)),             # given partitions
])
def test_plan_topology_matches_reference(topology, rows, cols, hp, vp):
    got = tpartition.plan_topology(topology, rows, cols, hp, vp)
    want = jpartition.plan_topology(topology, rows, cols, hp, vp)
    assert [(p.hp, p.vp, p.rows, p.cols, p.total_rows, p.total_cols) for p in got] == \
        [(p.hp, p.vp, p.rows, p.cols, p.total_rows, p.total_cols) for p in want]
    with pytest.raises(ValueError, match="length mismatch"):
        tpartition.plan_topology(topology, rows, cols, (1,), (1,))


@pytest.mark.parametrize("scale", [0.5, 1.0, 2.5])
def test_scaled_interconnect_matches_reference(scale):
    got, want = scaled_interconnect(scale), j_scaled_interconnect(scale)
    for field in ("resistivity", "thickness", "width", "pitch", "cap_per_m"):
        assert getattr(got, field) == getattr(want, field)
    assert got.r_segment == want.r_segment and got.c_segment == want.c_segment


def test_build_plans_paper_partitions():
    plans = timac.build_plans([400, 120, 84, 10], timac.IMACConfig())
    assert [p.hp for p in plans] == [13, 4, 3]
    assert [p.vp for p in plans] == [4, 3, 1]
    with pytest.raises(ValueError):
        tpartition.plan_partition(4, 3, 6, 1)


# ---------------------------------------------------------------------------
# Devices, interconnect, neurons
# ---------------------------------------------------------------------------


def test_quantize_rounds_half_to_even_like_reference():
    tech_j = jdevices.custom_tech(1e3, 2e3, levels=5)
    tech_t = tdevices.custom_tech(1e3, 2e3, levels=5)
    step = tech_j.g_range / 4
    # Exact half-steps land on both sides of the tie.
    g = np.asarray([tech_j.g_off + (k + 0.5) * step for k in range(4)]
                   + list(np.linspace(tech_j.g_off, tech_j.g_on, 17)), np.float32)
    np.testing.assert_array_equal(
        tech_t.quantize(torch.as_tensor(g)).numpy(), np.asarray(tech_j.quantize(jnp.asarray(g)))
    )


def test_perturb_and_stuck_faults_with_reference_draws():
    tech_j = jdevices.custom_tech(8.5e3, 25.5e3, sigma_rel=0.1)
    tech_t = tdevices.custom_tech(8.5e3, 25.5e3, sigma_rel=0.1)
    g = np.random.default_rng(0).uniform(tech_j.g_off, tech_j.g_on, (6, 5)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, g.shape, jnp.float32))
    np.testing.assert_allclose(
        tech_t.perturb(torch.as_tensor(noise), torch.as_tensor(g)).numpy(),
        np.asarray(tech_j.perturb(key, jnp.asarray(g))), rtol=1e-6,
    )
    u = np.array(jax.random.uniform(key, (40, 7)))
    j_on, j_off = jdevices.sample_stuck_faults(key, (40, 7), 0.1, 0.2)
    t_on, t_off = tdevices.sample_stuck_faults(torch.as_tensor(u), (40, 7), 0.1, 0.2)
    np.testing.assert_array_equal(t_on.numpy(), np.asarray(j_on))
    np.testing.assert_array_equal(t_off.numpy(), np.asarray(j_off))
    g2 = np.random.default_rng(1).uniform(size=(40, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tdevices.apply_stuck_faults(torch.as_tensor(g2), t_on, t_off, 2.0, -1.0).numpy(),
        np.asarray(jdevices.apply_stuck_faults(jnp.asarray(g2), j_on, j_off, 2.0, -1.0)),
    )
    with pytest.raises(ValueError):
        tdevices.sample_stuck_faults(torch.Generator(), (2, 2), 0.7, 0.6)


def test_technology_tables_match_reference():
    for name, tech in jdevices.TECHNOLOGIES.items():
        ported = tdevices.get_tech(name.lower())
        assert (ported.r_low, ported.r_high, ported.levels) == (tech.r_low, tech.r_high, tech.levels)
    assert T_WIRES.r_segment == J_WIRES.r_segment
    assert T_WIRES.elmore_delay(31) == J_WIRES.elmore_delay(31)
    z = np.linspace(-12, 12, 25, dtype=np.float32)
    for kind in ("sigmoid", "tanh", "relu", "linear"):
        np.testing.assert_allclose(
            t_get_neuron(kind)(torch.as_tensor(z)).numpy(),
            np.asarray(j_get_neuron(kind)(jnp.asarray(z))), rtol=1e-6, atol=1e-7,
        )


# ---------------------------------------------------------------------------
# mapWB
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels,sigma", [(0, 0.0), (16, 0.0), (0, 0.1), (32, 0.05)])
def test_map_wb_matches_reference(levels, sigma):
    (w, b), = _params(5, [9, 6])
    tech_j = jdevices.custom_tech(2.5e3, 100e3, levels=levels, sigma_rel=sigma)
    tech_t = tdevices.custom_tech(2.5e3, 100e3, levels=levels, sigma_rel=sigma)
    key = jax.random.PRNGKey(11) if sigma else None
    ref = jmapping.map_wb(jnp.asarray(w), jnp.asarray(b), tech_j, 0.8, variation_key=key)
    variation = None
    if key is not None:  # the reference's own draws, handed to the port
        kp, kn = jax.random.split(key)
        shape = (w.shape[0] + 1, w.shape[1])
        variation = tuple(torch.as_tensor(np.array(jax.random.normal(k, shape, jnp.float32)))
                          for k in (kp, kn))
    got = tmapping.map_wb(torch.as_tensor(w), torch.as_tensor(b), tech_t, 0.8, variation=variation)
    np.testing.assert_allclose(got.g_pos.numpy(), np.asarray(ref.g_pos), rtol=1e-6)
    np.testing.assert_allclose(got.g_neg.numpy(), np.asarray(ref.g_neg), rtol=1e-6)
    assert got.w_scale == pytest.approx(ref.w_scale, rel=1e-7)
    assert got.k == pytest.approx(ref.k, rel=1e-7)
    assert got.fan_in == 9 and got.fan_out == 6


def test_map_network_with_generator_is_deterministic():
    params = params_from_numpy(_params(6, [7, 5, 3]))
    tech = tdevices.custom_tech(2.5e3, 100e3, sigma_rel=0.1)
    a = tmapping.map_network(params, tech, 0.8, variation=torch.Generator().manual_seed(1))
    b = tmapping.map_network(params, tech, 0.8, variation=torch.Generator().manual_seed(1))
    assert all(torch.equal(x.g_pos, y.g_pos) for x, y in zip(a, b))
    plain = tmapping.map_network(params, tech, 0.8)
    assert not torch.equal(a[0].g_pos, plain[0].g_pos)


# ---------------------------------------------------------------------------
# linear_forward / IMACNetwork
# ---------------------------------------------------------------------------


def _stacked_layer(seed, fan_in, fan_out, configs=("MRAM", "RRAM")):
    (w, b), = _params(seed, [fan_in, fan_out])
    jm = [jmapping.map_wb(jnp.asarray(w), jnp.asarray(b), jdevices.get_tech(t), 0.8) for t in configs]
    g_pos = np.stack([np.asarray(m.g_pos) for m in jm])
    g_neg = np.stack([np.asarray(m.g_neg) for m in jm])
    k = np.asarray([m.k for m in jm], np.float32)
    return g_pos, g_neg, k


@pytest.mark.parametrize("parasitics", [True, False])
@pytest.mark.parametrize("per_config", [False, True])
def test_linear_forward_matches_reference_with_read_noise(parasitics, per_config):
    fan_in, fan_out, batch = 20, 7, 4
    g_pos, g_neg, k = _stacked_layer(7, fan_in, fan_out)
    a = np.random.default_rng(8).uniform(size=(batch, fan_in)).astype(np.float32)
    jplan = jpartition.plan_partition(fan_in, fan_out, 3, 2)
    tplan = tpartition.plan_partition(fan_in, fan_out, 3, 2)
    rel = np.asarray([0.02, 0.05], np.float32)
    r = np.asarray([13.8, 20.0], np.float32)
    # Few sweeps keep the residual well above its float32 noise floor.
    jcp = jsolver.CircuitParams(r_row=jnp.asarray(r), r_col=jnp.asarray(r), gs_iters=12, tol=0.0)
    tcp = tsolver.CircuitParams(r_row=torch.as_tensor(r), r_col=torch.as_tensor(r),
                                gs_iters=12, tol=0.0)
    key = jax.random.PRNGKey(9)
    shape = (2, batch, fan_out) if per_config else (batch, fan_out)
    noise = np.array(jax.random.normal(key, shape, jnp.float32))
    ref = jax.jit(lambda gp, gn, a: jimac.linear_forward(
        gp, gn, jnp.asarray(k), 0.8, jplan, jcp,
        j_get_neuron("sigmoid"), a, parasitics=parasitics,
        solve_options=jsolver.SolveOptions(backend="scan"), noise_key=key,
        read_noise_rel=jnp.asarray(rel), noise_per_config=per_config,
    ))(jnp.asarray(g_pos), jnp.asarray(g_neg), jnp.asarray(a))
    got = timac.linear_forward(
        torch.as_tensor(g_pos), torch.as_tensor(g_neg), torch.as_tensor(k), 0.8, tplan, tcp,
        t_get_neuron("sigmoid"), torch.as_tensor(a), parasitics=parasitics,
        noise=torch.as_tensor(noise), read_noise_rel=torch.as_tensor(rel),
        noise_per_config=per_config,
    )
    # z is a difference of two nearly equal column currents, which turns
    # float32 rounding of the currents into a larger relative error of z;
    # atol is therefore 1e-5 of the largest |z| (and of the activations).
    for name, x, y in zip(("act", "power", "residual", "z"), got[:4], ref[:4]):
        y = np.asarray(y)
        atol = 1e-5 * float(np.abs(y).max()) if name in ("act", "z") else 0.0
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-5, atol=atol, err_msg=name)
    assert got[4] == int(ref[4])


def test_imac_network_matches_reference():
    params = _params(10, [24, 12, 5])
    x = np.random.default_rng(11).uniform(size=(6, 24)).astype(np.float32)
    jcfg = jimac.IMACConfig(tech="RRAM", array_rows=8, array_cols=8, gs_tol=0.0)
    tcfg = timac.IMACConfig(tech="RRAM", array_rows=8, array_cols=8, gs_tol=0.0)
    jnet = jimac.IMACNetwork([(jnp.asarray(w), jnp.asarray(b)) for w, b in params], jcfg)
    tnet = timac.IMACNetwork(params_from_numpy(params), tcfg, device="cpu")
    assert tnet.hp == jnet.hp and tnet.vp == jnet.vp
    assert sorted(n for n, _ in tnet.named_buffers()) == ["g_neg_0", "g_neg_1", "g_pos_0", "g_pos_1"]
    jout, jstats = jax.jit(
        lambda x: jnet(x, solve_options=jsolver.SolveOptions(backend="scan"))
    )(jnp.asarray(x))
    tout, tstats = tnet(torch.as_tensor(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tnet.total_power(tstats)), float(jnet.total_power(jstats)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tnet.total_latency(tstats)),
                               float(jnet.total_latency(jstats)), rtol=1e-6)
    assert [s.sweeps for s in tstats] == [int(s.sweeps) for s in jstats]


def test_layer_latency_matches_reference():
    for plan_args in ((400, 120, 13, 4), (84, 10, 3, 1)):
        jp = jpartition.plan_partition(*plan_args)
        tp = tpartition.plan_partition(*plan_args)
        assert timac.layer_latency(tp, T_WIRES, t_get_neuron("sigmoid")) == \
            jimac.layer_latency(jp, J_WIRES, j_get_neuron("sigmoid"))


# ---------------------------------------------------------------------------
# Digital MLP, digits, device rule
# ---------------------------------------------------------------------------


def test_mlp_forward_matches_reference():
    params = _params(12, [30, 16, 4])
    x = np.random.default_rng(13).uniform(size=(9, 30)).astype(np.float32)
    for act in ("sigmoid", "tanh", "relu"):
        np.testing.assert_allclose(
            mlp_forward(params_from_numpy(params), torch.as_tensor(x), act).numpy(),
            np.asarray(j_mlp_forward([(jnp.asarray(w), jnp.asarray(b)) for w, b in params],
                                     jnp.asarray(x), act)),
            rtol=1e-5, atol=1e-6,
        )


def test_train_mlp_reaches_reference_accuracy():
    """Statistical parity: the reference's test MLP reaches > 0.9 too."""
    xtr, ytr, xte, yte = train_test_split(1200, 300, seed=0, device="cpu")
    params = train_mlp([400, 48, 24, 10], xtr, ytr, steps=250, device="cpu")
    assert [tuple(w.shape) for w, _ in params] == [(400, 48), (48, 24), (24, 10)]
    assert accuracy(params, xte, yte) > 0.9


def test_init_mlp_is_glorot_and_seeded():
    a = init_mlp([50, 20, 10], generator=torch.Generator().manual_seed(4))
    b = init_mlp([50, 20, 10], generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(x[0], y[0]) for x, y in zip(a, b))
    assert abs(float(a[0][0].std()) - (2.0 / 70) ** 0.5) < 0.02
    assert all(float(bias.abs().max()) == 0.0 for _, bias in a)


def test_make_digits_shapes_and_determinism():
    x, y = make_digits(64, seed=3, device="cpu")
    x2, y2 = make_digits(64, seed=3, device="cpu")
    assert x.shape == (64, 400) and x.dtype == torch.float32 and y.dtype == torch.long
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert set(y.tolist()) <= set(range(10))


def test_entry_points_refuse_to_run_on_cpu_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_digits(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mlp([4, 2], torch.zeros(3, 4), torch.zeros(3, dtype=torch.long), steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        timac.IMACNetwork(params_from_numpy(_params(0, [3, 2])), timac.IMACConfig())
    assert resolve_device("cpu") == torch.device("cpu")
