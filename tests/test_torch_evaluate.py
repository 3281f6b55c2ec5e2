"""Parity of the port's testIMAC path (`evaluate_batch` / `test_imac`).

Topology [64, 24, 10] on 16x16 arrays, two stacked configurations (MRAM,
RRAM), 48 samples in chunks of 16. The weights go through
`params_from_numpy`. Both port backends are held to the reference's
``"scan"`` evaluation: identical predictions except at near-ties,
avg_power and per_layer_power to rtol=1e-4, latency to rtol=1e-6, equal
H_P / V_P.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import devices as jdevices
from repro.core import evaluate as jevaluate
from repro.core import imac as jimac
from repro.core import solver as jsolver
from repro.core.mapping import map_network as j_map_network
from repro_torch.core import evaluate as tevaluate
from repro_torch.core.devices import custom_tech
from repro_torch.core import imac as timac
from repro_torch.core.mapping import map_network as t_map_network
from repro_torch.core.solver import SolveOptions
from repro_torch.weights import mapped_from_numpy, params_from_numpy

TOPOLOGY = [64, 24, 10]
N_SAMPLES, CHUNK = 48, 16
TECHS = ("MRAM", "RRAM")


def _params(seed=1):
    rng = np.random.default_rng(seed)
    return [
        (rng.normal(0, 0.4, (a, b)).astype(np.float32), rng.normal(0, 0.1, (b,)).astype(np.float32))
        for a, b in zip(TOPOLOGY[:-1], TOPOLOGY[1:])
    ]


def _data(seed=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (N_SAMPLES, TOPOLOGY[0])).astype(np.float32),
            rng.integers(0, 10, N_SAMPLES))


def _jax_outputs(jparams, x, jcfgs):
    """Final-layer outputs of the reference's stacked forward, chunk by chunk."""
    plans = jimac.build_plans(TOPOLOGY, jcfgs[0])
    mapped = [j_map_network(jparams, c.resolved_tech(), v_unit=c.vdd) for c in jcfgs]
    g_pos, g_neg, k = jevaluate.stack_mapped(mapped, jnp.float32)

    def per_config(values):
        return jnp.asarray(values, jnp.float32)

    r_seg = per_config([c.interconnect.r_segment for c in jcfgs])

    def forward(xb):
        a = xb
        for layer, plan in enumerate(plans):
            cp = jsolver.CircuitParams(
                r_row=r_seg, r_col=r_seg, r_source=per_config([c.r_source for c in jcfgs]),
                r_tia=per_config([c.r_tia for c in jcfgs]),
                gs_iters=jsolver.suggest_iters(plan.rows, plan.cols),
                omega=per_config([c.sor_omega for c in jcfgs]), tol=jcfgs[0].gs_tol,
            )
            a = jimac.linear_forward(
                g_pos[layer], g_neg[layer], k[layer], jcfgs[0].vdd, plan, cp,
                jcfgs[0].resolved_neuron(), a, is_output=(layer == len(plans) - 1),
                solve_options=jsolver.SolveOptions(backend="scan"),
            )[0]
        return a

    fwd = jax.jit(forward)
    return np.concatenate(
        [np.asarray(fwd(jnp.asarray(x[i:i + CHUNK]))) for i in range(0, len(x), CHUNK)], axis=1
    )


@pytest.fixture(scope="module")
def reference():
    params = _params()
    x, y = _data()
    jparams = [(jnp.asarray(w), jnp.asarray(b)) for w, b in params]
    jcfgs = [jimac.IMACConfig(tech=t, array_rows=16, array_cols=16) for t in TECHS]
    results = jevaluate.evaluate_batch(
        jparams, jnp.asarray(x), jnp.asarray(y), jcfgs, n_samples=N_SAMPLES, chunk=CHUNK,
        solve_options=jsolver.SolveOptions(backend="scan"),
    )
    return dict(params=params, x=x, y=y, results=results,
                outputs=_jax_outputs(jparams, x, jcfgs))


def _cfgs(**kw):
    return [timac.IMACConfig(tech=t, array_rows=16, array_cols=16, **kw) for t in TECHS]


def _assert_predictions_agree(got, want):
    """Identical argmax except where the top-2 gap of `want` is within
    twice the largest output difference (a near-tie)."""
    diff = float(np.abs(got - want).max())
    top2 = np.sort(want, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) <= 2 * diff + 1e-6
    disagree = np.argmax(got, -1) != np.argmax(want, -1)
    assert not np.any(disagree & ~tie)


def _assert_result_close(got, want):
    assert got.hp == want.hp and got.vp == want.vp
    assert got.n_samples == want.n_samples
    np.testing.assert_allclose(got.avg_power, want.avg_power, rtol=1e-4)
    np.testing.assert_allclose(got.per_layer_power, want.per_layer_power, rtol=1e-4)
    np.testing.assert_allclose(got.latency, want.latency, rtol=1e-6)
    np.testing.assert_allclose(got.digital_accuracy, want.digital_accuracy, rtol=1e-6)


@pytest.mark.parametrize("backend", ["tridiag", "fused"])
def test_evaluate_batch_matches_reference(reference, backend):
    got = tevaluate.evaluate_batch(
        params_from_numpy(reference["params"]), torch.as_tensor(reference["x"]),
        torch.as_tensor(reference["y"]), _cfgs(), n_samples=N_SAMPLES, chunk=CHUNK,
        solve_options=SolveOptions(backend=backend), device="cpu",
    )
    assert len(got) == len(TECHS)
    for i, (g, w) in enumerate(zip(got, reference["results"])):
        _assert_result_close(g, w)
        assert tuple(g.outputs.shape) == (N_SAMPLES, TOPOLOGY[-1])
        _assert_predictions_agree(g.outputs.numpy(), reference["outputs"][i])
        # A sample's prediction only flips at a near-tie, so the error
        # counts agree up to those.
        assert abs(g.accuracy - w.accuracy) <= 2 / N_SAMPLES
        assert g.sweeps == (48, 48)
        assert np.isfinite(g.worst_residual)


def test_test_imac_matches_reference_single_config(reference):
    want = reference["results"][1]
    got = tevaluate.test_imac(
        params_from_numpy(reference["params"]), torch.as_tensor(reference["x"]),
        torch.as_tensor(reference["y"]), _cfgs()[1], n_samples=N_SAMPLES, chunk=CHUNK,
        device="cpu",
    )
    _assert_result_close(got, want)


def test_mapped_and_mapped_stacked_paths_match(reference):
    """Pre-mapped conductances (carried over from numpy) give the same result."""
    params = params_from_numpy(reference["params"])
    x, y = torch.as_tensor(reference["x"]), torch.as_tensor(reference["y"])
    cfgs = _cfgs()
    jparams = [(jnp.asarray(w), jnp.asarray(b)) for w, b in reference["params"]]
    mapped = [
        mapped_from_numpy(j_map_network(jparams, jdevices.get_tech(t), v_unit=0.8))
        for t in TECHS
    ]
    kw = dict(n_samples=N_SAMPLES, chunk=CHUNK, device="cpu")
    plain = tevaluate.evaluate_batch(params, x, y, cfgs, **kw)
    via_mapped = tevaluate.evaluate_batch(params, x, y, cfgs, mapped=mapped, **kw)
    stacked = tevaluate.concat_mapped([tevaluate.lift_mapped(m) for m in mapped])
    via_stacked = tevaluate.evaluate_batch(params, x, y, cfgs, mapped_stacked=stacked, **kw)
    for a, b, c in zip(plain, via_mapped, via_stacked):
        np.testing.assert_allclose(b.avg_power, a.avg_power, rtol=1e-6)
        assert c.avg_power == b.avg_power and c.accuracy == b.accuracy
        assert torch.equal(b.outputs, c.outputs)
    with pytest.raises(ValueError, match="mapped"):
        tevaluate.evaluate_batch(params, x, y, cfgs, mapped=mapped, mapped_stacked=stacked, **kw)


def test_stack_mapped_matches_port_mapping():
    params = params_from_numpy(_params())
    cfgs = _cfgs()
    mapped = [t_map_network(params, c.resolved_tech(), v_unit=c.vdd) for c in cfgs]
    g_pos, g_neg, k = tevaluate.stack_mapped(mapped, torch.float32)
    assert [tuple(g.shape) for g in g_pos] == [(2, 65, 24), (2, 25, 10)]
    assert torch.equal(g_neg[1][1], mapped[1][1].g_neg)
    np.testing.assert_allclose(k[0].numpy(), [mapped[0][0].k, mapped[1][0].k], rtol=1e-7)


def test_ideal_path_matches_reference(reference):
    """parasitics=False: the ideal-MVM path through the same engine."""
    jparams = [(jnp.asarray(w), jnp.asarray(b)) for w, b in reference["params"]]
    jcfgs = [jimac.IMACConfig(tech=t, array_rows=16, array_cols=16, parasitics=False)
             for t in TECHS]
    want = jevaluate.evaluate_batch(jparams, jnp.asarray(reference["x"]),
                                    jnp.asarray(reference["y"]), jcfgs, chunk=CHUNK)
    got = tevaluate.evaluate_batch(
        params_from_numpy(reference["params"]), torch.as_tensor(reference["x"]),
        torch.as_tensor(reference["y"]), _cfgs(parasitics=False), chunk=CHUNK, device="cpu",
    )
    for g, w in zip(got, want):
        _assert_result_close(g, w)
        assert g.accuracy == w.accuracy
        assert g.sweeps == (0, 0)


def test_structure_mismatch_and_sweep():
    params = params_from_numpy(_params())
    x, y = (torch.as_tensor(a) for a in _data())
    with pytest.raises(ValueError, match="structure"):
        tevaluate.evaluate_batch(params, x, y, [_cfgs()[0], timac.IMACConfig(array_rows=8)],
                                 device="cpu")
    assert tevaluate.evaluate_batch(params, x, y, [], device="cpu") == []
    named = [("ideal", dataclasses.replace(c, parasitics=False)) for c in _cfgs()]
    out = tevaluate.sweep(params, x, y, named, chunk=CHUNK, device="cpu")
    assert [name for name, _ in out] == ["ideal", "ideal"]
    key = tevaluate.structure_key(TOPOLOGY, _cfgs()[0])
    assert key == tevaluate.structure_key(TOPOLOGY, _cfgs()[1])


def test_read_noise_generator_is_deterministic():
    params = params_from_numpy(_params())
    x, y = (torch.as_tensor(a) for a in _data())
    cfg = timac.IMACConfig(tech=custom_tech(8.5e3, 25.5e3, read_noise_rel=0.05),
                           array_rows=16, array_cols=16, parasitics=False)
    runs = [
        tevaluate.test_imac(params, x, y, cfg, chunk=CHUNK, device="cpu",
                            noise=torch.Generator().manual_seed(5))
        for _ in range(2)
    ]
    quiet = tevaluate.test_imac(params, x, y, cfg, chunk=CHUNK, device="cpu")
    assert torch.equal(runs[0].outputs, runs[1].outputs)
    assert not torch.equal(runs[0].outputs, quiet.outputs)
