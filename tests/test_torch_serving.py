"""The port's LM serving path against the reference's, on the CPU.

Weights cross over through `lm_params_from_numpy` (the reference's
`Model.init` pytree as numpy arrays), never through a shared seed.
Logits are held at rtol 1e-4, with an atol of 1e-5 * max|logit| for
logits near 0 (float32 sums taken in another order err in proportion to
their largest terms).

With ``analog_mvm`` the same tolerance holds, because the port is handed
the reference's DAC inputs: every `imac_mvm` call's normalised
activations are recorded on the reference side and replayed into the
port's call, after checking that the port's own agree with them to
XN_TOL. Inputs that agree that closely can round to another 8-bit DAC
level only at a .5 boundary, and such a tie-break is not a fault. Left
in, one such flip moves every output of its row, which can shift the
next projection's x_lo/x_hi and with them every level there.

Engine runs are compared row by row, in the order the tokens were
taken: every logits row is held at the tolerance above, the tokens may
part only where that row is a near-tie inside it, nothing after the
first parting is compared, and at least 90% of the tokens must be.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config
from repro.kernels.imac_mvm import ops as j_mvm_ops
from repro.models import build_model as j_build_model
from repro.models.common import rmsnorm as j_rmsnorm
from repro.models.common import rope as j_rope
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import registry
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.imac_mvm import ops as mvm_ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models.common import rmsnorm, rope
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeConfig, ServingEngine
from repro_torch.weights import lm_params_from_numpy

DENSE = ("yi-9b", "granite-3-8b", "phi3-medium-14b", "minicpm-2b")
RTOL, ATOL = 1e-4, 1e-5          # atol in units of max|logit|
XN_TOL = 1e-5                    # port vs reference DAC inputs; one 8-bit level is 3.9e-3


def _configs(arch, **changes):
    j = dataclasses.replace(j_get_config(arch).reduced(), **changes)
    t = dataclasses.replace(registry.get_config(arch).reduced(), **changes)
    return j, t


def _pair(arch, seed=0, **changes):
    """The reference model with its params, and the port's model carrying them."""
    jcfg, tcfg = _configs(arch, **changes)
    jm = j_build_model(jcfg, remat=False)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    lm_params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _assert_close(got, want, err_msg=""):
    """`got` within rtol 1e-4 and 1e-5 * max|want| of `want`."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * float(np.abs(want).max()), err_msg=err_msg)


def _assert_logits(got, want, vocab):
    _assert_close(got.numpy()[..., :vocab], np.asarray(want)[..., :vocab])


class DacReplay:
    """Hands the port the reference's DAC inputs (see the module docstring).

    The reference's `imac_mvm` records each call's normalised activations
    (a debug callback, so it also records inside jitted code); the port's
    `imac_mvm` takes the next recorded input in call order, checks its own
    against it, and multiplies the recorded one.
    """

    def __init__(self, monkeypatch):
        self.recorded, self.replayed = [], 0
        j_orig, t_orig = j_mvm_ops.imac_mvm, mvm_ops.imac_mvm

        def record(xn, wn, **kw):
            jax.debug.callback(lambda a: self.recorded.append(np.asarray(a)), xn, ordered=True)
            return j_orig(xn, wn, **kw)

        def replay(xn, wn, **kw):
            jax.effects_barrier()
            want = self.recorded[self.replayed]
            self.replayed += 1
            got = xn.numpy()
            assert got.shape == want.shape, (got.shape, want.shape)
            err = float(np.abs(got - want).max())
            assert err <= XN_TOL, f"imac_mvm call {self.replayed}: DAC inputs differ by {err:.3g}"
            return t_orig(torch.tensor(want), wn, **kw)

        monkeypatch.setattr(j_mvm_ops, "imac_mvm", record)
        monkeypatch.setattr(mvm_ops, "imac_mvm", replay)

    def check_all_replayed(self):
        jax.effects_barrier()
        assert self.replayed == len(self.recorded) > 0


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference(arch, reduced):
    j, t = j_get_config(arch), registry.get_config(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.vocab_padded == j.vocab_padded


def test_registry_refuses_unported_archs():
    with pytest.raises(NotImplementedError, match="not ported"):
        registry.get_config("deepseek-v3-671b")
    with pytest.raises(NotImplementedError, match="not ported"):
        registry.get_config("rwkv6")
    with pytest.raises(KeyError):
        registry.get_config("no-such-model")
    assert registry.get_config("yi_9b").name == "yi-9b"
    assert sorted(registry.ARCHS) == sorted(DENSE)


def test_rope_and_rmsnorm_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4).numpy(),
        np.asarray(j_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)), rtol=1e-5, atol=1e-5)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    np.testing.assert_allclose(
        rmsnorm(torch.as_tensor(scale), torch.as_tensor(x), 1e-5).numpy(),
        np.asarray(j_rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)),
        rtol=1e-5, atol=1e-6)


# -------------------------------------------------------- prefill / decode


@pytest.mark.parametrize("analog", [False, True])
def test_prefill_and_decode_logits_match_reference(analog, monkeypatch):
    jm, params, tm = _pair("yi-9b", n_layers=2, analog_mvm=analog)
    dac = DacReplay(monkeypatch) if analog else None
    vocab = tm.cfg.vocab
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (2, 7))
    jl, jcache = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)}, cache_len=16)
    tl, tcache = tm.prefill(torch.as_tensor(toks), 16)
    assert tuple(tl.shape) == (2, 1, tm.cfg.vocab_padded)
    _assert_logits(tl, jl, vocab)
    np.testing.assert_array_equal(tcache.length.numpy(), [7, 7])
    for _ in range(4):   # teacher-forced
        nxt = rng.integers(0, vocab, (2, 1))
        jl, jcache = jm.decode_step(params, jcache, jnp.asarray(nxt, jnp.int32))
        tl, tcache = tm.decode_step(tcache, torch.as_tensor(nxt))
        _assert_logits(tl, jl, vocab)
    np.testing.assert_array_equal(tcache.length.numpy(), [11, 11])
    jc = jcache["stages"][0]["l0"]["self"]                        # (L, B, S, KV, D) each
    _assert_close(tcache.k.numpy(), jc.k)
    _assert_close(tcache.v.numpy(), jc.v)
    if analog:
        dac.check_all_replayed()


@pytest.mark.parametrize("arch,changes", [
    ("granite-3-8b", dict(n_layers=2, vocab=500)),   # tied head; 500 -> 512 padded
    ("minicpm-2b", dict(n_layers=2)),                # scale_emb, scale_depth, scale_logits
    ("phi3-medium-14b", dict(n_layers=1)),
])
def test_forward_matches_reference(arch, changes):
    jm, params, tm = _pair(arch, seed=3, **changes)
    cfg = tm.cfg
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9))
    jl, _ = jm.forward(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl = tm.forward(torch.as_tensor(toks))
    _assert_logits(tl, jl, cfg.vocab)
    if cfg.vocab_padded != cfg.vocab:
        assert bool((tl[..., cfg.vocab:] <= -1e29).all())


def test_analog_forward_differs_from_digital_but_stays_close():
    _, _, dig = _pair("yi-9b", seed=4, n_layers=2)
    _, _, ana = _pair("yi-9b", seed=4, n_layers=2, analog_mvm=True)
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, 512, (1, 8)))
    before = mvm_ops.launches
    a, d = ana.forward(toks), dig.forward(toks)
    assert mvm_ops.launches == before          # CPU tensors take the plain version
    diff = float((a - d)[..., :512].abs().max())
    assert 0 < diff < 0.5 * float(d[..., :512].abs().max())


# ------------------------------------------------------------------ engine


def _jax_engine_run(jm, params, prompts, *, slots, cache_len, max_tokens, greedy=True):
    """The reference engine's requests, and the logits rows its tokens were
    taken from, as one {rid: row} per prefill and per decode tick."""
    eng = JServingEngine(jm, params, JServeConfig(slots=slots, cache_len=cache_len, greedy=greedy))
    events = []
    admitted = itertools.count()     # requests are admitted in rid order
    decode = eng._decode

    class Recording:
        def __getattr__(self, name):
            return getattr(jm, name)

        def prefill(self, p, batch, cache_len):
            logits, cache = jm.prefill(p, batch, cache_len=cache_len)
            events.append({next(admitted): np.asarray(logits[0, -1])})
            return logits, cache

    def recording_decode(p, cache, tok):
        logits, cache = decode(p, cache, tok)
        events.append({req.rid: np.asarray(logits[slot, 0])
                       for slot, req in enumerate(eng.slot_req) if req is not None})
        return logits, cache

    eng.model = Recording()
    eng._decode = recording_decode
    reqs = [JRequest(rid=i, prompt=p, max_tokens=max_tokens) for i, p in enumerate(prompts)]
    eng.run(reqs, max_ticks=200)
    return reqs, events


class RecordingModel:
    """The port's model, recording the logits rows the engine takes its
    tokens from, as `_jax_engine_run` does for the reference."""

    def __init__(self, model):
        self._model, self.engine, self.events = model, None, []
        self._admitted = itertools.count()

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, tokens, cache_len):
        logits, cache = self._model.prefill(tokens, cache_len=cache_len)
        self.events.append({next(self._admitted): logits[0, -1].numpy()})
        return logits, cache

    def decode_step(self, cache, tokens):
        logits, cache = self._model.decode_step(cache, tokens)
        self.events.append({req.rid: logits[slot, 0].numpy()
                            for slot, req in enumerate(self.engine.slot_req) if req is not None})
        return logits, cache


def _port_engine_run(tm, prompts, *, slots, cache_len, max_tokens, greedy=True):
    rec = RecordingModel(tm)
    eng = ServingEngine(rec, ServeConfig(slots=slots, cache_len=cache_len, greedy=greedy))
    rec.engine = eng
    reqs = [Request(rid=i, prompt=p, max_tokens=max_tokens) for i, p in enumerate(prompts)]
    eng.run(reqs, max_ticks=200)
    return reqs, rec.events, eng


def _assert_engines_agree(treqs, tevents, jreqs, jevents, vocab, *, min_share=0.9):
    """The port's engine run against the reference's (module docstring).

    Each row is held at the logits tolerance, the row where the tokens
    part included. Where the port took token a and the reference token b
    from rows within that tolerance, want[b] - want[a] is at most the
    tolerance at a plus that at b: the parting is a near-tie inside it.
    """
    assert len(tevents) == len(jevents), (len(tevents), len(jevents))
    taken = {r.rid: 0 for r in jreqs}
    compared = 0
    for t, (tev, jev) in enumerate(zip(tevents, jevents)):
        assert tev.keys() == jev.keys(), f"event {t}: slots {tev.keys()} != {jev.keys()}"
        parted = False
        for rid in jev:
            got, want = tev[rid], jev[rid]
            _assert_close(got[:vocab], want[:vocab], err_msg=f"event {t}, request {rid}")
            i = taken[rid]
            assert treqs[rid].output[i] == int(np.argmax(got)), f"request {rid} token {i}"
            assert jreqs[rid].output[i] == int(np.argmax(want)), f"request {rid} token {i}"
            taken[rid] += 1
            compared += 1
            parted |= treqs[rid].output[i] != jreqs[rid].output[i]
        if parted:
            break   # later rows follow other tokens
    total = sum(len(r.output) for r in jreqs)
    assert all(len(a.output) == len(b.output) for a, b in zip(treqs, jreqs))
    assert compared >= min_share * total, f"only {compared} of {total} tokens compared"
    return compared


@pytest.mark.parametrize("analog", [False, True])
def test_engine_matches_reference_engine(analog, monkeypatch):
    """5 requests over 2 slots (queueing, idle-slot decodes), greedy."""
    jm, params, tm = _pair("yi-9b", seed=6, n_layers=2, analog_mvm=analog)
    dac = DacReplay(monkeypatch) if analog else None
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, size=(5 + i,)) for i in range(5)]
    kw = dict(slots=2, cache_len=32, max_tokens=6)
    jreqs, jevents = _jax_engine_run(jm, params, prompts, **kw)
    mvm0, da0 = mvm_ops.launches, da_ops.launches
    treqs, tevents, eng = _port_engine_run(tm, prompts, **kw)
    assert (mvm_ops.launches, da_ops.launches) == (mvm0, da0)   # plain versions on the CPU
    assert all(r.done and len(r.output) == 6 for r in treqs)
    assert eng.stats.prefills == 5 and eng.stats.ticks > 0
    _assert_engines_agree(treqs, tevents, jreqs, jevents, tm.cfg.vocab)
    if analog:
        dac.check_all_replayed()


def test_engine_takes_greedy_false_and_decodes_like_the_reference():
    """`greedy=False` is accepted and read by nothing, as in the reference:
    both engines still decode greedily, to the same tokens as with
    `greedy=True`."""
    jm, params, tm = _pair("yi-9b", seed=3, n_layers=2)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tm.cfg.vocab, size=(4 + i,)) for i in range(3)]
    kw = dict(slots=2, cache_len=32, max_tokens=5)
    jreqs, jevents = _jax_engine_run(jm, params, prompts, greedy=False, **kw)
    treqs, tevents, _ = _port_engine_run(tm, prompts, greedy=False, **kw)
    assert all(r.done and len(r.output) == 5 for r in treqs)
    _assert_engines_agree(treqs, tevents, jreqs, jevents, tm.cfg.vocab)
    greedy, _, _ = _port_engine_run(tm, prompts, **kw)
    assert [r.output for r in greedy] == [r.output for r in treqs]


def test_engine_matches_direct_decode():
    """The port's twin of test_serving_matches_direct_decode (digital)."""
    cfg = dataclasses.replace(registry.get_config("yi-9b").reduced(), n_layers=2)
    tm = build_model(cfg, device="cpu")
    tm.init(torch.Generator().manual_seed(1))
    prompt = np.arange(7) % cfg.vocab
    eng = ServingEngine(tm, ServeConfig(slots=2, cache_len=32))
    (req,) = eng.run([Request(rid=0, prompt=prompt, max_tokens=5)])
    logits, cache = tm.prefill(torch.as_tensor(prompt)[None], 32)
    toks = [int(torch.argmax(logits[0, -1]))]
    for _ in range(4):
        logits, cache = tm.decode_step(cache, torch.tensor([[toks[-1]]]))
        toks.append(int(torch.argmax(logits[0, 0])))
    assert req.output == toks


@pytest.mark.parametrize("analog", [False, True])
def test_engine_drops_cache_writes_past_the_end_like_the_reference(analog, monkeypatch):
    """cache_len=8, 5-token prompts, 6 tokens: idle and finishing slots
    decode past the cache. JAX drops those writes; so must the port."""
    jm, params, tm = _pair("yi-9b", seed=8, n_layers=2, analog_mvm=analog)
    dac = DacReplay(monkeypatch) if analog else None
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tm.cfg.vocab, size=(5,)) for _ in range(3)]
    kw = dict(slots=2, cache_len=8, max_tokens=6)
    jreqs, jevents = _jax_engine_run(jm, params, prompts, **kw)
    treqs, tevents, eng = _port_engine_run(tm, prompts, **kw)
    assert int(eng.cache.length.max()) > 8
    _assert_engines_agree(treqs, tevents, jreqs, jevents, tm.cfg.vocab)
    if analog:
        dac.check_all_replayed()


def test_decode_write_past_the_cache_is_dropped():
    cfg = dataclasses.replace(registry.get_config("yi-9b").reduced(), n_layers=1)
    tm = build_model(cfg, device="cpu")
    tm.init(torch.Generator().manual_seed(2))
    _, cache = tm.prefill(torch.arange(4)[None].repeat(2, 1), 4)
    k_before = cache.k.clone()
    cache.length[1] = 3          # row 0 is full, row 1 has one free position
    tm.decode_step(cache, torch.tensor([[1], [2]]))
    assert torch.equal(cache.k[:, 0], k_before[:, 0])
    assert not torch.equal(cache.k[:, 1, 3], k_before[:, 1, 3])
    np.testing.assert_array_equal(cache.length.numpy(), [5, 4])


def test_serve_cli_on_cpu(capsys):
    serve_mod.main(["--arch", "yi-9b", "--reduced", "--analog", "--device", "cpu",
                    "--requests", "3", "--slots", "2", "--max-tokens", "4"])
    out = capsys.readouterr().out
    assert out.count("4 tokens done") == 3 and "tok/s" in out and "analog=on" in out


def test_serve_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.serve(serve_mod.config_for("yi-9b", reduced=True))


def test_load_refuses_a_mismatched_tree():
    jm, params, tm = _pair("yi-9b", n_layers=1)
    tree = jax.tree_util.tree_map(np.asarray, params)
    del tree["final_ln"]["scale"]
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_numpy(tm, tree)
