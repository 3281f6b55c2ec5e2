"""testIMAC — Module 1 / Algorithm 1: deploy a trained DNN on an IMAC
configuration and report error rate, average power and latency.

The paper runs SPICE once per test sample; here each chunk of the test
set is one batched circuit solve per layer. `evaluate_batch` evaluates a
batch of structurally-compatible configurations in one solve by stacking
their conductances and electrical scalars along a leading axis;
`test_imac` is its single-configuration form.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.digital import Params, mlp_forward
from repro_torch.core.imac import IMACConfig, build_plans, layer_latency, linear_forward
from repro_torch.core.mapping import MappedLayer, map_network
from repro_torch.core.solver import CircuitParams, SolveOptions, suggest_iters
from repro_torch.device import resolve_device


class IMACResult(NamedTuple):
    accuracy: float
    error_rate: float
    avg_power: float          # W, averaged over samples (paper's P_average)
    latency: float            # s, analytic settling + sampling
    digital_accuracy: float   # reference accuracy of the float model
    per_layer_power: tuple    # W per layer (batch mean)
    worst_residual: float     # solver convergence check
    n_samples: int
    hp: tuple
    vp: tuple
    energy: float = 0.0       # J per inference: avg_power x latency
    # Gauss–Seidel sweeps per layer (the most any chunk ran).
    sweeps: tuple = ()
    # (n_samples, fan_out) final-layer outputs, on the CPU.
    outputs: Optional[torch.Tensor] = None


def structure_key(topology: Sequence[int], cfg: IMACConfig) -> tuple:
    """Hashable key of everything that shapes the computation.

    Configurations with equal keys differ only in numeric leaves
    (conductances, wire/periphery resistances, SOR factor, read noise)
    and can share one stacked solve.
    """
    plans = build_plans(topology, cfg)
    iters = tuple(cfg.gs_iters or suggest_iters(p.rows, p.cols) for p in plans)
    return (
        tuple(topology),
        tuple((p.hp, p.vp, p.rows, p.cols) for p in plans),
        bool(cfg.parasitics),
        iters,
        float(cfg.gs_tol),
        cfg.resolved_neuron(),
        str(cfg.dtype),
    )


def lift_mapped(mapped: "Sequence[MappedLayer]") -> "list[MappedLayer]":
    """One configuration's mapping as a leading-axis-1 stacked mapping
    (the `mapped_stacked` form of `evaluate_batch`)."""
    return [
        dataclasses.replace(
            m,
            g_pos=m.g_pos[None],
            g_neg=m.g_neg[None],
            k=torch.as_tensor([m.k], device=m.g_pos.device),
        )
        for m in mapped
    ]


def concat_mapped(stacks: "Sequence[Sequence[MappedLayer]]") -> "list[MappedLayer]":
    """Concatenate stacked mappings along the leading config axis."""
    stacks = list(stacks)
    if len(stacks) == 1:
        return list(stacks[0])
    return [
        dataclasses.replace(
            stacks[0][layer],
            g_pos=torch.cat([s[layer].g_pos for s in stacks]),
            g_neg=torch.cat([s[layer].g_neg for s in stacks]),
            k=torch.cat([
                torch.atleast_1d(torch.as_tensor(s[layer].k, device=s[layer].g_pos.device))
                for s in stacks
            ]),
        )
        for layer in range(len(stacks[0]))
    ]


def stack_mapped(
    mapped_all: "Sequence[Sequence[MappedLayer]]", dtype
) -> "tuple[tuple, tuple, tuple]":
    """Stack per-config mapWB outputs along a leading config axis.

    Returns per-layer tuples (g_pos, g_neg, k): (C, fan_in+1, fan_out)
    conductances and (C,) sense scales.
    """
    n_layers = len(mapped_all[0])
    g_pos = tuple(torch.stack([m[i].g_pos for m in mapped_all]) for i in range(n_layers))
    g_neg = tuple(torch.stack([m[i].g_neg for m in mapped_all]) for i in range(n_layers))
    k = tuple(
        torch.tensor([float(m[i].k) for m in mapped_all], dtype=dtype,
                     device=mapped_all[0][i].g_pos.device)
        for i in range(n_layers)
    )
    return g_pos, g_neg, k


def _on(t, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(t).to(device=device, dtype=dtype)


def evaluate_batch(
    params: Params,
    x: torch.Tensor,
    y: torch.Tensor,
    cfgs: "Sequence[IMACConfig]",
    *,
    n_samples: Optional[int] = None,
    chunk: int = 256,
    variation: Optional[torch.Generator] = None,
    noise: Optional[torch.Generator] = None,
    noise_per_config: bool = False,
    activation: str = "sigmoid",
    mapped: Optional[list] = None,
    mapped_stacked: Optional[list] = None,
    solve_options: Optional[SolveOptions] = None,
    device: "str | torch.device | None" = None,
) -> "list[IMACResult]":
    """Evaluate many structurally-compatible IMAC configurations at once.

    All configurations must share a `structure_key`; their conductances
    and electrical scalars are stacked along a leading axis and each
    layer of each sample chunk is ONE circuit solve.

    Args:
      params: trained digital weights/biases [(W, b), ...].
      x: (N, fan_in) inputs in [0, 1] digital units.
      y: (N,) integer labels.
      cfgs: structurally-compatible configurations.
      n_samples: N_S — number of test samples (default: all).
      chunk: samples per circuit solve.
      variation: generator (on `device`) for device-variation draws;
        every configuration gets the same draws (a paired sweep).
      noise: generator (on `device`) for read-noise draws, made per chunk
        and layer; shared across configurations unless `noise_per_config`.
      noise_per_config: draw read noise per stacked configuration.
      activation: digital reference activation.
      mapped: optional pre-computed mapWB output per configuration.
      mapped_stacked: optional pre-stacked mapping: one MappedLayer per
        layer with (C, ...) conductances and a (C,) k. Exclusive with
        `mapped`.
      solve_options: circuit-solver backend (None = "tridiag").
      device: where to run (None = the GPU).

    Returns:
      One IMACResult per configuration, in input order.

    Raises:
      ValueError: if the configurations are not structurally compatible.
    """
    cfgs = list(cfgs)
    if not cfgs:
        return []
    dev = resolve_device(device)
    params = [(_on(w, dev, torch.float32), _on(b, dev, torch.float32)) for w, b in params]
    topology = [params[0][0].shape[0]] + [w.shape[1] for w, _ in params]
    key0 = structure_key(topology, cfgs[0])
    for c in cfgs[1:]:
        if structure_key(topology, c) != key0:
            raise ValueError(
                "evaluate_batch needs structurally-compatible configs "
                "(equal structure_key)"
            )

    cfg0 = cfgs[0]
    plans = build_plans(topology, cfg0)
    neuron = cfg0.resolved_neuron()
    dtype = cfg0.dtype
    v_unit = cfg0.vdd
    iters = [cfg0.gs_iters or suggest_iters(p.rows, p.cols) for p in plans]
    n_layers = len(plans)

    n = n_samples or x.shape[0]
    x = _on(x, dev, torch.float32)[:n]
    y = _on(y, dev, torch.long)[:n]

    if mapped_stacked is not None:
        if mapped is not None:
            raise ValueError("pass either mapped or mapped_stacked, not both")
        for m in mapped_stacked:
            if m.g_pos.shape[0] != len(cfgs):
                raise ValueError(
                    f"mapped_stacked leading axis {m.g_pos.shape[0]} != "
                    f"{len(cfgs)} configurations"
                )
        g_pos = tuple(_on(m.g_pos, dev) for m in mapped_stacked)
        g_neg = tuple(_on(m.g_neg, dev) for m in mapped_stacked)
        k = tuple(_on(m.k, dev, dtype) for m in mapped_stacked)
    else:
        if mapped is None:
            # Every configuration gets the same variation draws (a paired
            # sweep): the generator restarts from one state for each.
            state = variation.get_state() if variation is not None else None
            mapped = []
            for c in cfgs:
                if variation is not None:
                    variation.set_state(state)
                mapped.append(map_network(
                    params,
                    c.resolved_tech(),
                    v_unit=c.vdd,
                    quantize=c.quantize,
                    variation=variation,
                ))
        mapped_all = mapped
        mapped_all = [
            [dataclasses.replace(m, g_pos=_on(m.g_pos, dev), g_neg=_on(m.g_neg, dev))
             for m in layers]
            for layers in mapped_all
        ]
        g_pos, g_neg, k = stack_mapped(mapped_all, dtype)

    def per_config(values):
        return torch.tensor(values, dtype=dtype, device=dev)

    r_seg = per_config([c.interconnect.r_segment for c in cfgs])
    r_source = per_config([c.r_source for c in cfgs])
    r_tia = per_config([c.r_tia for c in cfgs])
    omega = per_config([c.sor_omega for c in cfgs])
    read_noise = per_config([c.resolved_tech().read_noise_rel for c in cfgs])
    layer_cp = [
        CircuitParams(
            r_row=r_seg, r_col=r_seg, r_source=r_source, r_tia=r_tia,
            gs_iters=iters[layer], omega=omega, tol=cfg0.gs_tol,
        )
        for layer in range(n_layers)
    ]

    preds, outputs, powers, residuals = [], [], [], []
    layer_sweeps = [0] * n_layers
    for start in range(0, n, chunk):
        a = x[start : start + chunk]  # (B, F); (C, B, F) after the first layer
        chunk_powers, chunk_res = [], []
        for layer, plan in enumerate(plans):
            a, power, residual, _, swp = linear_forward(
                g_pos[layer],
                g_neg[layer],
                k[layer],
                v_unit,
                plan,
                layer_cp[layer],
                neuron,
                a,
                parasitics=cfg0.parasitics,
                is_output=(layer == n_layers - 1),
                solve_options=solve_options,
                noise=noise,
                read_noise_rel=read_noise,
                noise_per_config=noise_per_config,
                dtype=dtype,
            )
            chunk_powers.append(torch.mean(power, dim=-1))   # (C,)
            chunk_res.append(residual)                       # (C,)
            layer_sweeps[layer] = max(layer_sweeps[layer], swp)
        batch = a.shape[-2]
        preds.append(torch.argmax(a, dim=-1))                # (C, B)
        outputs.append(a)                                    # (C, B, n_out)
        powers.append(torch.stack(chunk_powers, dim=-1) * batch)
        residuals.append(torch.stack(chunk_res, dim=-1))
    pred = torch.cat(preds, dim=1)                               # (C, n)
    out_all = torch.cat(outputs, dim=1).cpu()                    # (C, n, n_out)
    per_layer_power = (torch.sum(torch.stack(powers), dim=0) / n).cpu()  # (C, L)
    worst_res = torch.amax(torch.stack(residuals), dim=0).cpu()  # (C, L)
    errors_all = torch.sum(pred != y, dim=-1).cpu()              # (C,)

    dig_pred = torch.argmax(mlp_forward(params, x, activation), dim=-1)
    dig_acc = float(torch.mean((dig_pred == y).to(torch.float32)))

    results = []
    for i, cfg in enumerate(cfgs):
        errors = int(errors_all[i])
        latency = float(
            sum(
                torch.tensor(
                    layer_latency(p, cfg.interconnect, cfg.resolved_neuron()), dtype=dtype
                )
                for p in plans
            )
            + cfg.t_sampling
        )
        plp = per_layer_power[i]
        avg_power = float(torch.sum(plp))
        results.append(
            IMACResult(
                accuracy=1.0 - errors / n,
                error_rate=errors / n,
                avg_power=avg_power,
                latency=latency,
                digital_accuracy=dig_acc,
                per_layer_power=tuple(float(p) for p in plp),
                worst_residual=float(torch.max(worst_res[i])),
                n_samples=n,
                hp=tuple(p.hp for p in plans),
                vp=tuple(p.vp for p in plans),
                energy=avg_power * latency,
                sweeps=tuple(layer_sweeps),
                outputs=out_all[i],
            )
        )
    return results


def test_imac(
    params: Params,
    x: torch.Tensor,
    y: torch.Tensor,
    cfg: IMACConfig,
    *,
    n_samples: Optional[int] = None,
    chunk: int = 256,
    variation: Optional[torch.Generator] = None,
    noise: Optional[torch.Generator] = None,
    activation: str = "sigmoid",
    solve_options: Optional[SolveOptions] = None,
    device: "str | torch.device | None" = None,
) -> IMACResult:
    """Evaluate the IMAC deployment of `params` on (x, y).

    Thin wrapper over `evaluate_batch` with a single-configuration batch.

    Args:
      params: trained digital weights/biases [(W, b), ...].
      x: (N, fan_in) inputs in [0, 1] digital units.
      y: (N,) integer labels.
      cfg: IMAC hyperparameters (Table I).
      n_samples: N_S — number of test samples (default: all).
      chunk: samples per circuit solve.
      variation: optional device-variation generator.
      noise: optional read-noise generator.
      solve_options: circuit-solver backend (None = "tridiag").
      device: where to run (None = the GPU).

    Returns:
      IMACResult with accuracy/power/latency (Algorithm 1 lines 21-22).
    """
    return evaluate_batch(
        params,
        x,
        y,
        [cfg],
        n_samples=n_samples,
        chunk=chunk,
        variation=variation,
        noise=noise,
        activation=activation,
        solve_options=solve_options,
        device=device,
    )[0]


test_imac.__test__ = False  # a library entry point, not a pytest test


def sweep(
    params: Params,
    x: torch.Tensor,
    y: torch.Tensor,
    cfgs: "Sequence[tuple[str, IMACConfig]]",
    **kw,
) -> "list[tuple[str, IMACResult]]":
    """Design-space sweep, one configuration at a time (the paper's
    Tables III/IV are sweeps over partitioning / device technology)."""
    return [(name, test_imac(params, x, y, cfg, **kw)) for name, cfg in cfgs]
