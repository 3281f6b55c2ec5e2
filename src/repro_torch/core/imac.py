"""Composable IMAC circuit modules: `imac_linear` / `IMACNetwork`.

Each DNN layer becomes a set of partitioned crossbar tiles (differential
G+/G- arrays), solved with the batched circuit solver, followed by the
behavioural differential amp + neuron. Power and latency come from the
solved node voltages per Algorithm 1.

  * parasitics=True  — full circuit solve (the paper's simulation).
  * parasitics=False — ideal analog MVM (quantisation/variation/noise only).

Read noise comes from a `torch.Generator` on the layer's device or as
standard-normal draws made beforehand.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import torch
from torch import nn

from repro_torch.core.devices import DeviceTech, get_tech
from repro_torch.core.interconnect import DEFAULT_INTERCONNECT, Interconnect
from repro_torch.core.mapping import MappedLayer, map_network
from repro_torch.core.neurons import NeuronModel, get_neuron
from repro_torch.core.partition import (
    PartitionPlan,
    auto_partition,
    combine_outputs,
    plan_partition,
    tile_inputs,
    tile_matrix,
)
from repro_torch.core.solver import (
    CircuitParams,
    SolveOptions,
    _align as _align_leading,
    crossbar_power,
    solve_crossbar,
    suggest_iters,
)
from repro_torch.device import resolve_device

#: Read noise: a generator, or the standard-normal draws themselves.
Noise = Union[torch.Generator, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class IMACConfig:
    """User-facing hyperparameters (paper Table I)."""

    tech: DeviceTech | str = "MRAM"
    neuron: NeuronModel | str = "sigmoid"
    interconnect: Interconnect = DEFAULT_INTERCONNECT
    array_rows: int = 32
    array_cols: int = 32
    hp: Optional[Sequence[int]] = None   # horizontal partitions per layer
    vp: Optional[Sequence[int]] = None   # vertical partitions per layer
    vdd: float = 0.8
    vss: float = -0.8
    r_source: float = 100.0
    r_tia: float = 10.0
    parasitics: bool = True
    quantize: bool = True
    gs_iters: Optional[int] = None       # None = suggest from tile size
    sor_omega: float = 1.8
    gs_tol: float = 1e-6                 # early-exit sweep tolerance (V)
    t_sampling: float = 20e-9            # Table II: 20ns
    dtype: torch.dtype = torch.float32

    def resolved_tech(self) -> DeviceTech:
        return get_tech(self.tech)

    def resolved_neuron(self) -> NeuronModel:
        n = get_neuron(self.neuron)
        if n.vdd != self.vdd or n.vss != self.vss:
            n = dataclasses.replace(n, vdd=self.vdd, vss=self.vss)
        return n

    def circuit_params(self, rows: int, cols: int) -> CircuitParams:
        iters = self.gs_iters or suggest_iters(rows, cols)
        return CircuitParams(
            r_row=self.interconnect.r_segment,
            r_col=self.interconnect.r_segment,
            r_source=self.r_source,
            r_tia=self.r_tia,
            gs_iters=iters,
            omega=self.sor_omega,
            tol=self.gs_tol,
        )


class LayerStats(NamedTuple):
    power: torch.Tensor     # (batch,) total layer power (W)
    latency: torch.Tensor   # scalar, settling latency estimate (s)
    residual: torch.Tensor  # worst GS residual across tiles
    z: torch.Tensor         # (batch, fan_out) recovered pre-activations
    sweeps: int = 0         # GS sweeps the layer's solve actually ran


class IMACLayerOutput(NamedTuple):
    activations: torch.Tensor
    stats: LayerStats


def build_plans(topology: Sequence[int], cfg: IMACConfig) -> "list[PartitionPlan]":
    n_layers = len(topology) - 1
    hp, vp = cfg.hp, cfg.vp
    if hp is None or vp is None:
        pairs = [
            auto_partition(topology[i], topology[i + 1], cfg.array_rows, cfg.array_cols)
            for i in range(n_layers)
        ]
        hp = [p[0] for p in pairs]
        vp = [p[1] for p in pairs]
    return [
        plan_partition(topology[i], topology[i + 1], hp[i], vp[i])
        for i in range(n_layers)
    ]


def _read_noise(noise: Noise, shape, like: torch.Tensor) -> torch.Tensor:
    if isinstance(noise, torch.Generator):
        return torch.randn(shape, generator=noise, dtype=like.dtype, device=like.device)
    draw = torch.as_tensor(noise, dtype=like.dtype, device=like.device)
    if tuple(draw.shape) != tuple(shape):
        raise ValueError(f"pre-drawn read noise {tuple(draw.shape)} != {tuple(shape)}")
    return draw


def linear_forward(
    g_pos: torch.Tensor,
    g_neg: torch.Tensor,
    k: "torch.Tensor | float",
    v_unit: float,
    plan: PartitionPlan,
    cp: CircuitParams,
    neuron: NeuronModel,
    a: torch.Tensor,
    *,
    parasitics: bool = True,
    is_output: bool = False,
    solve_options: Optional[SolveOptions] = None,
    noise: Optional[Noise] = None,
    read_noise_rel: "torch.Tensor | float" = 0.0,
    noise_per_config: bool = False,
    dtype: torch.dtype = torch.float32,
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]":
    """Functional core of one analog layer: crossbar solve + diff amp + neuron.

    Supports stacked-configuration batches: g_pos/g_neg may be (C,
    fan_in+1, fan_out) with `k`, the electrical fields of `cp` and
    `read_noise_rel` as (C,) tensors; the whole configuration batch then
    shares ONE circuit solve. With 2-D conductances and float scalars
    this is the single-configuration layer.

    `noise` (a generator or standard-normal draws) adds read noise to the
    differential currents. `noise_per_config` False shares one draw of
    shape (batch, fan_out) across the leading config axes; True draws the
    full (..., batch, fan_out) shape.

    Returns:
      (activations, power, residual, z, sweeps) — power is (..., batch),
      residual (...,), z the recovered pre-activations, sweeps the GS
      trip count of the layer's circuit solve (0 without parasitics).
    """
    device = g_pos.device
    a = a.to(device=device, dtype=dtype)
    # Bias input: driven at v_unit (logical activation 1).
    ones = torch.ones(a.shape[:-1] + (1,), dtype=dtype, device=device)
    v = torch.cat([a, ones], dim=-1) * v_unit

    sweeps = 0
    if not parasitics:
        g_diff = (g_pos - g_neg).to(dtype)
        i_diff = torch.einsum("...mn,...bm->...bn", g_diff, v)
        p_dev = torch.einsum("...mn,...bm->...b", (g_pos + g_neg).to(dtype), v**2)
        residual = torch.zeros(g_pos.shape[:-2], dtype=dtype, device=device)
    else:
        tiles_p = tile_matrix(g_pos.to(dtype), plan)
        tiles_n = tile_matrix(g_neg.to(dtype), plan)
        g_all = torch.cat([tiles_p, tiles_n], dim=-3)          # (..., 2T, M, N)
        v_tiles = tile_inputs(v, plan)                          # (..., batch, hp, M)
        # tile t = h*vp + vcol shares the h-th input slice.
        v_per_tile = torch.repeat_interleave(v_tiles, plan.vp, dim=-2)
        v_all = torch.cat([v_per_tile, v_per_tile], dim=-2)     # (..., b, 2T, M)
        # Insert the sample axis into g: (..., 1, 2T, M, N) vs (..., b, 2T, M).
        g_b = g_all[..., None, :, :, :]
        sol = solve_crossbar(g_b, v_all, cp, options=solve_options)
        t = plan.n_tiles
        i_pos = combine_outputs(sol.i_out[..., :t, :], plan)
        i_neg = combine_outputs(sol.i_out[..., t:, :], plan)
        i_diff = i_pos - i_neg
        p_dev = crossbar_power(g_b, v_all, sol, cp).sum(dim=-1)
        residual = torch.amax(sol.residual, dim=(-1, -2))
        sweeps = int(sol.sweeps)

    if noise is not None:
        shape = i_diff.shape if noise_per_config else i_diff.shape[-2:]
        draw = _read_noise(noise, shape, i_diff)
        rel = _align_leading(read_noise_rel, i_diff.ndim, dtype, device)
        scale = rel * torch.clamp(torch.abs(i_diff), min=1e-12)
        i_diff = i_diff + scale * draw

    # Differential sense: recover the digital pre-activation.
    z = i_diff / (_align_leading(k, i_diff.ndim, dtype, device) * v_unit)
    z = neuron.clip_preactivation(z)
    act = z if is_output else neuron.activation(z)

    # Interface power: one TIA+amp per tile column, one neuron per output.
    n_amps = plan.hp * plan.vp * plan.cols * 2  # differential pair sensing
    n_neurons = plan.total_cols
    p_iface = n_amps * neuron.p_amp + n_neurons * neuron.p_neuron
    power = p_dev + p_iface
    return act, power, residual, z, sweeps


def layer_latency(plan: PartitionPlan, interconnect: Interconnect, neuron) -> float:
    """Structural settling latency of one layer (input-independent).

    Elmore delay of the row+column lines (1% settling ~ 4.6 tau) + neuron.
    """
    t_line = 4.6 * (
        interconnect.elmore_delay(plan.cols) + interconnect.elmore_delay(plan.rows)
    )
    return t_line + neuron.t_settle


def imac_linear(
    mapped: MappedLayer,
    plan: PartitionPlan,
    a: torch.Tensor,
    cfg: IMACConfig,
    *,
    is_output: bool = False,
    solve_options: Optional[SolveOptions] = None,
    noise: Optional[Noise] = None,
) -> IMACLayerOutput:
    """One analog layer: crossbar solve + diff amp + neuron.

    Args:
      mapped: differential conductances (bias row folded).
      plan: tiling over (hp, vp) partitions.
      a: (batch, fan_in) activations in digital units.
      cfg: circuit hyperparameters.
      is_output: last layer — linear readout (no neuron nonlinearity).
      solve_options: solver backend selection (None = "tridiag").
      noise: read noise source (used when the technology has read noise).

    Returns:
      activations (batch, fan_out) and per-layer circuit stats.
    """
    tech = cfg.resolved_tech()
    neuron = cfg.resolved_neuron()
    if tech.read_noise_rel <= 0.0:
        noise = None
    act, power, residual, z, sweeps = linear_forward(
        mapped.g_pos,
        mapped.g_neg,
        mapped.k,
        mapped.v_unit,
        plan,
        cfg.circuit_params(plan.rows, plan.cols),
        neuron,
        a,
        parasitics=cfg.parasitics,
        is_output=is_output,
        solve_options=solve_options,
        noise=noise,
        read_noise_rel=tech.read_noise_rel,
        dtype=cfg.dtype,
    )
    latency = torch.tensor(
        layer_latency(plan, cfg.interconnect, neuron), dtype=cfg.dtype
    )
    return IMACLayerOutput(
        activations=act,
        stats=LayerStats(
            power=power, latency=latency, residual=residual, z=z, sweeps=sweeps
        ),
    )


class IMACNetwork(nn.Module):
    """The full mapped network (mapIMAC): layers + plans + forward.

    Construction performs mapWB (Module 2) and partition planning; calling
    the module simulates the concatenated circuit (Algorithm 1's SPICE
    run), returning outputs and per-layer stats. The conductances are
    buffers, so `.to()` moves them.
    """

    def __init__(
        self,
        params: "Sequence[tuple[torch.Tensor, torch.Tensor]]",
        cfg: IMACConfig,
        *,
        variation=None,
        device: "str | torch.device | None" = None,
    ):
        """
        Args:
          params: trained [(W, b), ...], W (fan_in, fan_out).
          cfg: IMAC hyperparameters.
          variation: programming variation for `map_network` (a generator
            on `device` or per-layer draws).
          device: where the network lives (None = the GPU).
        """
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        params = [
            (torch.as_tensor(w, dtype=torch.float32, device=dev),
             torch.as_tensor(b, dtype=torch.float32, device=dev))
            for w, b in params
        ]
        self.topology = [params[0][0].shape[0]] + [w.shape[1] for w, _ in params]
        mapped = map_network(
            params,
            cfg.resolved_tech(),
            v_unit=cfg.vdd,
            quantize=cfg.quantize,
            variation=variation,
        )
        self._meta = [(m.w_scale, m.k, m.sense_r, m.v_unit) for m in mapped]
        for i, m in enumerate(mapped):
            self.register_buffer(f"g_pos_{i}", m.g_pos)
            self.register_buffer(f"g_neg_{i}", m.g_neg)
        self.plans = build_plans(self.topology, cfg)

    @property
    def mapped(self) -> "list[MappedLayer]":
        return [
            MappedLayer(
                g_pos=getattr(self, f"g_pos_{i}"),
                g_neg=getattr(self, f"g_neg_{i}"),
                w_scale=w_scale,
                k=k,
                sense_r=sense_r,
                v_unit=v_unit,
            )
            for i, (w_scale, k, sense_r, v_unit) in enumerate(self._meta)
        ]

    @property
    def hp(self) -> "list[int]":
        return [p.hp for p in self.plans]

    @property
    def vp(self) -> "list[int]":
        return [p.vp for p in self.plans]

    def forward(
        self,
        x: torch.Tensor,
        *,
        solve_options: Optional[SolveOptions] = None,
        noise: "Noise | Sequence[torch.Tensor] | None" = None,
    ) -> "tuple[torch.Tensor, list[LayerStats]]":
        """Simulate the full IMAC circuit for a batch of inputs.

        Args:
          x: (batch, n_inputs) in digital activation units.
          solve_options: solver backend selection.
          noise: read noise — a generator shared by all layers (drawn in
            layer order) or one pre-drawn tensor per layer.

        Returns:
          (batch, n_outputs) final pre-activations (linear readout) and
          per-layer stats.
        """
        mapped = self.mapped
        n = len(mapped)
        if noise is None or isinstance(noise, torch.Generator):
            per_layer = [noise] * n
        else:
            per_layer = list(noise)
        a = x
        stats: list[LayerStats] = []
        for idx, (layer, plan) in enumerate(zip(mapped, self.plans)):
            out = imac_linear(
                layer,
                plan,
                a,
                self.cfg,
                is_output=(idx == n - 1),
                solve_options=solve_options,
                noise=per_layer[idx],
            )
            a = out.activations
            stats.append(out.stats)
        return a, stats

    def total_power(self, stats: "list[LayerStats]") -> torch.Tensor:
        """Mean-over-batch total circuit power (W)."""
        return sum(torch.mean(s.power) for s in stats)

    def total_latency(self, stats: "list[LayerStats]") -> torch.Tensor:
        """End-to-end settling latency + sampling time (s)."""
        return sum(s.latency for s in stats) + self.cfg.t_sampling
