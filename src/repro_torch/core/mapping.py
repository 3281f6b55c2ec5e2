"""mapWB — Module 2 of IMAC-Sim (Algorithm 1, line 2).

Maps trained weights/biases to differential conductance pairs
(W+, W-, B+, B-) for a given synaptic technology [R_low, R_high]:

  w >= 0:  G+ = G_off + (w / w_scale) * (G_on - G_off),   G- = G_off
  w <  0:  G- = G_off + (|w|/ w_scale) * (G_on - G_off),  G+ = G_off

so (G+ - G-) = w * k with k = (G_on - G_off) / w_scale, and the digital
pre-activation is recovered as z = (I+ - I-) / (k * v_unit) with inputs
encoded as V = a * v_unit. `w_scale` is the per-layer max |w| (biases
included).

Programming variation comes from a `torch.Generator` or from normal
draws made beforehand, one pair (G+, G-) per layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from repro_torch.core.devices import DeviceTech, Draw

#: Variation for one layer: a generator, or the (G+, G-) normal draws.
LayerVariation = Union[torch.Generator, "tuple[torch.Tensor, torch.Tensor]"]


@dataclasses.dataclass
class MappedLayer:
    """Differential conductances for one layer (bias folded as extra row).

    g_pos/g_neg have shape (fan_in + 1, fan_out) — or (C, fan_in + 1,
    fan_out) in the stacked form, with `k` then a (C,) tensor; row -1 is
    the bias row, driven at `v_unit` volts.
    """

    g_pos: torch.Tensor
    g_neg: torch.Tensor
    w_scale: float        # max |w| used for normalisation
    k: "float | torch.Tensor"  # (G_on - G_off) / w_scale  [S per unit weight]
    sense_r: float        # ohms; z = I_diff * sense_r / v_unit
    v_unit: float         # volts encoding one unit of activation

    @property
    def fan_in(self) -> int:
        return self.g_pos.shape[-2] - 1

    @property
    def fan_out(self) -> int:
        return self.g_pos.shape[-1]

    @property
    def g_diff(self) -> torch.Tensor:
        return self.g_pos - self.g_neg

    def effective_weights(self) -> torch.Tensor:
        """Recover the (quantised) weight matrix implied by conductances."""
        return self.g_diff / self.k


def _split_variation(variation: LayerVariation) -> "tuple[Draw, Draw]":
    if isinstance(variation, torch.Generator):
        return variation, variation
    noise_pos, noise_neg = variation
    return noise_pos, noise_neg


def map_wb(
    weights: torch.Tensor,
    biases: torch.Tensor,
    tech: DeviceTech,
    v_unit: float,
    *,
    quantize: bool = True,
    variation: Optional[LayerVariation] = None,
    w_scale: Optional[float] = None,
) -> MappedLayer:
    """Map one layer's (fan_in, fan_out) weights + (fan_out,) biases.

    Args:
      weights: (fan_in, fan_out) float weights.
      biases: (fan_out,) float biases.
      tech: synaptic technology defining [G_off, G_on].
      v_unit: input-voltage encoding of one unit of activation (volts).
      quantize: snap to the device's programmable levels.
      variation: lognormal programming variation — a generator on the
        weights' device (G+ drawn first, then G-), or the pair of
        standard-normal draws (noise_pos, noise_neg) of shape
        (fan_in + 1, fan_out). None = no variation.
      w_scale: optional fixed normalisation (default: per-layer max |w|).

    Returns:
      MappedLayer with bias folded in as the last row.
    """
    if weights.ndim != 2 or biases.ndim != 1 or biases.shape[0] != weights.shape[1]:
        raise ValueError(
            f"bad shapes: weights {tuple(weights.shape)}, biases {tuple(biases.shape)}"
        )
    wb = torch.cat([weights, biases[None, :]], dim=0)
    if w_scale is None:
        w_scale = float(torch.max(torch.abs(wb)))
    if w_scale <= 0.0:
        w_scale = 1.0
    wn = wb / w_scale  # in [-1, 1]

    g_pos = tech.g_off + torch.clamp(wn, min=0.0) * tech.g_range
    g_neg = tech.g_off + torch.clamp(-wn, min=0.0) * tech.g_range
    if quantize:
        g_pos = tech.quantize(g_pos)
        g_neg = tech.quantize(g_neg)
    if variation is not None:
        draw_pos, draw_neg = _split_variation(variation)
        g_pos = tech.perturb(draw_pos, g_pos)
        g_neg = tech.perturb(draw_neg, g_neg)

    k = tech.g_range / w_scale
    # With V_i = a_i * v_unit:  I_diff = k * v_unit * z  =>  z = I_diff/(k v_unit)
    return MappedLayer(
        g_pos=g_pos,
        g_neg=g_neg,
        w_scale=w_scale,
        k=k,
        sense_r=1.0 / k,
        v_unit=v_unit,
    )


def map_network(
    params: "Sequence[tuple[torch.Tensor, torch.Tensor]]",
    tech: DeviceTech,
    v_unit: float,
    *,
    quantize: bool = True,
    variation: "torch.Generator | Sequence[tuple[torch.Tensor, torch.Tensor]] | None" = None,
) -> "list[MappedLayer]":
    """mapWB over a whole T_N = [L_1 .. L_n] topology.

    `variation` is one generator shared by all layers (drawn in layer
    order) or a per-layer list of (noise_pos, noise_neg) draws.
    """
    if variation is None or isinstance(variation, torch.Generator):
        per_layer = [variation] * len(params)
    else:
        per_layer = list(variation)
        if len(per_layer) != len(params):
            raise ValueError(
                f"{len(per_layer)} variation draws for {len(params)} layers"
            )
    return [
        map_wb(w, b, tech, v_unit, quantize=quantize, variation=var)
        for (w, b), var in zip(params, per_layer)
    ]
