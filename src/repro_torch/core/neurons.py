"""Behavioural analog neuron models (Table I: "Neuron Circuit Model").

Behavioural transfer functions with the circuit-level artefacts that
matter for system accuracy/power:

  * a differential amplifier converting the differential column current
    into a voltage of `z_volt` volts per digital pre-activation unit,
  * rail clipping at [VSS, VDD] — pre-activations beyond ±VDD/z_volt
    saturate,
  * a per-neuron static power and settling-latency cost model.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class NeuronModel:
    """Behavioural neuron + differential-amp model.

    Attributes:
      kind: 'sigmoid' | 'tanh' | 'relu' | 'linear'.
      vdd / vss: supply rails (volts).
      amp_gain: differential amplifier voltage gain G_j.
      z_volt: volts per digital pre-activation unit at the amp output.
        The rails then clip |z| at vdd / z_volt (default 0.8/0.1 = 8).
      p_neuron: static power per neuron circuit (watts).
      p_amp: static power per differential amplifier (watts).
      t_settle: settling time per neuron stage (seconds).
    """

    kind: str = "sigmoid"
    vdd: float = 0.8
    vss: float = -0.8
    amp_gain: float = 10.0
    z_volt: float = 0.1
    p_neuron: float = 30e-6   # uW-scale, ref [3]
    p_amp: float = 50e-6
    t_settle: float = 1e-9

    @property
    def z_lim(self) -> float:
        """Largest |pre-activation| representable between the rails."""
        return self.vdd / self.z_volt

    def activation(self, z: torch.Tensor) -> torch.Tensor:
        if self.kind == "sigmoid":
            return torch.sigmoid(z)
        if self.kind == "tanh":
            return torch.tanh(z)
        if self.kind == "relu":
            return torch.clamp(z, min=0.0)
        if self.kind == "linear":
            return z
        raise ValueError(f"unknown neuron kind {self.kind!r}")

    def clip_preactivation(self, z: torch.Tensor) -> torch.Tensor:
        return torch.clamp(z, -self.z_lim, self.z_lim)

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        return self.activation(self.clip_preactivation(z))


SIGMOID = NeuronModel(kind="sigmoid")
TANH = NeuronModel(kind="tanh")
RELU = NeuronModel(kind="relu")
LINEAR = NeuronModel(kind="linear")

NEURONS = {"sigmoid": SIGMOID, "tanh": TANH, "relu": RELU, "linear": LINEAR}


def get_neuron(kind_or_model: "str | NeuronModel") -> NeuronModel:
    if isinstance(kind_or_model, NeuronModel):
        return kind_or_model
    try:
        return NEURONS[kind_or_model.lower()]
    except KeyError as e:
        raise KeyError(
            f"unknown neuron {kind_or_model!r}; known: {sorted(NEURONS)}"
        ) from e
