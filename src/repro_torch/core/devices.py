"""Memristive device technologies for IMAC crossbars (Table I / IV).

A device is programmed to a conductance G ∈ [G_off, G_on] =
[1/R_high, 1/R_low]; real devices have a finite number of programmable
levels and device-to-device variation, both modelled here.

Random draws come from an explicit `torch.Generator` or as a tensor drawn
beforehand (the tests hand in the reference's own draws).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

#: A source of standard-normal draws: a generator on the target device,
#: or the draws themselves (a tensor of the target shape).
Draw = Union[torch.Generator, torch.Tensor]


def _normal(draw: Draw, like: torch.Tensor) -> torch.Tensor:
    if isinstance(draw, torch.Generator):
        return torch.randn(
            like.shape, generator=draw, dtype=like.dtype, device=like.device
        )
    noise = torch.as_tensor(draw, dtype=like.dtype, device=like.device)
    if noise.shape != like.shape:
        raise ValueError(f"pre-drawn noise {tuple(noise.shape)} != {tuple(like.shape)}")
    return noise


@dataclasses.dataclass(frozen=True)
class DeviceTech:
    """A memristive synaptic technology.

    Attributes:
      name: human-readable technology name.
      r_low: low (ON) resistance in ohms -> G_on = 1/r_low.
      r_high: high (OFF) resistance in ohms -> G_off = 1/r_high.
      levels: number of programmable conductance levels (0 = continuous).
      sigma_rel: relative lognormal programming variation (0 = none).
      read_noise_rel: relative Gaussian read-current noise per access.
    """

    name: str
    r_low: float
    r_high: float
    levels: int = 0
    sigma_rel: float = 0.0
    read_noise_rel: float = 0.0

    @property
    def g_on(self) -> float:
        return 1.0 / self.r_low

    @property
    def g_off(self) -> float:
        return 1.0 / self.r_high

    @property
    def g_range(self) -> float:
        return self.g_on - self.g_off

    @property
    def on_off_ratio(self) -> float:
        return self.r_high / self.r_low

    def quantize(self, g: torch.Tensor) -> torch.Tensor:
        """Snap conductances to the device's programmable levels.

        `torch.round` rounds half to even, as the reference's `jnp.round`.
        """
        g = torch.clamp(g, self.g_off, self.g_on)
        if self.levels and self.levels > 1:
            step = self.g_range / (self.levels - 1)
            g = self.g_off + torch.round((g - self.g_off) / step) * step
        return g

    def perturb(self, draw: Draw, g: torch.Tensor) -> torch.Tensor:
        """Apply lognormal device-to-device programming variation.

        `draw` is a generator on g's device or standard-normal draws of
        g's shape.
        """
        if self.sigma_rel <= 0.0:
            return g
        noise = _normal(draw, g)
        return torch.clamp(
            g * torch.exp(self.sigma_rel * noise), self.g_off, self.g_on
        )


def sample_stuck_faults(
    draw: Draw,
    shape: "tuple[int, ...]",
    p_stuck_on: float,
    p_stuck_off: float,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Draw disjoint stuck-at fault masks for one device array.

    Each device is stuck at G_on with probability `p_stuck_on`, stuck at
    G_off with probability `p_stuck_off`, and healthy otherwise (one
    uniform draw per device, so the masks are disjoint by construction).
    `draw` is a generator (the masks land on its device) or uniform
    [0, 1) draws of `shape`.

    Returns:
      (stuck_on, stuck_off) boolean masks of the given shape.
    """
    if not (0.0 <= p_stuck_on <= 1.0 and 0.0 <= p_stuck_off <= 1.0):
        raise ValueError(
            f"fault rates must be probabilities, got {p_stuck_on}, {p_stuck_off}"
        )
    if p_stuck_on + p_stuck_off > 1.0:
        raise ValueError(
            f"p_stuck_on + p_stuck_off must be <= 1, got "
            f"{p_stuck_on} + {p_stuck_off}"
        )
    if isinstance(draw, torch.Generator):
        u = torch.rand(shape, generator=draw, device=draw.device)
    else:
        u = torch.as_tensor(draw)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"pre-drawn uniforms {tuple(u.shape)} != {tuple(shape)}")
    stuck_on = u < p_stuck_on
    stuck_off = (u >= p_stuck_on) & (u < p_stuck_on + p_stuck_off)
    return stuck_on, stuck_off


def apply_stuck_faults(
    g: torch.Tensor,
    stuck_on: torch.Tensor,
    stuck_off: torch.Tensor,
    g_on: float,
    g_off: float,
) -> torch.Tensor:
    """Clamp faulty devices to their stuck conductance level."""
    on = torch.full_like(g, g_on)
    off = torch.full_like(g, g_off)
    return torch.where(stuck_on, on, torch.where(stuck_off, off, g))


# Table IV of the paper -----------------------------------------------------
MRAM = DeviceTech("MRAM", r_low=8.5e3, r_high=25.5e3)    # ref [4]
RRAM = DeviceTech("RRAM", r_low=2.5e3, r_high=100e3)     # ref [5]
CBRAM = DeviceTech("CBRAM", r_low=5e3, r_high=1e6)       # ref [6]
PCM = DeviceTech("PCM", r_low=50e3, r_high=1e6)          # ref [7]

TECHNOLOGIES: dict[str, DeviceTech] = {
    t.name: t for t in (MRAM, RRAM, CBRAM, PCM)
}


def get_tech(name_or_tech: "str | DeviceTech") -> DeviceTech:
    if isinstance(name_or_tech, DeviceTech):
        return name_or_tech
    try:
        return TECHNOLOGIES[name_or_tech.upper()]
    except KeyError as e:
        raise KeyError(
            f"unknown device technology {name_or_tech!r}; "
            f"known: {sorted(TECHNOLOGIES)}"
        ) from e


def custom_tech(
    r_low: float,
    r_high: float,
    name: str = "custom",
    levels: int = 0,
    sigma_rel: float = 0.0,
    read_noise_rel: float = 0.0,
) -> DeviceTech:
    if not (0.0 < r_low < r_high):
        raise ValueError(f"need 0 < r_low < r_high, got {r_low}, {r_high}")
    return DeviceTech(name, r_low, r_high, levels, sigma_rel, read_noise_rel)
