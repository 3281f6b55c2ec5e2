"""Interconnect parasitics from physical geometry (Table II of the paper).

Per-segment wire resistance/capacitance from the synapse bitcell pitch
and the interconnect's resistivity / thickness / width. The paper prints
rho = 1.9e9 ohm.m, an exponent typo: a copper-like back-end-of-line
interconnect is ~1.9e-8 ohm.m, which with the printed geometry gives
~13.8 ohm per bitcell segment. We use 1.9e-8.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Interconnect:
    """Wire parasitics for one metal layer of the crossbar.

    Attributes:
      resistivity: ohm·m.
      thickness: wire thickness (m).
      width: wire width (m).
      pitch: bitcell pitch = segment length between adjacent cells (m).
      cap_per_m: wire capacitance per meter (F/m), for latency estimates.
    """

    resistivity: float = 1.9e-8
    thickness: float = 22e-9
    width: float = 36e-9
    pitch: float = 576e-9  # 64 lambda at 14nm FinFET (Table II)
    cap_per_m: float = 2e-10  # ~0.2 fF/um, typical BEOL

    @property
    def r_segment(self) -> float:
        """Resistance of one bitcell-pitch wire segment (ohms)."""
        return self.resistivity * self.pitch / (self.width * self.thickness)

    @property
    def c_segment(self) -> float:
        """Capacitance of one bitcell-pitch wire segment (farads)."""
        return self.cap_per_m * self.pitch

    def line_resistance(self, n_segments: int) -> float:
        return self.r_segment * n_segments

    def elmore_delay(self, n_segments: int) -> float:
        """Elmore delay of a distributed RC line of n segments (seconds)."""
        r, c = self.r_segment, self.c_segment
        # sum_{k=1..n} (k * r) * c  = r c n(n+1)/2
        return 0.5 * r * c * n_segments * (n_segments + 1)


# Paper Table II defaults (14nm FinFET node).
DEFAULT_INTERCONNECT = Interconnect()


def scaled_interconnect(scale: float, base: Interconnect = DEFAULT_INTERCONNECT) -> Interconnect:
    """Scale wire cross-section (e.g. older/newer node); R ∝ 1/scale²."""
    return dataclasses.replace(
        base,
        thickness=base.thickness * scale,
        width=base.width * scale,
        pitch=base.pitch * scale,
    )
