"""Horizontal / vertical partitioning of IMAC layers (H_P, V_P).

Each layer's crossbar splits into hp x vp subarrays: horizontal
partitions divide the *input* (row) dimension, vertical partitions the
*output* (column) dimension. `auto_partition` reproduces the paper's
Table III arithmetic: hp = ceil((fan_in + 1) / rows), vp = ceil(fan_out /
cols) — the +1 is the bias row (H_P=[13,4,3], V_P=[4,3,1] for the
400x120x84x10 MLP on 32x32 arrays).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Tiling of one (fan_in+1, fan_out) conductance matrix.

    Attributes:
      hp: number of horizontal partitions (row splits).
      vp: number of vertical partitions (column splits).
      rows: padded rows per tile.
      cols: padded cols per tile.
      total_rows: fan_in + 1 (bias row included).
      total_cols: fan_out.
    """

    hp: int
    vp: int
    rows: int
    cols: int
    total_rows: int
    total_cols: int

    @property
    def n_tiles(self) -> int:
        return self.hp * self.vp

    @property
    def row_pad(self) -> int:
        return self.hp * self.rows - self.total_rows

    @property
    def col_pad(self) -> int:
        return self.vp * self.cols - self.total_cols


def auto_partition(fan_in: int, fan_out: int, array_rows: int, array_cols: int) -> "tuple[int, int]":
    """Paper Table III: minimum partitions for a given subarray size."""
    hp = math.ceil((fan_in + 1) / array_rows)
    vp = math.ceil(fan_out / array_cols)
    return hp, vp


def plan_partition(fan_in: int, fan_out: int, hp: int, vp: int) -> PartitionPlan:
    """Plan tiling with user-specified (hp, vp)."""
    total_rows = fan_in + 1
    if hp < 1 or vp < 1:
        raise ValueError(f"partitions must be >= 1, got hp={hp} vp={vp}")
    if hp > total_rows or vp > fan_out:
        raise ValueError(
            f"more partitions than rows/cols: hp={hp} rows={total_rows}, "
            f"vp={vp} cols={fan_out}"
        )
    rows = math.ceil(total_rows / hp)
    cols = math.ceil(fan_out / vp)
    return PartitionPlan(
        hp=hp, vp=vp, rows=rows, cols=cols,
        total_rows=total_rows, total_cols=fan_out,
    )


def tile_matrix(g: torch.Tensor, plan: PartitionPlan, fill: float = 0.0) -> torch.Tensor:
    """Split (..., total_rows, total_cols) into (..., hp*vp, rows, cols)
    padded tiles; leading axes (e.g. a stacked-config axis) pass through.

    Padding cells get conductance `fill` (an absent device).
    """
    if tuple(g.shape[-2:]) != (plan.total_rows, plan.total_cols):
        raise ValueError(
            f"matrix {tuple(g.shape)} != plan {(plan.total_rows, plan.total_cols)}"
        )
    lead = tuple(g.shape[:-2])
    padded = F.pad(g, (0, plan.col_pad, 0, plan.row_pad), value=fill)
    tiles = padded.reshape(*lead, plan.hp, plan.rows, plan.vp, plan.cols)
    tiles = tiles.transpose(-3, -2)  # (..., hp, vp, rows, cols)
    return tiles.reshape(*lead, plan.n_tiles, plan.rows, plan.cols)


def untile_matrix(tiles: torch.Tensor, plan: PartitionPlan) -> torch.Tensor:
    """Inverse of tile_matrix (drops padding)."""
    t = tiles.reshape(plan.hp, plan.vp, plan.rows, plan.cols)
    t = t.permute(0, 2, 1, 3).reshape(plan.hp * plan.rows, plan.vp * plan.cols)
    return t[: plan.total_rows, : plan.total_cols]


def tile_inputs(v: torch.Tensor, plan: PartitionPlan) -> torch.Tensor:
    """Split (..., total_rows) input voltages into (..., hp, rows)."""
    if v.shape[-1] != plan.total_rows:
        raise ValueError(f"inputs {tuple(v.shape)} != total_rows {plan.total_rows}")
    v = F.pad(v, (0, plan.hp * plan.rows - plan.total_rows))
    return v.reshape(*v.shape[:-1], plan.hp, plan.rows)


def combine_outputs(per_tile: torch.Tensor, plan: PartitionPlan) -> torch.Tensor:
    """Sum partial output currents over horizontal partitions.

    Args:
      per_tile: (..., hp*vp, cols) per-tile column currents.

    Returns:
      (..., total_cols) combined currents (padding columns dropped).
    """
    t = per_tile.reshape(*per_tile.shape[:-2], plan.hp, plan.vp, plan.cols)
    summed = t.sum(dim=-3)  # partial sums over horizontal partitions
    out = summed.reshape(*summed.shape[:-2], plan.vp * plan.cols)
    return out[..., : plan.total_cols]



def plan_topology(
    topology: Sequence[int],
    array_rows: int,
    array_cols: int,
    hp: "Sequence[int] | None" = None,
    vp: "Sequence[int] | None" = None,
) -> "list[PartitionPlan]":
    """Plans for every layer of T_N = [n_0, n_1, ..., n_L].

    If hp/vp are None they are derived from the array size (Table III).
    """
    n_layers = len(topology) - 1
    if hp is None or vp is None:
        auto = [
            auto_partition(topology[i], topology[i + 1], array_rows, array_cols)
            for i in range(n_layers)
        ]
        hp = [a[0] for a in auto]
        vp = [a[1] for a in auto]
    if len(hp) != n_layers or len(vp) != n_layers:
        raise ValueError(
            f"H_P/V_P length mismatch: {len(hp)}/{len(vp)} vs {n_layers} layers"
        )
    return [
        plan_partition(topology[i], topology[i + 1], hp[i], vp[i])
        for i in range(n_layers)
    ]
