"""SwiGLU feed-forward (+ the paper's analog-crossbar execution mode).

With ``cfg.analog_mvm`` the projections run through the ideal-analog
crossbar simulation (`kernels/imac_mvm/ops.analog_linear`: DAC
quantisation, differential conductance levels, optional read noise) —
IMAC as an inference accelerator for the FFN weights, paper ref [1].
The analog path keeps the weights in `param_dtype` and hands them over
in float32, as the reference does; the digital path stores them in the
compute dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.imac_mvm.ops import analog_linear
from repro_torch.models.common import digital_dtype, dtype_of, init_normal_, weight


class MLP(nn.Module):
    """`w_gate (E, F)`, `w_up (E, F)`, `w_down (F, E)`."""

    def __init__(self, cfg: ModelConfig, *, device, d_ff: int = 0):
        super().__init__()
        e, f = cfg.d_model, d_ff or cfg.d_ff
        dt = dtype_of(cfg.param_dtype) if cfg.analog_mvm else digital_dtype(cfg)
        self.w_gate = weight((e, f), dt, device)
        self.w_up = weight((e, f), dt, device)
        self.w_down = weight((f, e), dt, device)

    def init(self, generator: torch.Generator) -> None:
        for p in (self.w_gate, self.w_up, self.w_down):
            init_normal_(p, generator)


def _proj(x: torch.Tensor, w: torch.Tensor, cfg: Optional[ModelConfig]) -> torch.Tensor:
    if cfg is not None and cfg.analog_mvm:
        lead = x.shape[:-1]
        y = analog_linear(x.reshape(-1, x.shape[-1]), w.float(), None, tech=cfg.analog_tech)
        return y.reshape(*lead, w.shape[-1]).to(x.dtype)
    return torch.einsum("bse,ef->bsf", x, w.to(x.dtype))


def mlp_apply(p: MLP, x: torch.Tensor, cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    g = _proj(x, p.w_gate, cfg)
    u = _proj(x, p.w_up, cfg)
    return _proj(F.silu(g) * u, p.w_down, cfg)
