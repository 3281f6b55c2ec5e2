"""Digital reference MLP — the "trained weights and biases" input to
IMAC-Sim (Algorithm 1), trained with torch's Adam.

Parameters keep the reference's layout: a list [(W, b), ...] with W of
shape (fan_in, fan_out) and z = a @ W + b. Sigmoid hidden layers, linear
readout (matching the analog circuit's diff-amp readout).

Random draws (initial weights, batch indices) are made on the CPU from an
explicit `torch.Generator` and then moved, so the CPU and the GPU start
from the same weights and see the same batches.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device

Params = List[Tuple[torch.Tensor, torch.Tensor]]

_ACTIVATIONS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": F.relu}


def init_mlp(
    topology: Sequence[int], *, generator: Optional[torch.Generator] = None
) -> Params:
    """Glorot-initialised MLP params [(W, b), ...] on the CPU; W: (fan_in, fan_out).

    `generator` is a CPU generator (default: seeded with 0).
    """
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params = []
    for fan_in, fan_out in zip(topology[:-1], topology[1:]):
        scale = math.sqrt(2.0 / (fan_in + fan_out))
        w = scale * torch.randn((fan_in, fan_out), generator=gen, dtype=torch.float32)
        params.append((w, torch.zeros((fan_out,), dtype=torch.float32)))
    return params


def mlp_forward(params: Params, x: torch.Tensor, activation: str = "sigmoid") -> torch.Tensor:
    """Digital forward; hidden-layer `activation`, linear readout."""
    act = _ACTIVATIONS[activation]
    a = x
    for i, (w, b) in enumerate(params):
        z = a @ w + b
        a = z if i == len(params) - 1 else act(z)
    return a


class MLP(nn.Module):
    """The digital MLP as a module whose parameters keep the (W, b) layout."""

    def __init__(self, params: Params, activation: str = "sigmoid"):
        super().__init__()
        self.activation = activation
        self.weights = nn.ParameterList(nn.Parameter(w.clone()) for w, _ in params)
        self.biases = nn.ParameterList(nn.Parameter(b.clone()) for _, b in params)

    def params(self) -> Params:
        return [(w.detach().clone(), b.detach().clone())
                for w, b in zip(self.weights, self.biases)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(list(zip(self.weights, self.biases)), x, self.activation)


def train_mlp(
    topology: Sequence[int],
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    steps: int = 300,
    batch_size: int = 128,
    lr: float = 3e-3,
    activation: str = "sigmoid",
    generator: Optional[torch.Generator] = None,
    device: "str | torch.device | None" = None,
) -> Params:
    """Train with Adam + softmax cross-entropy. Returns trained params.

    Args:
      topology: layer widths [n_0, ..., n_L].
      x: (n, n_0) inputs; y: (n,) integer labels.
      generator: CPU generator for the initial weights and the batch
        indices (default: seeded with 0).
      device: where to train (None = the GPU).
    """
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    model = MLP(init_mlp(topology, generator=gen), activation).to(dev)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    y = torch.as_tensor(y, dtype=torch.long).to(dev)
    idxs = torch.randint(0, x.shape[0], (steps, batch_size), generator=gen).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for step in range(steps):
        idx = idxs[step]
        loss = F.cross_entropy(model(x[idx]), y[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return model.params()


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor, activation: str = "sigmoid") -> float:
    pred = torch.argmax(mlp_forward(params, x, activation), dim=-1)
    return float(torch.mean((pred == y).to(torch.float32)))
