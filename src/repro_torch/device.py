"""Device resolution for the port's entry points.

Entry points take ``device=None``, which means the GPU. They never carry
on on the CPU when no GPU is present: the CPU is used only when asked
for by name (as the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> ``cuda``; raise when a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return dev
