"""Carry weights and mappings into the port from numpy arrays.

`params_from_numpy` copies a list [(W, b), ...] of array-likes — e.g.
the reference package's trained parameters passed through `np.asarray`
— into the port's parameters, keeping the layout: W is (fan_in, fan_out)
and z = a @ W + b. `mapped_from_numpy` does the same for pre-computed
mappings (objects with g_pos, g_neg, w_scale, k, sense_r, v_unit), in the
form `evaluate_batch` takes as ``mapped=`` (one list per configuration)
or ``mapped_stacked=`` (one stacked list). `lm_params_from_numpy` loads
the reference's LM parameter pytree into the port's `Model`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.digital import Params
from repro_torch.core.mapping import MappedLayer


def params_from_numpy(
    params: "Sequence[tuple[np.ndarray, np.ndarray]]",
    *,
    device: "str | torch.device" = "cpu",
) -> Params:
    """[(W, b), ...] array-likes -> float32 tensors on `device`."""
    out = []
    for w, b in params:
        w = torch.tensor(np.asarray(w), dtype=torch.float32, device=device)
        b = torch.tensor(np.asarray(b), dtype=torch.float32, device=device)
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"bad layer shapes: W {tuple(w.shape)}, b {tuple(b.shape)}")
        out.append((w, b))
    return out


def mapped_from_numpy(
    layers: Sequence, *, device: "str | torch.device" = "cpu"
) -> "list[MappedLayer]":
    """Per-layer mappings with array-like fields -> `MappedLayer`s.

    A scalar `k` stays a float; a stacked (C,) `k` becomes a tensor.
    """
    out = []
    for m in layers:
        k = np.asarray(m.k)
        out.append(
            MappedLayer(
                g_pos=torch.tensor(np.asarray(m.g_pos), dtype=torch.float32, device=device),
                g_neg=torch.tensor(np.asarray(m.g_neg), dtype=torch.float32, device=device),
                w_scale=float(m.w_scale),
                k=float(k) if k.ndim == 0 else torch.tensor(k, device=device),
                sense_r=float(np.asarray(m.sense_r).reshape(-1)[0]),
                v_unit=float(m.v_unit),
            )
        )
    return out


def _leaves(tree, prefix: str = ""):
    """(dotted path, leaf) pairs of a nested dict."""
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        if isinstance(sub, dict):
            yield from _leaves(sub, path + ".")
        else:
            yield path, sub


@torch.no_grad()
def lm_params_from_numpy(model, tree) -> None:
    """Load the reference's LM parameter pytree into `model` in place.

    `tree` is `repro.models.Model.init`'s output with every leaf passed
    through `np.asarray`: ``{"embed": {"tok", "head"?}, "final_ln":
    {"scale"}, "stages": [{"l0": {...}, ...} stacked over repeats]}``.
    Each stage's stacked ``(repeats, ...)`` leaves are sliced per layer.
    The layouts are the reference's (`wq (E, H, D)`, `wo (H, D, E)`,
    `head (E, V)`); each array is cast to its parameter's dtype.

    Raises:
      ValueError: on a missing, unexpected or mis-shaped parameter.
    """
    named = dict(_leaves({"embed": tree["embed"], "final_ln": tree["final_ln"]}))
    idx = 0
    for stage, st_tree in zip(model.stages, tree["stages"], strict=True):
        for r in range(stage.repeats):
            for i in range(len(stage.kinds)):
                for path, leaf in _leaves(st_tree[f"l{i}"]):
                    named[f"layers.{idx}.{path}"] = np.asarray(leaf)[r]
                idx += 1
    params = dict(model.named_parameters())
    if set(named) != set(params):
        raise ValueError(f"parameter mismatch: missing {sorted(set(params) - set(named))}, "
                         f"unexpected {sorted(set(named) - set(params))}")
    for name, arr in named.items():
        p = params[name]
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(p.shape)}")
        p.copy_(torch.as_tensor(np.array(arr, dtype=np.float32)))
