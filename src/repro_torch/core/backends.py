"""Named solver-backend registry for the crossbar circuit solve.

The block Gauss–Seidel solve in `repro_torch.core.solver` runs one of
two ways:

  * ``"tridiag"`` (default) — the generic sweep loop in torch, with the
    batched tridiagonal (Thomas) solve of each half-sweep done by the
    `tridiag` CUDA kernel (`repro_torch.kernels.tridiag`);
  * ``"fused"`` — the `gs_fused` CUDA kernel runs the whole sweep loop
    with each system resident in shared memory
    (`repro_torch.kernels.gs_fused`).

On CPU tensors each kernel's wrapper runs its plain torch version; on a
CUDA tensor it launches the kernel or raises. No entry runs the plain
Thomas loop on a CUDA tensor.

Backends are selected by name through `solver.SolveOptions`, or by the
``REPRO_SOLVER_BACKEND`` environment variable for a process-wide
default; a custom inner solve registers with `register_backend` or is
passed directly as a callable.

Kernel modules are imported lazily, inside the factories.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch

#: Batched tridiagonal solve along the last axis: (dl, d, du, b) -> x,
#: with dl[..., 0] and du[..., -1] ignored.
TridiagFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor
]

DEFAULT_BACKEND = "tridiag"
ENV_BACKEND = "REPRO_SOLVER_BACKEND"


@dataclasses.dataclass(frozen=True)
class SolverBackend:
    """One registered way to run the crossbar solve.

    Exactly one of the two factories is set:

    Attributes:
      name: registry key.
      make_tridiag: factory ``options -> TridiagFn`` for the inner solve
        of the generic sweep loop in `solver.solve_crossbar`.
      make_solve: factory ``options -> (g, v_in, cp, stamps) ->
        CrossbarSolution`` replacing the sweep loop entirely.
    """

    name: str
    make_tridiag: Optional[Callable] = None
    make_solve: Optional[Callable] = None


_REGISTRY: "dict[str, SolverBackend]" = {}


def register_backend(backend: SolverBackend) -> SolverBackend:
    """Register (or replace) a named solver backend."""
    _REGISTRY[backend.name] = backend
    return backend


def available_backends() -> "tuple[str, ...]":
    return tuple(sorted(_REGISTRY))


def default_backend_name() -> str:
    """Process-wide default backend: $REPRO_SOLVER_BACKEND or ``"tridiag"``."""
    return os.environ.get(ENV_BACKEND, DEFAULT_BACKEND)


def get_backend(spec: "str | SolverBackend | TridiagFn | None") -> SolverBackend:
    """Resolve a backend spec: name, SolverBackend, TridiagFn, or None.

    None resolves to `default_backend_name()`. A bare callable is wrapped
    as an anonymous inner-tridiag backend.
    """
    if spec is None:
        spec = default_backend_name()
    if isinstance(spec, SolverBackend):
        return spec
    if callable(spec):
        fn = spec
        return SolverBackend(
            name=getattr(fn, "__name__", "custom"),
            make_tridiag=lambda options: fn,
        )
    try:
        return _REGISTRY[spec]
    except KeyError:
        raise KeyError(
            f"unknown solver backend {spec!r}; available: "
            f"{', '.join(available_backends())}"
        ) from None


def _make_tridiag(options):
    from repro_torch.kernels.tridiag.ops import tridiag

    return tridiag


def _make_fused_solve(options):
    from repro_torch.kernels.gs_fused.ops import fused_solve

    return fused_solve


register_backend(SolverBackend(name="tridiag", make_tridiag=_make_tridiag))
register_backend(SolverBackend(name="fused", make_solve=_make_fused_solve))
