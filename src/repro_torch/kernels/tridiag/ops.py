"""Wrapper of the `tridiag` CUDA kernel (batched Thomas solve).

`tridiag(dl, d, du, b)` solves the systems of the operands' broadcast
(..., N) shape. CPU tensors take the plain version (`ref.tridiag_ref`).
CUDA tensors take the kernel, launched on the views as given: the
wrapper merges the batch axes that every operand's strides allow
(`kernel_layout`), picks the block layout (`launch_plan`) and hands the
kernel each operand's pointer and strides, stride-0 broadcasts included.
No operand is copied, and there is no fallback from the kernel to the
plain version: what the kernel does not take raises.

x is written densely: in `b`'s own memory order when `b` already has the
full shape and is dense (so a transposed `b` gives a transposed `x`),
else contiguous.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tridiag.ref import tridiag_ref

#: Kernel launches made by `tridiag` in this process.
launches = 0

# Block layout; the source's constants (kThreads, kMaxAxes, kMaxSlabs).
THREADS = 64
MAX_AXES = 6
MAX_SLABS = 32
#: Static shared memory of a block: the slab offset and count tables.
STATIC_SMEM_BYTES = 8 * 5 * MAX_SLABS + 4 * MAX_SLABS

# Hopper: 228 KB of shared memory an SM, 1 KB of it reserved per block.
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_BLOCK = 1024
#: The occupancy the on-chip route keeps at least: warps an SM.
ON_CHIP_WARPS_PER_SM = 8

_INDEX_LIMIT = 2**31 - 1

_signature_set = False


def _lib() -> ctypes.CDLL:
    global _signature_set
    lib = _build.load("tridiag")
    if not _signature_set:
        ptr = ctypes.c_void_p
        lib.tridiag_launch.argtypes = [
            ctypes.POINTER(ptr), ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ptr, ctypes.c_int, ctypes.c_int, ptr,
        ]
        lib.tridiag_launch.restype = ctypes.c_int
        for name in ("tridiag_threads", "tridiag_max_axes", "tridiag_max_slabs",
                     "tridiag_static_smem_bytes"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        _signature_set = True
    return lib


def on_chip_limit() -> int:
    """Dynamic shared memory (bytes) a block may take and keep the
    multipliers on chip: as much as lets blocks of `ON_CHIP_WARPS_PER_SM`
    warps in all share an SM (4 blocks of 2 warps: 55.6 KB less the
    static tables)."""
    blocks = ON_CHIP_WARPS_PER_SM // (THREADS // 32)
    return SMEM_PER_SM // blocks - SMEM_RESERVED_PER_BLOCK - STATIC_SMEM_BYTES


def kernel_layout(
    shape: Sequence[int], tensors: Sequence[torch.Tensor]
) -> "tuple[list[int], list[list[int]], list[int]]":
    """The (sizes, strides) the kernel walks for `tensors` broadcast to `shape`.

    Batch axes (all but the last) of size 1 are dropped, and neighbouring
    batch axes are merged wherever every tensor's strides allow it (outer
    stride == inner stride x inner size). No data moves: these are the
    strides of each tensor's own broadcast view.

    Returns:
      (sizes, batch_strides, element_strides): the merged batch sizes
      (innermost last; a single axis of size 1 when there is no batch),
      per tensor its strides along them, and per tensor its stride along
      the element axis (shape[-1]).

    Raises:
      ValueError: if more than `MAX_AXES` batch axes remain.
    """
    shape = tuple(shape)
    strides = [t.expand(shape).stride() for t in tensors]
    axes: "list[tuple[int, list[int]]]" = []
    for a, size in enumerate(shape[:-1]):
        if size == 1:
            continue
        st = [s[a] for s in strides]
        if axes and all(outer == inner * size for outer, inner in zip(axes[-1][1], st)):
            axes[-1] = (axes[-1][0] * size, st)
        else:
            axes.append((size, st))
    if not axes:
        axes = [(1, [0] * len(tensors))]
    if len(axes) > MAX_AXES:
        raise ValueError(
            f"tridiag: the operands' layouts leave {len(axes)} batch axes after "
            f"merging; the kernel takes at most {MAX_AXES}"
        )
    sizes = [size for size, _ in axes]
    batch_strides = [[st[i] for _, st in axes] for i in range(len(tensors))]
    return sizes, batch_strides, [s[-1] for s in strides]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the kernel's blocks cover the systems.

    Attributes:
      systems: S, consecutive systems of the innermost batch axis a slab.
      slabs: P, slabs a block (S x P <= THREADS, one thread a system).
      spad: the element stride of the shared-memory layout, where the
        block's P x S systems sit side by side: (P x S) | 1 (odd).
      dense_off: dl and du vary over a slab and are staged too; else each
        is one value a slab, read by every thread at one address.
      efast: per dl, d, du, b, x, whether staging walks the element axis
        fastest (its stride is the smaller), else the system axis.
      contig: per tensor, whether a slab is one run of memory in that
        order (node j at offset j), so staging needs no stride arithmetic.
      grid: blocks.
      smem_bytes: dynamic shared memory of a block (on chip): b and d, and
        dl and du when `dense_off`, each N x spad floats.
      on_chip: the multipliers stay in shared memory; else the kernel
        reads the operands through their strides and keeps c in a
        workspace of n * grid * THREADS floats.
    """

    systems: int
    slabs: int
    spad: int
    dense_off: bool
    efast: "tuple[int, ...]"
    contig: "tuple[int, ...]"
    grid: int
    smem_bytes: int
    on_chip: bool

    def ints(self) -> "list[int]":
        return [self.systems, self.slabs, self.spad, int(self.dense_off), *self.efast,
                *self.contig, self.grid, self.smem_bytes]


def launch_plan(
    sizes: Sequence[int], batch_strides: Sequence[Sequence[int]],
    element_strides: Sequence[int], n: int,
) -> LaunchPlan:
    """The block layout for `kernel_layout`'s output (tensors dl, d, du, b, x).

    A block takes P slabs of S systems (S = the inner batch axis, up to
    THREADS). b and d are staged into shared memory; dl and du too, unless
    both are uniform over a slab (stride 0 along the inner batch axis and
    the element axis), as the backend's off-diagonals are.
    """
    inner = sizes[-1]
    s = min(inner, THREADS)
    p = min(THREADS // s, MAX_SLABS)
    spad = (s * p) | 1

    def uniform(i: int) -> bool:
        return batch_strides[i][-1] == 0 and element_strides[i] == 0

    dense_off = not (uniform(0) and uniform(2))

    def efast(i: int) -> int:
        es, ss = element_strides[i], batch_strides[i][-1]
        return int(es != 0 and (ss == 0 or es <= ss))

    def contig(i: int) -> int:
        es, ss = element_strides[i], batch_strides[i][-1]
        return int((ss, es) == ((n, 1) if efast(i) else (1, s)))

    tiles = -(-inner // s)
    n_slabs = math.prod(sizes[:-1]) * tiles
    if max(max(sizes), n_slabs + p, n * spad) > _INDEX_LIMIT:
        raise ValueError(f"tridiag: {n_slabs} slabs of {s}x{n} overflow the kernel's 32-bit indices")
    smem = 4 * (4 if dense_off else 2) * n * spad
    return LaunchPlan(
        systems=s, slabs=p, spad=spad, dense_off=dense_off,
        efast=tuple(efast(i) for i in range(5)), contig=tuple(contig(i) for i in range(5)),
        grid=-(-n_slabs // p), smem_bytes=smem, on_chip=smem <= on_chip_limit(),
    )


# The launch arguments of each (shape, operand shapes and strides) seen:
# a sweep loop calls the kernel on the same layouts again and again.
_launches: "dict[tuple, tuple]" = {}


def _launch_args(shape, tensors) -> tuple:
    """(plan, ndim, sizes, strides, plan ints) as the C interface takes them."""
    sizes, batch_strides, element_strides = kernel_layout(shape, tensors)
    plan = launch_plan(sizes, batch_strides, element_strides, shape[-1])
    flat = [v for i in range(5) for v in (*batch_strides[i], element_strides[i])]
    ints = plan.ints()
    if len(_launches) >= 256:
        _launches.clear()
    return (plan, len(sizes), (ctypes.c_longlong * len(sizes))(*sizes),
            (ctypes.c_longlong * len(flat))(*flat), (ctypes.c_int * len(ints))(*ints))


def _broadcast_shape(*shapes: torch.Size) -> torch.Size:
    """`torch.broadcast_shapes` for a few shapes, without its host cost."""
    if all(s == shapes[0] for s in shapes):
        return shapes[0]
    rank = max(len(s) for s in shapes)
    out = []
    for a in range(-rank, 0):
        sizes = {s[a] for s in shapes if len(s) >= -a} - {1}
        if len(sizes) > 1:
            raise ValueError(f"tridiag: shapes {[tuple(s) for s in shapes]} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return torch.Size(out)


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"tridiag: {name} on {t.device}, expected {device} (CUDA)")
    if t.dtype != torch.float32:
        raise TypeError(f"tridiag: {name} is {t.dtype}, the kernel takes float32")


def tridiag(
    dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Batched tridiagonal solve along the last axis.

    Same semantics as `ref.tridiag_ref` (dl[..., 0] and du[..., -1]
    ignored; inputs broadcast to one (..., N) shape). CPU tensors take
    the plain version; CUDA tensors take the kernel, on the views given.

    Args:
      dl, d, du, b: float32 operands, broadcastable to one (..., N) shape.

    Returns:
      x of the broadcast shape: in b's memory order when b has that shape
      and is dense (a transposed b gives a transposed x), else contiguous.
    """
    global launches
    device = d.device
    if device.type == "cpu":
        return tridiag_ref(dl, d, du, b)
    if device.type != "cuda":
        raise ValueError(f"tridiag: unsupported device {device}")
    for name, t in (("dl", dl), ("d", d), ("du", du), ("b", b)):
        _check(name, t, device)
    shape = _broadcast_shape(dl.shape, d.shape, du.shape, b.shape)
    if len(shape) == 0:
        raise ValueError("tridiag: the operands have rank 0; systems run along the last axis")
    x = torch.empty_like(b) if b.shape == shape else torch.empty(shape, device=device)
    n = shape[-1]
    if x.numel() == 0:
        return x
    tensors = (dl, d, du, b, x)
    key = (shape, *((t.shape, t.stride()) for t in tensors))
    launch = _launches.get(key)
    if launch is None:
        launch = _launches[key] = _launch_args(shape, tensors)
    plan, ndim, c_sizes, c_strides, c_plan = launch
    ws = None if plan.on_chip else torch.empty(n * plan.grid * THREADS, device=device)
    ptrs = (ctypes.c_void_p * 5)(*(t.data_ptr() for t in tensors))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib().tridiag_launch(
        ptrs, c_sizes, c_strides, ndim, n, c_plan,
        None if ws is None else ws.data_ptr(), int(plan.on_chip), device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"tridiag kernel launch failed with CUDA error {err}")
    launches += 1
    return x
