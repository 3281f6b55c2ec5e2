"""Wrapper of the `imac_mvm` CUDA kernel, and `analog_linear` on top of it.

`imac_mvm` computes ``DAC(x) @ Q(w)`` (see `ref.py`): for CPU tensors it
runs the plain version, for CUDA tensors it launches the kernel through
`imac_mvm_2d`, or raises. There is no fallback from the kernel to the
plain version. The kernel masks the ragged M/K/N edges itself, so
nothing is padded (the reference pads to 128-wide tiles). `launch_plan`
picks the kernel's route and grid: split-K weight streaming for
M <= 16, the 64x64 tile above.

`analog_linear` is the substrate's AnalogLinear: y = x @ w + b simulated
on ideal analog crossbars, with the reference's per-call normalisation.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.devices import DeviceTech, get_tech
from repro_torch.kernels import _build
from repro_torch.kernels.imac_mvm.ref import imac_mvm_ref

#: Kernel launches made by `imac_mvm_2d` in this process.
launches = 0

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_signature_set = False


def _lib() -> ctypes.CDLL:
    global _signature_set
    lib = _build.load("imac_mvm")
    if not _signature_set:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.imac_mvm_launch.argtypes = [
            ptr, i32, ptr, ptr, i32, i32, i32, i32, i32, ctypes.c_float,
            i32, i32, i32, i32, i32, i32, ptr,
        ]
        lib.imac_mvm_launch.restype = ctypes.c_int
        lib.imac_mvm_splitk_max_clusters.argtypes = [i32, i32, i32, i32, i32, i32, i32, ptr]
        lib.imac_mvm_splitk_max_clusters.restype = ctypes.c_int
        _signature_set = True
    return lib


def quant_args(dac_bits: int, levels: int) -> "tuple[int, int, float]":
    """The kernel's quantiser arguments: (DAC steps, levels, level step).

    DAC steps is 2^dac_bits - 1, or 0 for clipping only. The level step
    is 1/(levels - 1) computed in double and rounded to float32, as the
    reference's Python-float step is.
    """
    dac_n = (1 << dac_bits) - 1 if dac_bits > 0 else 0
    step = 1.0 / (levels - 1) if levels > 1 else 0.0
    return dac_n, levels, step


#: The split-K kernel's M buckets; a larger M takes the 64x64 tile.
M_BUCKETS = (4, 8, 12, 16)
#: Portable thread-block cluster size: the most K splits of one column tile.
MAX_SPLITS = 8
#: Fewest K rows worth a split of their own.
MIN_SPLIT_ROWS = 256
#: Most shared memory the quantised x slice may take (bytes).
XS_MAX_BYTES = 64 * 1024
H100_SMS = 132


class Plan(NamedTuple):
    """How `imac_mvm_2d` launches the kernel for one (M, K, N).

    route "splitk": `blocks` = ceil(N / bn) column tiles x `splits` K
    ranges of `k_chunk` rows (the last one shorter), each column tile's
    blocks one cluster; M rows in a bucket of `m_bucket`; x quantised into
    shared memory `x_rows` rows at a time; `waves` of at most
    `resident` blocks at once. route "tile64": the 64x64x16 tile (the
    other fields are 0, but `blocks`).
    """

    route: str
    m_bucket: int
    bn: int
    splits: int
    k_chunk: int
    x_rows: int
    blocks: int
    resident: int = 0
    waves: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def splitk_candidates(
    m: int, k: int, n: int, max_clusters: "Callable[[int, int, int, int], int]"
) -> "list[Plan]":
    """Every split-K plan for x (m, k) @ w (k, n), m <= 16, that fits the card.

    Each column tile (bn = 128 or 64) x K split count (1..8, at least
    MIN_SPLIT_ROWS rows a split, no empty split);
    ``max_clusters(m_bucket, bn, splits, x_rows)`` says how many of its
    clusters the card holds at once (0: none fits). The x slice is
    quantised into shared memory in equal pieces of at most XS_MAX_BYTES.
    """
    m_bucket = next(b for b in M_BUCKETS if m <= b)
    plans = []
    for splits in range(1, MAX_SPLITS + 1):
        k_chunk = _cdiv(k, splits)
        if _cdiv(k, k_chunk) != splits or (splits > 1 and k_chunk < MIN_SPLIT_ROWS):
            continue                        # an empty last split, or too few rows
        x_rows = _cdiv(k_chunk, _cdiv(4 * m_bucket * k_chunk, XS_MAX_BYTES))
        for bn in (128, 64):
            clusters = max_clusters(m_bucket, bn, splits, x_rows)
            if clusters > 0:
                blocks, resident = _cdiv(n, bn) * splits, clusters * splits
                plans.append(Plan("splitk", m_bucket, bn, splits, k_chunk, x_rows, blocks,
                                  resident, _cdiv(blocks, resident)))
    return plans


def launch_plan(
    m: int, k: int, n: int, max_clusters: "Callable[[int, int, int, int], int]",
    sms: int = H100_SMS,
) -> Plan:
    """The kernel's route and grid for x (m, k) @ w (k, n) on `sms` SMs.

    M > 16 takes the 64x64 tile. Otherwise, of `splitk_candidates`, the
    plan takes in order: a grid of at least 2 blocks per SM; the fullest
    waves (blocks over waves x resident blocks); the wider tile (x is
    quantised once per column tile); more blocks. The order is a rule of
    thumb, not a model of the kernel's time: timed against every
    candidate (tools/time_imac_mvm_tiles.py), it does not always pick the
    fastest; PERF.md records where it misses and by how much.
    """
    if m > M_BUCKETS[-1]:
        return Plan("tile64", 0, 0, 0, 0, 0, _cdiv(n, 64) * _cdiv(m, 64))
    plans = splitk_candidates(m, k, n, max_clusters)
    if not plans:
        raise ValueError(f"imac_mvm: no split-K plan fits the card for {(m, k, n)}")
    return max(plans, key=lambda p: (p.blocks >= 2 * sms, p.blocks / (p.waves * p.resident),
                                     p.bn, p.blocks))


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, x_bf16: bool, vec: bool, m_bucket: int, bn: int, splits: int,
                  x_rows: int) -> int:
    """Clusters of one split-K configuration that CUDA device `index` runs
    at once (cudaOccupancyMaxActiveClusters)."""
    clusters = ctypes.c_int(0)
    err = _lib().imac_mvm_splitk_max_clusters(int(x_bf16), int(vec), m_bucket, bn, splits,
                                              x_rows, index, ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"imac_mvm occupancy query failed with CUDA error {err}")
    return clusters.value


@functools.lru_cache(maxsize=None)
def device_plan(index: int, x_bf16: bool, vec: bool, m: int, k: int, n: int) -> Plan:
    """`launch_plan` for CUDA device `index`, with its SM count and its
    occupancy of the kernel (x bfloat16 or not, 16-byte w loads or not)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return launch_plan(m, k, n, device_clusters(index, x_bf16, vec), sms)


def device_clusters(index: int, x_bf16: bool, vec: bool) -> "Callable[[int, int, int, int], int]":
    """`max_clusters` of `launch_plan` for CUDA device `index`."""
    return functools.partial(_max_clusters, index, x_bf16, vec)


def plan_for(x: torch.Tensor, w: torch.Tensor) -> Plan:
    """The plan `imac_mvm_2d` launches x (M, K) @ w (K, N) with, on their
    CUDA device."""
    n = w.shape[1]
    vec = n % 4 == 0 and w.data_ptr() % 16 == 0     # the kernel's 16-byte w loads
    return device_plan(x.device.index, x.dtype == torch.bfloat16, vec, x.shape[0], x.shape[1], n)


def imac_mvm_2d(
    x: torch.Tensor, w: torch.Tensor, *, dac_bits: int = 8, levels: int = 16
) -> torch.Tensor:
    """Launch the kernel: x (M, K) float32 or bfloat16, w (K, N) float32,
    both contiguous CUDA tensors -> (M, N) float32."""
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"imac_mvm: x on {x.device}, w on {w.device}; the kernel needs "
                         "both on one CUDA device")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"imac_mvm: x is {x.dtype}, the kernel takes float32 or bfloat16")
    if w.dtype != torch.float32:
        raise TypeError(f"imac_mvm: w is {w.dtype}, the kernel takes float32")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"imac_mvm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("imac_mvm: x and w must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    if (m + 63) // 64 > 65535:
        raise ValueError(f"imac_mvm: {m} rows exceed the kernel's grid (65535 row tiles)")
    if max(m, k, n) >= 2**31:
        raise ValueError(f"imac_mvm: shapes {(m, k)} @ {(k, n)} exceed the kernel's int32 sizes")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    dac_n, lv, step = quant_args(dac_bits, levels)
    plan = plan_for(x, w)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().imac_mvm_launch(
        x.data_ptr(), _X_DTYPES[x.dtype], w.data_ptr(), y.data_ptr(),
        m, k, n, dac_n, lv, step, plan.m_bucket, plan.bn, plan.splits, plan.k_chunk,
        plan.x_rows, x.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"imac_mvm kernel launch failed with CUDA error {err}")
    launches += 1
    return y


def imac_mvm(
    x: torch.Tensor, w: torch.Tensor, *, dac_bits: int = 8, levels: int = 16
) -> torch.Tensor:
    """Quantised differential analog MVM. x: (..., K) in [0, 1] digital
    units; w: (K, N) in [-1, 1] normalised weights. Returns float32 (..., N)."""
    if w.ndim != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"imac_mvm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = imac_mvm_ref(xf, w, dac_bits=dac_bits, levels=levels)
    elif x.device.type == "cuda":
        y = imac_mvm_2d(xf.contiguous(), w.contiguous(), dac_bits=dac_bits, levels=levels)
    else:
        raise ValueError(f"imac_mvm: unsupported device {x.device}")
    return y.reshape(*lead, w.shape[1])


def analog_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    tech: "DeviceTech | str" = "PCM",
    *,
    dac_bits: int = 8,
    levels: Optional[int] = None,
    noise: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Drop-in y = x @ w + b simulated on ideal analog crossbars.

    As the reference: activations are normalised into [0, 1] by one
    global min/max over the whole call (dynamic-range DAC), weights into
    [-1, 1] by ``max|w| + 1e-12``; the technology sets the level count
    (``levels or tech.levels or 16``) and the read noise, which is drawn
    only when a generator is passed as `noise`. Returns x's dtype.
    """
    tech = get_tech(tech)
    levels = levels or tech.levels or 16
    w_scale = torch.linalg.vector_norm(w, ord=float("inf")) + 1e-12   # max|w|, one pass
    x_lo = torch.min(x)
    x_hi = torch.max(x)
    x_rng = torch.clamp_min(x_hi - x_lo, 1e-12)
    xn = (x - x_lo) / x_rng
    wn = w / w_scale
    y = imac_mvm(xn, wn, dac_bits=dac_bits, levels=levels)
    # Undo normalisation: x = xn*rng + lo -> x@w = (xn@wn)*rng*scale + lo*colsum.
    colsum = torch.sum(w, dim=0)
    y = y * (x_rng * w_scale) + x_lo * colsum
    if noise is not None and tech.read_noise_rel > 0:
        y = y + tech.read_noise_rel * torch.abs(y) * torch.randn(
            y.shape, generator=noise, dtype=y.dtype, device=y.device
        )
    if b is not None:
        y = y + b
    return y.to(x.dtype)
