"""Wrapper of the `imac_mvm` CUDA kernel, and `analog_linear` on top of it.

`imac_mvm` computes ``DAC(x) @ Q(w)`` (see `ref.py`): for CPU tensors it
runs the plain version, for CUDA tensors it launches the kernel through
`imac_mvm_2d`, or raises. There is no fallback from the kernel to the
plain version. The kernel masks the ragged M/K/N edges itself, so
nothing is padded (the reference pads to 128-wide tiles). `launch_plan`
picks the kernel's route and grid: the exact integer tensor-core route
("int8": the levels packed to u8 x s8, summed in s32) from M = 9 when
the quantisers are integer; otherwise split-K weight streaming for
M <= 16 and the 64x64 tile above.

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
from repro_torch.kernels.imac_mvm.ref import imac_mvm_ref, level_scale

#: Kernel launches made by `launch` in this process (one per `imac_mvm_2d` call).
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
        lib.imac_mvm_int8_launch.argtypes = [
            ptr, i32, ptr, ptr, i32, i32, i32, i32, i32, ctypes.c_float, ctypes.c_double,
            ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr,
        ]
        lib.imac_mvm_int8_launch.restype = ctypes.c_int
        lib.imac_mvm_int8_max_clusters.argtypes = [i32, i32, i32, ptr]
        lib.imac_mvm_int8_max_clusters.restype = ctypes.c_int
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


#: The split-K kernel's M buckets; a larger M takes the integer route or the 64x64 tile.
M_BUCKETS = (4, 8, 12, 16)
#: The fewest rows that take the integer route (with integer quantisers): on the
#: H100 it beats split-K from M = 12 at both yi-9b FFN shapes and ties it at M = 8
#: over a forward's three projections (tools/time_imac_mvm_tiles.py; PERF.md).
INT8_MIN_M = 9
#: The integer route's largest K: its s32 sums are exact while 255 * 127 * K < 2^31.
INT8_MAX_K = 66_000
#: The integer route's K bytes per pipeline step and columns per block.
INT8_BK = 128
INT8_BN = 128
#: Fewest K steps worth a split of their own on the integer route.
INT8_MIN_SPLIT_STEPS = 4
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
    `resident` blocks at once. route "int8": row tiles of `m_bucket`
    rows (64: one consumer warpgroup, 128: two) x column tiles of `bn` =
    128 x `splits` K ranges of `k_chunk` rows (a multiple of INT8_BK),
    each output tile's splits one cluster; `x_rows` is 0. route
    "tile64": the 64x64x16 tile (the other fields are 0, but `blocks`).
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


def integer_quantisers(dac_bits: int, levels: int) -> bool:
    """Whether both quantisers have integer levels that fit the integer
    route: DAC levels 0..2^dac_bits - 1 in u8, weight levels
    |r| <= levels - 1 in s8."""
    return 1 <= dac_bits <= 8 and 2 <= levels <= 128


def int8_padded_k(k: int) -> int:
    """Kp: K rounded up to 16 bytes, the packed levels' row length."""
    return _cdiv(k, 16) * 16


def int8_candidates(
    m: int, k: int, n: int, int8_clusters: "Callable[[int, int], int]"
) -> "list[Plan]":
    """Every integer-route plan for x (m, k) @ w (k, n) that fits the card.

    Row tiles of 64 rows for m <= 64, else 128; column tiles of 128; K
    split into 1..8 ranges of whole INT8_BK-byte steps (at least
    INT8_MIN_SPLIT_STEPS a split, no empty split). ``int8_clusters(wgs,
    splits)`` says how many clusters of `splits` blocks with `wgs`
    consumer warpgroups the card holds at once (0: none fits).
    """
    bm = 64 if m <= 64 else 128
    tiles = _cdiv(m, bm) * _cdiv(n, INT8_BN)
    k_steps = _cdiv(int8_padded_k(k), INT8_BK)
    plans = []
    for splits in range(1, MAX_SPLITS + 1):
        chunk = _cdiv(k_steps, splits)
        if _cdiv(k_steps, chunk) != splits or (splits > 1 and chunk < INT8_MIN_SPLIT_STEPS):
            continue
        clusters = int8_clusters(bm // 64, splits)
        if clusters > 0:
            blocks, resident = tiles * splits, clusters * splits
            plans.append(Plan("int8", bm, INT8_BN, splits, chunk * INT8_BK, 0, blocks,
                              resident, _cdiv(blocks, resident)))
    return plans


def int8_plan(m: int, k: int, n: int, int8_clusters: "Callable[[int, int], int]") -> Plan:
    """The integer route's grid for x (m, k) @ w (k, n), at any m.

    Of `int8_candidates` it splits K only when the output tiles fill less
    than one wave, and then takes the fewest K steps on the critical path
    (waves x steps per split), then fewer splits.
    """
    plans = int8_candidates(m, k, n, int8_clusters)
    if not plans:
        raise ValueError(f"imac_mvm: no integer-route plan fits the card for {(m, k, n)}")
    one = plans[0]
    if one.splits == 1 and one.blocks >= one.resident:
        return one
    return min(plans, key=lambda p: (p.waves * p.k_chunk, p.splits))


def check_int8_k(k: int) -> None:
    """Raise unless the integer route's s32 sums are exact at this K."""
    if k > INT8_MAX_K:
        raise ValueError(f"imac_mvm: K = {k} exceeds the integer route's {INT8_MAX_K} "
                         "(255 * 127 * K must stay below 2^31)")


def launch_plan(
    m: int, k: int, n: int, max_clusters: "Callable[[int, int, int, int], int]",
    sms: int = H100_SMS, *, dac_bits: int = 8, levels: int = 16,
    int8_clusters: "Callable[[int, int], int] | None" = None,
) -> Plan:
    """The kernel's route and grid for x (m, k) @ w (k, n) on `sms` SMs.

    M >= INT8_MIN_M takes the integer route (`int8_plan`) when the
    quantisers are integer (`integer_quantisers`) and K <= INT8_MAX_K.
    Otherwise M > 16 takes the 64x64 tile, and M <= 16 the split-K route:
    of `splitk_candidates`, the
    plan takes in order: a grid of at least 2 blocks per SM; the fullest
    waves (blocks over waves x resident blocks); the wider tile (x is
    quantised once per column tile); more blocks. The order is a rule of
    thumb, not a model of the kernel's time: timed against every
    candidate (tools/time_imac_mvm_tiles.py), it does not always pick the
    fastest; PERF.md records where it misses and by how much.
    """
    if m >= INT8_MIN_M and integer_quantisers(dac_bits, levels) and k <= INT8_MAX_K:
        if int8_clusters is None:
            raise ValueError("imac_mvm: the integer route's plan needs int8_clusters")
        return int8_plan(m, k, n, int8_clusters)
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
def _int8_max_clusters(index: int, wgs: int, splits: int) -> int:
    """Clusters of `splits` blocks of the integer route's GEMM (`wgs`
    consumer warpgroups) that CUDA device `index` runs at once."""
    clusters = ctypes.c_int(0)
    err = _lib().imac_mvm_int8_max_clusters(wgs, splits, index, ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"imac_mvm occupancy query failed with CUDA error {err}")
    return clusters.value


@functools.lru_cache(maxsize=None)
def device_plan(index: int, x_bf16: bool, vec: bool, m: int, k: int, n: int,
                dac_bits: int = 8, levels: int = 16) -> Plan:
    """`launch_plan` for CUDA device `index`, with its SM count and its
    occupancy of the kernels (x bfloat16 or not, 16-byte w loads or not)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return launch_plan(m, k, n, device_clusters(index, x_bf16, vec), sms, dac_bits=dac_bits,
                       levels=levels, int8_clusters=device_int8_clusters(index))


def device_clusters(index: int, x_bf16: bool, vec: bool) -> "Callable[[int, int, int, int], int]":
    """`max_clusters` of `launch_plan` for CUDA device `index`."""
    return functools.partial(_max_clusters, index, x_bf16, vec)


def device_int8_clusters(index: int) -> "Callable[[int, int], int]":
    """`int8_clusters` of `launch_plan` for CUDA device `index`."""
    return functools.partial(_int8_max_clusters, index)


def plan_for(x: torch.Tensor, w: torch.Tensor, *, dac_bits: int = 8, levels: int = 16) -> Plan:
    """The plan `imac_mvm_2d` launches x (M, K) @ w (K, N) with, on their
    CUDA device, for these quantisers."""
    n = w.shape[1]
    vec = n % 4 == 0 and w.data_ptr() % 16 == 0     # the kernel's 16-byte w loads
    return device_plan(x.device.index, x.dtype == torch.bfloat16, vec, x.shape[0], x.shape[1], n,
                       dac_bits, levels)


def _workspace_offsets(m: int, n: int, kp: int) -> "tuple[int, int, int]":
    """Byte offsets of the packed w levels and the NaN flags in the integer
    route's workspace, and its size: xq (m * kp), wq (n * kp), flags
    (m + n int32), each part 256-byte aligned."""
    w_off = _cdiv(m * kp, 256) * 256
    flags_off = w_off + _cdiv(n * kp, 256) * 256
    return w_off, flags_off, flags_off + 4 * (m + n)


def _launch_int8(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, plan: Plan,
                 dac_bits: int, levels: int, stream: int) -> int:
    """The integer route: pack x and w to levels in a workspace, then the
    u8 x s8 -> s32 GEMM; returns the CUDA error code. The workspace is
    freed to PyTorch's allocator on return, which reuses it only for work
    queued after these kernels on the same stream."""
    if not integer_quantisers(dac_bits, levels):
        raise ValueError(f"imac_mvm: the integer route takes 1 <= dac_bits <= 8 and "
                         f"2 <= levels <= 128, not {dac_bits} and {levels}")
    m, k = x.shape
    n = w.shape[1]
    check_int8_k(k)
    kp = int8_padded_k(k)
    w_off, flags_off, size = _workspace_offsets(m, n, kp)
    ws = torch.empty(size, dtype=torch.uint8, device=x.device)
    base = ws.data_ptr()
    dac_n, lv, step = quant_args(dac_bits, levels)
    return _lib().imac_mvm_int8_launch(
        x.data_ptr(), _X_DTYPES[x.dtype], w.data_ptr(), y.data_ptr(), m, k, n, dac_n, lv, step,
        level_scale(dac_bits, levels), base, base + w_off, base + flags_off, kp,
        plan.m_bucket // 64, plan.splits, plan.k_chunk // INT8_BK, x.device.index, stream,
    )


def imac_mvm_2d(
    x: torch.Tensor, w: torch.Tensor, *, dac_bits: int = 8, levels: int = 16
) -> torch.Tensor:
    """Launch the kernel: x (M, K) float32 or bfloat16, w (K, N) float32,
    both contiguous CUDA tensors -> (M, N) float32, through `launch` with
    the plan of `plan_for`."""
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
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=x.device)
    return launch(x, w, plan_for(x, w, dac_bits=dac_bits, levels=levels), dac_bits=dac_bits,
                  levels=levels)


def launch(x: torch.Tensor, w: torch.Tensor, plan: Plan, *, dac_bits: int = 8,
           levels: int = 16) -> torch.Tensor:
    """Launch the kernel with `plan`, of any route (the timing tools force
    a route this way; `imac_mvm_2d` passes `plan_for`'s): x (M, K), w (K,
    N), M, K, N >= 1, as `imac_mvm_2d` checks them -> (M, N) float32. One
    call counts one launch, whatever its route launches (the integer
    route: a memset of its NaN flags, two pack kernels and the GEMM, in
    order on the current stream)."""
    global launches
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.route == "int8":
        err = _launch_int8(x, w, y, plan, dac_bits, levels, stream)
    else:
        dac_n, lv, step = quant_args(dac_bits, levels)
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
    w_scale: "torch.Tensor | float | None" = None,
) -> torch.Tensor:
    """Drop-in y = x @ w + b simulated on ideal analog crossbars.

    As the reference: activations are normalised into [0, 1] by one
    global min/max over the whole call (dynamic-range DAC), weights into
    [-1, 1] by `w_scale`, ``max|w| + 1e-12`` when None; the technology
    sets the level count (``levels or tech.levels or 16``) and the read
    noise, which is drawn only when a generator is passed as `noise`.
    Returns x's dtype.
    """
    tech = get_tech(tech)
    levels = levels or tech.levels or 16
    if w_scale is None:
        w_scale = torch.linalg.vector_norm(w, ord=float("inf")) + 1e-12   # max|w|, one pass
    else:   # a tensor: torch divides by a Python number through its reciprocal on CUDA
        w_scale = torch.as_tensor(w_scale, dtype=w.dtype, device=w.device)
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
