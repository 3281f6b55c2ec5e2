"""Wrapper of the `decode_attention` CUDA kernel (GQA flash-decoding).

`decode_attention` takes the reference's GQA layout — q (B, H, Dk),
cache k (B, S, Hkv, Dk) and v (B, S, Hkv, Dv), lengths (B,) — and runs
the plain version (`ref.decode_attention_ref`) for CPU tensors, or
launches the kernel for CUDA tensors, or raises. The kernel reads the
cache in place through its strides (no (B*Hkv, S, D) copy as the
reference's wrapper makes), reads one length per batch element, and
masks the ragged tail itself, so any S works (no block-size halving).

`plan_for` picks the kernel's route by shape: "splitkv" (bfloat16,
G <= 8, Dk = Dv in SPLIT_DIMS, 16-byte aligned rows) splits each row's cache
across a thread-block cluster, sized by `split_plan` from the cache's
capacity S and the card's cluster occupancy; "rows" (anything else)
runs one block per (batch, KV-head) row.

A length past S keeps all S positions, as the plain version's mask
does; a length of 0 is not supported (the row has nothing to attend).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

#: Kernel launches made by `launch` in this process (one per `decode_attention`
#: call on a CUDA tensor).
launches = 0

#: Rows route: cache positions per block, before shrinking to fit shared memory.
MAX_BLOCK = 64
#: cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100 (bytes).
H100_SMEM_OPTIN_BYTES = 232_448

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_signature_set = False


def _lib() -> ctypes.CDLL:
    global _signature_set
    lib = _build.load("decode_attention")
    if not _signature_set:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.decode_attention_launch.argtypes = (
            [ptr] * 5 + [i32] * 7 + [i64] * 6 + [ctypes.c_float, i32, i32, ptr]
        )
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_smem_bytes.argtypes = [i32, i32, i32, i32]
        lib.decode_attention_smem_bytes.restype = ctypes.c_longlong
        lib.decode_attention_splitkv_launch.argtypes = (
            [ptr] * 5 + [i32] * 5 + [i64] * 6 + [ctypes.c_float, i32, i32, i32, ptr]
        )
        lib.decode_attention_splitkv_launch.restype = ctypes.c_int
        lib.decode_attention_splitkv_max_clusters.argtypes = [i32, i32, i32, ptr]
        lib.decode_attention_splitkv_max_clusters.restype = ctypes.c_int
        _signature_set = True
    return lib


def smem_bytes(g: int, dk: int, dv: int, bs: int) -> int:
    """Shared memory of one rows-route block: q, a K block (rows padded to
    Dk + 1), a V block, the block's scores, the accumulator and (m, l,
    alpha), in float32."""
    return 4 * (g * dk + bs * (dk + 1) + bs * dv + g * bs + g * dv + 3 * g)


def block_size(g: int, dk: int, dv: int) -> int:
    """Positions per rows-route block: MAX_BLOCK, halved until the block
    fits an H100."""
    bs = MAX_BLOCK
    while bs > 8 and smem_bytes(g, dk, dv, bs) > H100_SMEM_OPTIN_BYTES:
        bs //= 2
    if smem_bytes(g, dk, dv, bs) > H100_SMEM_OPTIN_BYTES:
        raise ValueError(
            f"decode_attention: G={g}, Dk={dk}, Dv={dv} needs "
            f"{smem_bytes(g, dk, dv, bs)} bytes of shared memory even at {bs} positions"
        )
    return bs


#: Head dims (Dk = Dv) the split-KV route is compiled for.
SPLIT_DIMS = (64, 128)
#: Most grouped heads of the split-KV route (rows 0-7 of its MMA).
SPLIT_MAX_G = 8
#: Portable thread-block cluster size: the most splits of one row.
MAX_SPLITS = 8
#: Positions of one split-KV block tile: 4 warps x 16 (the MMA's K depth).
SPLIT_TILE = 64


class Plan(NamedTuple):
    """How `decode_attention` launches the kernel for one call.

    route "splitkv": `blocks` = rows x `splits` blocks, the splits of a
    row one cluster, block rank r owning positions [r*chunk, (r+1)*chunk);
    `waves` of at most `resident` blocks at once. route "rows": one block
    per row (`blocks` = rows; the other fields 0).
    """

    route: str
    splits: int
    chunk: int
    blocks: int
    resident: int = 0
    waves: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_candidates(
    rows: int, s: int, tile: int, max_clusters: "Callable[[int], int]"
) -> "list[Plan]":
    """Every split-KV grid for `rows` (batch, KV-head) rows over a cache of
    capacity `s`, with block tiles of `tile` positions, that fits the card.

    Each split count 1..MAX_SPLITS gives ranges of ``chunk`` positions
    (ceil(s / splits) rounded up to a tile); a count whose last range
    would start past the cache is skipped. ``max_clusters(splits)`` says
    how many clusters of that size the card holds at once (0: none fits).
    """
    plans = []
    for splits in range(1, MAX_SPLITS + 1):
        chunk = _cdiv(_cdiv(s, splits), tile) * tile
        if (splits - 1) * chunk >= s:
            continue                     # the last split would start past the cache
        clusters = max_clusters(splits)
        if clusters > 0:
            blocks, resident = rows * splits, clusters * splits
            plans.append(Plan("splitkv", splits, chunk, blocks, resident,
                              _cdiv(blocks, resident)))
    return plans


def split_plan(
    rows: int, s: int, tile: int, max_clusters: "Callable[[int], int]"
) -> Plan:
    """The split-KV grid for `rows` rows over a cache of capacity `s`: of
    `split_candidates`, in order, the fewest positions on its critical
    path (waves x chunk), the fewest waves, the most blocks. It uses the
    capacity, never the lengths, which live on the device.

    The rule follows the timings of every candidate on the card
    (tools/time_decode_attention_plans.py, PERF.md): a grid that runs in
    one wave beats one of more, smaller blocks in several waves.
    """
    plans = split_candidates(rows, s, tile, max_clusters)
    if not plans:
        raise ValueError(f"decode_attention: no split-KV plan fits the card for {rows} rows, "
                         f"S={s}")
    return max(plans, key=lambda p: (-p.waves * p.chunk, -p.waves, p.blocks))


def takes_split_route(dtype: torch.dtype, g: int, dk: int, dv: int, aligned: bool) -> bool:
    """Whether a call in `dtype` of G heads per KV head, head dims (dk, dv)
    and 16-byte aligned rows (`aligned`) goes through the split-KV route.
    Every full-width config serves in bfloat16; the float32 callers (the
    reduced configs, head dim 32) take the rows route."""
    return (dtype == torch.bfloat16 and aligned and g <= SPLIT_MAX_G and dk == dv
            and dk in SPLIT_DIMS)


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, d: int, splits: int) -> int:
    """Clusters of `splits` split-KV blocks that CUDA device `index` runs
    at once (cudaOccupancyMaxActiveClusters)."""
    clusters = ctypes.c_int(0)
    err = _lib().decode_attention_splitkv_max_clusters(d, splits, index, ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"decode_attention occupancy query failed with CUDA error {err}")
    return clusters.value


def device_clusters(index: int, d: int) -> "Callable[[int], int]":
    """`max_clusters` of `split_plan` for CUDA device `index`, head dim `d`."""
    return functools.partial(_max_clusters, index, d)


@functools.lru_cache(maxsize=None)
def _device_plan(index: int, dtype: torch.dtype, q_shape: torch.Size, k_stride: "tuple[int, ...]",
                 v_shape: torch.Size, v_stride: "tuple[int, ...]", ptrs_aligned: bool) -> Plan:
    b, h, dk = q_shape
    _, s, hkv, dv = v_shape
    width = 16 // (2 if dtype == torch.bfloat16 else 4)   # elements per 16 bytes
    aligned = ptrs_aligned and all(st % width == 0 for st in (*k_stride[:3], *v_stride[:3], dk))
    if not takes_split_route(dtype, h // hkv, dk, dv, aligned):
        return Plan("rows", 0, 0, b * hkv)
    return split_plan(b * hkv, s, SPLIT_TILE, device_clusters(index, dk))


def plan_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """The plan `decode_attention` launches q (B, H, Dk) against the cache
    k (B, S, Hkv, Dk), v (B, S, Hkv, Dv) with, on their CUDA device: the
    split-KV route where `takes_split_route` (every row start of q, k and v
    on a 16-byte boundary), else the rows route. Cached per shape."""
    ptrs_aligned = not (q.data_ptr() | k.data_ptr() | v.data_ptr()) & 15
    return _device_plan(q.device.index, q.dtype, q.shape, k.stride(), v.shape, v.stride(),
                        ptrs_aligned)


def _check(q, k, v, kv_len):
    if q.ndim != 3 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected (B, H, Dk), (B, S, Hkv, Dk), "
                         "(B, S, Hkv, Dv)")
    b, h, dk = q.shape
    if k.shape[0] != b or k.shape[3] != dk or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} disagree")
    if h % k.shape[2]:
        raise ValueError(f"decode_attention: {h} heads do not group over {k.shape[2]} KV heads")
    if kv_len is not None and tuple(kv_len.shape) != (b,):
        raise ValueError(f"decode_attention: kv_len has shape {tuple(kv_len.shape)}, "
                         f"expected ({b},)")


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-step decode attention with online softmax over cache blocks.

    q (B, H, Dk), k (B, S, Hkv, Dk), v (B, S, Hkv, Dv), kv_len (B,) int
    (None: all S). Returns (B, H, Dv) in q's dtype.
    """
    _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if kv_len is None:
        lens = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32, device=q.device)
    elif kv_len.dtype.is_floating_point or kv_len.dtype == torch.bool:
        raise TypeError(f"decode_attention: kv_len is {kv_len.dtype}, expected integers")
    else:
        lens = kv_len.to(torch.int32).contiguous()
    return launch(q, k, v, lens, plan_for(q, k, v), scale=scale)


def launch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor,
    plan: Plan,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel with `plan`: `plan_for`'s, or for timing another of
    `split_candidates` or the rows route. q, k, v, lens (B,) int32 on one
    CUDA device. Returns (B, H, Dv) in q's dtype."""
    global launches
    b, h, dk = q.shape
    _, s, hkv, dv = v.shape
    g = h // hkv
    if scale is None:
        scale = dk ** -0.5
    for name, t in (("k", k), ("v", v), ("kv_len", lens)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, expected {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q {q.dtype}, k {k.dtype}, v {v.dtype}; the "
                        "kernel takes float32 or bfloat16, all alike")
    if not q.is_contiguous() or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: q must be contiguous and the cache's last "
                         "dimension dense")
    if lens.dtype != torch.int32 or not lens.is_contiguous():
        raise TypeError("decode_attention: the kernel takes contiguous int32 lengths")
    out = torch.empty((b, h, dv), dtype=q.dtype, device=q.device)
    if b == 0 or h == 0:
        return out
    if s == 0:
        raise ValueError("decode_attention: the cache has no positions")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr())
    strides = (k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2))
    if plan.route == "splitkv":
        if q.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention: the split-KV route takes bfloat16, not {q.dtype}")
        err = _lib().decode_attention_splitkv_launch(
            *ptrs, b, hkv, g, s, dk, *strides, float(scale),
            plan.splits, plan.chunk, q.device.index, stream,
        )
    else:
        err = _lib().decode_attention_launch(
            *ptrs, _DTYPES[q.dtype], b, hkv, g, s, dk, dv, *strides, float(scale),
            block_size(g, dk, dv), q.device.index, stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with CUDA error {err}")
    launches += 1
    return out
