"""Wrapper of the `decode_attention` CUDA kernel (GQA flash-decoding).

`decode_attention` takes the reference's GQA layout — q (B, H, Dk),
cache k (B, S, Hkv, Dk) and v (B, S, Hkv, Dv), lengths (B,) — and runs
the plain version (`ref.decode_attention_ref`) for CPU tensors, or
launches the kernel for CUDA tensors, or raises. The kernel reads the
cache in place through its strides (no (B*Hkv, S, D) copy as the
reference's wrapper makes), reads one length per batch element, and
masks the ragged tail itself, so any S works (no block-size halving).

A length past S keeps all S positions, as the plain version's mask
does; a length of 0 is not supported (the row has nothing to attend).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

#: Kernel launches made by `decode_attention` in this process.
launches = 0

#: Cache positions per block, before shrinking to fit shared memory.
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
        _signature_set = True
    return lib


def smem_bytes(g: int, dk: int, dv: int, bs: int) -> int:
    """Shared memory of one block: q, a K block (rows padded to Dk + 1), a V
    block, the block's scores, the accumulator and (m, l, alpha), in float32."""
    return 4 * (g * dk + bs * (dk + 1) + bs * dv + g * bs + g * dv + 3 * g)


def block_size(g: int, dk: int, dv: int) -> int:
    """Positions per block: MAX_BLOCK, halved until the block fits an H100."""
    bs = MAX_BLOCK
    while bs > 8 and smem_bytes(g, dk, dv, bs) > H100_SMEM_OPTIN_BYTES:
        bs //= 2
    if smem_bytes(g, dk, dv, bs) > H100_SMEM_OPTIN_BYTES:
        raise ValueError(
            f"decode_attention: G={g}, Dk={dk}, Dv={dv} needs "
            f"{smem_bytes(g, dk, dv, bs)} bytes of shared memory even at {bs} positions"
        )
    return bs


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
    global launches
    _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, h, dk = q.shape
    _, s, hkv, dv = v.shape
    g = h // hkv
    if scale is None:
        scale = dk ** -0.5
    for name, t in (("k", k), ("v", v), ("kv_len", kv_len)):
        if t is not None and t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, expected {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q {q.dtype}, k {k.dtype}, v {v.dtype}; the "
                        "kernel takes float32 or bfloat16, all alike")
    if not q.is_contiguous() or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: q must be contiguous and the cache's last "
                         "dimension dense")
    if kv_len is None:
        lens = torch.full((b,), s, dtype=torch.int32, device=q.device)
    elif kv_len.dtype.is_floating_point or kv_len.dtype == torch.bool:
        raise TypeError(f"decode_attention: kv_len is {kv_len.dtype}, expected integers")
    else:
        lens = kv_len.to(torch.int32).contiguous()
    out = torch.empty((b, h, dv), dtype=q.dtype, device=q.device)
    if b == 0 or h == 0:
        return out
    if s == 0:
        raise ValueError("decode_attention: the cache has no positions")
    bs = block_size(g, dk, dv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, hkv, g, s, dk, dv,
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
        float(scale), bs, q.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with CUDA error {err}")
    launches += 1
    return out
