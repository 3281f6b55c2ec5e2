#!/usr/bin/env python3
"""Time the `decode_attention` kernel's launch plans against each other on a GPU.

    python3 tools/time_decode_attention_plans.py

Builds `kernels/decode_attention/csrc/decode_attention.cu` as shipped and,
at the shapes `chip_smoke.py` times (Hkv=4, G=8, D=128: B=32 at S=8192 and
4096 with full lengths, B=4 at S=256 with full lengths and with the
serving path's lengths 9-28), in bfloat16, launches it
  * with the plan of `ops.plan_for` (the split-KV route) and with the rows
    route (one block per (batch, KV-head) row), timed in the order A B B A,
    each checked against the plain version (within 1e-2 |want| plus
    1e-3 of the row's largest |want|);
  * with every candidate plan of `ops.split_candidates` (splits, positions
    per split, blocks, resident blocks, waves), the chosen one marked, so
    the plan's choice can be held against the alternatives;
and prints `scaled_dot_product_attention` on the same inputs and the
bytes-bound time beside them. Each time is the mean device time over 50
launches (CUDA events). The first line is the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HKV, G, D = 4, 8, 128
CASES = [(32, 8192, "full"), (32, 4096, "full"), (4, 256, "full"), (4, 256, "serving")]
REPS = 50
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device time of `fn` over `reps` calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref

    if not torch.cuda.is_available():
        print("time_decode_attention_plans: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    index = torch.cuda.current_device()
    for b, s, kind in CASES:
        q = torch.randn((b, HKV * G, D), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, HKV, D), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, HKV, D), generator=gen, device="cuda").to(torch.bfloat16)
        if kind == "full":
            lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        else:
            lens = torch.randint(9, 29, (b,), generator=gen, device="cuda", dtype=torch.int32)
        want = ref.decode_attention_ref(q, k, v, lens).float()
        tol = 1e-2 * want.abs() + 1e-3 * want.abs().amax(-1, keepdim=True)
        plan = ops.plan_for(q, k, v)
        rows = ops.Plan("rows", 0, 0, b * HKV)
        for p in (plan, rows):
            err = (ops.launch(q, k, v, lens, p).float() - want).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(f"B={b} S={s} {p.route}: max abs error {float(err.max()):.3g}")
        a1 = time_ms(lambda: ops.launch(q, k, v, lens, plan))
        r1 = time_ms(lambda: ops.launch(q, k, v, lens, rows))
        r2 = time_ms(lambda: ops.launch(q, k, v, lens, rows))
        a2 = time_ms(lambda: ops.launch(q, k, v, lens, plan))
        q4, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        mask = torch.arange(s, device="cuda")[None, None, None, :] < lens[:, None, None, None]
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                                              enable_gqa=True))
        valid = int(lens.clamp(max=s).sum())
        nbytes = k.element_size() * (valid * HKV * 2 * D + 2 * b * HKV * G * D) + 4 * b
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        print(f"bfloat16 B={b} S={s} {kind} lengths: split-KV {a1:.4f} / {a2:.4f} ms, "
              f"rows route {r1:.4f} / {r2:.4f} ms, scaled_dot_product_attention {sdpa:.4f} "
              f"ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB); plan {tuple(plan)}")
        for p in ops.split_candidates(b * HKV, s, ops.SPLIT_TILE, ops.device_clusters(index, D)):
            ms = time_ms(lambda: ops.launch(q, k, v, lens, p))
            mark = " <- chosen" if p == plan else ""
            print(f"    splits {p.splits} chunk {p.chunk}: {p.blocks} blocks, resident "
                  f"{p.resident}, waves {p.waves}: {ms:.4f} ms{mark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
