#!/usr/bin/env python3
"""Time the `imac_mvm` kernel's two routes against each other on a GPU.

    python3 tools/time_imac_mvm_tiles.py

Builds `kernels/imac_mvm/csrc/imac_mvm.cu` as shipped and launches it
two ways: with the launch plan of `ops.plan_for` (the split-K
weight-streaming route for M <= 16) and with M bucket 0 (the 64x64x16
tile, which the kernel takes at any M). At the serving path's row counts
(M = 4 at decode, 12 at the longest prefill) and yi-9b's FFN shapes, with
bfloat16 activations as the full-width model hands them over, it checks
both routes against the plain version and prints each one's mean device
time over 50 launches (CUDA events), the two routes timed in the order
A B B A, with the bytes-bound time beside them.

Then, for the split-K route at each shape, where the time goes:
  * every candidate plan of `ops.splitk_candidates` (column tile, K
    splits, resident blocks, waves and how full they are), the chosen one
    marked, so the plan's choice can be held against the alternatives;
  * the chosen plan with the quantisers reduced to clipping (dac_bits 0,
    levels 1; no division), once for x, once for w and once for both;
  * ``w.sum(0)``, a PyTorch call that streams the same 180 MB of w.

The first line is the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [(m, k, n) for m in (4, 12) for k, n in ((4096, 11008), (11008, 4096))]
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
    from repro_torch.kernels.imac_mvm import ops, ref

    if not torch.cuda.is_available():
        print("time_imac_mvm_tiles: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = ops._lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dac_n, levels, step = ops.quant_args(8, 16)
    for m, k, n in SHAPES:
        x = torch.empty((m, k), device="cuda").uniform_(-0.1, 1.1, generator=gen)
        x = x.to(torch.bfloat16)
        w = torch.empty((k, n), device="cuda").uniform_(-1.1, 1.1, generator=gen)
        y = torch.empty((m, n), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        plan = ops.plan_for(x, w)
        tile64 = ops.Plan("tile64", 0, 0, 0, 0, 0, 0)

        def launch(c):
            err = lib.imac_mvm_launch(x.data_ptr(), 1, w.data_ptr(), y.data_ptr(), m, k, n,
                                      dac_n, levels, step, c.m_bucket, c.bn, c.splits,
                                      c.k_chunk, c.x_rows, 0, stream)
            if err != 0:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        want = ref.imac_mvm_ref(x, w)
        atol = 1e-6 * k * float(x.float().abs().max()) * float(w.abs().max())
        routes = {"split-K": plan, "64x64 tile": tile64}
        for tag, c in routes.items():
            launch(c)
            torch.cuda.synchronize()
            if not torch.allclose(y, want, rtol=1e-5, atol=atol):
                raise AssertionError(f"{tag} M={m} K={k} N={n}: differs from the plain version")
        times = {tag: [] for tag in routes}
        for tag in (*routes, *reversed(routes)):
            times[tag].append(time_ms(lambda: launch(routes[tag])))
        bound_ms = 1e3 * (2 * m * k + 4 * k * n + 4 * m * n) / HBM_BYTES_PER_S
        print(f"M={m} K={k} N={n} bf16 x: " + ", ".join(
            f"{tag} {' / '.join(f'{t:.4f}' for t in ts)} ms" for tag, ts in times.items())
            + f"; bound {bound_ms:.4f} ms (bytes); plan {tuple(plan)}", flush=True)

        for cand in ops.splitk_candidates(m, k, n, ops.device_clusters(0, True, True)):
            fill = cand.blocks / (cand.waves * cand.resident)
            print(f"  plan bn={cand.bn:3d} splits={cand.splits} blocks={cand.blocks:4d} "
                  f"resident={cand.resident:3d} waves={cand.waves} fill={fill:.3f}: "
                  f"{time_ms(lambda: launch(cand)):.4f} ms{'  <- chosen' if cand == plan else ''}",
                  flush=True)
        quant = {f"dac_bits {b} levels {lv}": time_ms(
                     lambda: ops.imac_mvm_2d(x, w, dac_bits=b, levels=lv))
                 for b, lv in ((8, 16), (0, 16), (8, 1), (0, 1))}
        quant["w.sum(0)"] = time_ms(lambda: w.sum(0))
        print("  " + ", ".join(f"{key} {t:.4f} ms" for key, t in quant.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
