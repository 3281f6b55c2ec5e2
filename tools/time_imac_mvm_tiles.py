#!/usr/bin/env python3
"""Time the `imac_mvm` kernel's three routes against each other on a GPU.

    python3 tools/time_imac_mvm_tiles.py

Builds `kernels/imac_mvm/csrc/imac_mvm.cu` as shipped and launches it
through `ops.launch` with a forced plan, at yi-9b's two FFN shapes, with
bfloat16 activations as the full-width model hands them over and the
serving quantisers (dac_bits 8, levels 16):

1. Where the routes switch. At M in {8, 12, 16, 17, 24, 32, 64, 128, 512,
   2048}: the split-K route (M <= 16: its M buckets end there), the
   integer route (`ops.int8_plan`, at any M) and the 64x64 tile (M bucket
   0, at any M), each checked against the plain version once and timed
   over REPS launches (CUDA events) in the order A B C C B A, the route
   `ops.plan_for` takes marked, with the bytes bound beside them.
2. For the split-K route at M = 4 and 12 (its plan, which at M = 12 the
   serving quantisers no longer take), where the time goes:
   * every candidate launch plan of `ops.splitk_candidates` (column tile,
     K splits, resident blocks, waves and how full they are), the chosen
     one marked, so the plan's choice can be held against the alternatives;
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

FFN = ((4096, 11008), (11008, 4096))
SWITCH_MS = (8, 12, 16, 17, 24, 32, 64, 128, 512, 2048)
SPLITK_SHAPES = [(m, k, n) for m in (4, 12) for k, n in FFN]
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


def operands(gen, m, k, n):
    import torch

    x = torch.empty((m, k), device="cuda").uniform_(-0.1, 1.1, generator=gen)
    w = torch.empty((k, n), device="cuda").uniform_(-1.1, 1.1, generator=gen)
    return x.to(torch.bfloat16), w


def switch_over(gen) -> None:
    """Part 1: the three routes at every M of SWITCH_MS."""
    import torch
    from repro_torch.kernels.imac_mvm import ops, ref

    tile64 = ops.Plan("tile64", 0, 0, 0, 0, 0, 0)
    for k, n in FFN:
        for m in SWITCH_MS:
            x, w = operands(gen, m, k, n)
            chosen = ops.plan_for(x, w)
            routes = {"int8": ops.int8_plan(m, k, n, ops.device_int8_clusters(0)),
                      "tile64": tile64}
            if m <= ops.M_BUCKETS[-1]:     # clip-only quantisers: the split-K plan
                routes = {"split-K": ops.plan_for(x, w, dac_bits=0, levels=1), **routes}
            want = ref.imac_mvm_ref(x, w)
            atol = 1e-6 * k * float(x.float().abs().max()) * float(w.abs().max())
            for tag, plan in routes.items():
                got = ops.launch(x, w, plan)
                torch.cuda.synchronize()
                if not torch.allclose(got, want, rtol=1e-5, atol=atol):
                    raise AssertionError(f"{tag} M={m} K={k} N={n}: differs from the plain version")
            reps = 10 if m >= 512 else REPS
            times = {tag: [] for tag in routes}
            for tag in (*routes, *reversed(routes)):
                times[tag].append(time_ms(lambda: ops.launch(x, w, routes[tag]), reps))
            bound_ms = 1e3 * (2 * m * k + 4 * k * n + 4 * m * n) / HBM_BYTES_PER_S
            print(f"switch M={m} K={k} N={n} bf16 x: " + ", ".join(
                f"{tag}{'*' if plan.route == chosen.route else ''} "
                f"{' / '.join(f'{t:.4f}' for t in times[tag])} ms"
                for tag, plan in routes.items())
                + f"; bound {bound_ms:.4f} ms (bytes); int8 plan {tuple(routes['int8'])}",
                flush=True)
    print("(* marks the route ops.plan_for takes)", flush=True)


def splitk_detail(gen) -> None:
    """Part 2: the split-K route's candidate plans and quantiser costs."""
    from repro_torch.kernels.imac_mvm import ops

    for m, k, n in SPLITK_SHAPES:
        x, w = operands(gen, m, k, n)
        plan = ops.plan_for(x, w, dac_bits=0, levels=1)
        print(f"split-K M={m} K={k} N={n} bf16 x: plan {tuple(plan)}", flush=True)
        for cand in ops.splitk_candidates(m, k, n, ops.device_clusters(0, True, True)):
            fill = cand.blocks / (cand.waves * cand.resident)
            print(f"  plan bn={cand.bn:3d} splits={cand.splits} blocks={cand.blocks:4d} "
                  f"resident={cand.resident:3d} waves={cand.waves} fill={fill:.3f}: "
                  f"{time_ms(lambda: ops.launch(x, w, cand)):.4f} ms"
                  f"{'  <- chosen' if cand == plan else ''}", flush=True)
        quant = {f"dac_bits {b} levels {lv}": time_ms(
                     lambda: ops.launch(x, w, plan, dac_bits=b, levels=lv))
                 for b, lv in ((8, 16), (0, 16), (8, 1), (0, 1))}
        quant["w.sum(0)"] = time_ms(lambda: w.sum(0))
        print("  " + ", ".join(f"{key} {t:.4f} ms" for key, t in quant.items()), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_imac_mvm_tiles: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    switch_over(gen)
    splitk_detail(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
