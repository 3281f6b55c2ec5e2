#!/usr/bin/env python3
"""Time testIMAC (the paper's Algorithm 1) of one source tree on a GPU.

    python3 tools/time_testimac.py [--src DIR] [--runs 3]

Imports `repro_torch` from DIR (default: this checkout's `src`), so that
two trees can be compared on one card in one run (e.g. a parent commit
unpacked with `git archive` into a gitignored directory beside this one,
run in the order parent, change, change, parent). Builds that tree's
`tridiag` and `gs_fused` kernels, trains the 400x120x84x10 sigmoid MLP on
the card (500 steps, the synthetic digits of seed 0) and runs `test_imac`
as `chip_smoke.py`'s `[main]` does: MRAM 32x32 arrays, 500 samples, chunk
256, once per solver backend ("tridiag", "fused"). Per backend: one
warm-up run, `--runs` timed runs (host wall, ending in a synchronize) and
one profiled run (device busy time from torch.profiler; the idle share is
1 - busy / the mean untimed wall).

Prints the card's name and power limit, then one JSON line:
{"src", "backends": {name: {"wall_ms": [...], "samples_per_s": [...],
 "device_ms", "idle_share", "accuracy", "avg_power", "sweeps", "launches",
 "residual_reads", "kernels": {name: ms}}}}. `residual_reads` (host reads
of the residual per run) is null for a tree whose solver does not count them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SAMPLES, CHUNK = 500, 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_testimac: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.imac_mnist import TOPOLOGY
    from repro_torch.core import solver
    from repro_torch.core.digital import train_mlp
    from repro_torch.core.evaluate import test_imac
    from repro_torch.core.imac import IMACConfig
    from repro_torch.core.solver import SolveOptions
    from repro_torch.data.digits import train_test_split
    from repro_torch.kernels import _build
    from repro_torch.kernels.gs_fused import ops as fused_ops
    from repro_torch.kernels.tridiag import ops as tridiag_ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build(("tridiag", "gs_fused"))
    xtr, ytr, xte, yte = train_test_split(4000, SAMPLES, seed=0, noise=0.4)
    params = train_mlp(TOPOLOGY, xtr, ytr, steps=500)
    cfg = IMACConfig(tech="MRAM", array_rows=32, array_cols=32)

    counts_reads = hasattr(solver, "residual_reads")
    out = {}
    for backend in ("tridiag", "fused"):
        def run():
            return test_imac(params, xte, yte, cfg, n_samples=SAMPLES, chunk=CHUNK,
                             solve_options=SolveOptions(backend=backend))

        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.runs):
            tridiag_ops.launches = fused_ops.launches = 0
            if counts_reads:
                solver.residual_reads = 0
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        launches = dict(tridiag=tridiag_ops.launches, gs_fused=fused_ops.launches)
        reads = solver.residual_reads if counts_reads else None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        busy = sum(kernels.values())
        mean_wall = sum(walls) / len(walls)
        out[backend] = {
            "wall_ms": walls, "samples_per_s": [1e3 * SAMPLES / w for w in walls],
            "device_ms": busy, "idle_share": 1 - busy / mean_wall,
            "accuracy": res.accuracy, "avg_power": res.avg_power, "sweeps": list(res.sweeps),
            "launches": launches, "residual_reads": reads,
            "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6]),
        }
    print(json.dumps({"src": args.src, "backends": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
