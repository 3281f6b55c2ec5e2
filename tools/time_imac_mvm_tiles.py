#!/usr/bin/env python3
"""Time the `imac_mvm` kernel's two tile shapes against each other on a GPU.

    python3 tools/time_imac_mvm_tiles.py

Builds `kernels/imac_mvm/csrc/imac_mvm.cu` twice: as shipped (the skinny
16x32x64 tile for M <= 16) and with ``-DIMAC_MVM_SKINNY_MAX_M=0`` (the
64x64x16 tile for every M). At the serving path's row counts (M = 4 at
decode, 12 at the longest prefill) and yi-9b's FFN shapes, with bfloat16
activations as the full-width model hands them over, it checks both
builds against the plain version and prints each one's mean device time
over 50 launches (CUDA events), the two builds timed in the order
A B B A. The first line is the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [(m, k, n) for m in (4, 12) for k, n in ((4096, 11008), (11008, 4096))]
REPS = 50


def nvcc_job(tag: str, defines: "list[str]") -> "tuple[list[str], Path]":
    """The nvcc command of one build variant, and its library path."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"libimac_mvm-tiles-{tag}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-o", str(out),
           str(_build.source("imac_mvm"))]
    return cmd, out


def main() -> int:
    import torch
    from repro_torch.kernels.imac_mvm import ops, ref

    if not torch.cuda.is_available():
        print("time_imac_mvm_tiles: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    variants = {"skinny<=16": [], "64x64 only": ["-DIMAC_MVM_SKINNY_MAX_M=0"]}
    jobs = {tag: nvcc_job(tag.split()[0].replace("<=", "le"), d) for tag, d in variants.items()}
    procs = {tag: subprocess.Popen(cmd) for tag, (cmd, _) in jobs.items()}
    if any(p.wait() != 0 for p in procs.values()):
        raise RuntimeError("nvcc failed")
    libs = {}
    for tag, (_, out) in jobs.items():
        lib = ctypes.CDLL(str(out))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.imac_mvm_launch.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, i32, i32,
                                        ctypes.c_float, i32, ptr]
        lib.imac_mvm_launch.restype = ctypes.c_int
        libs[tag] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    dac_n, levels, step = ops.quant_args(8, 16)
    for m, k, n in SHAPES:
        x = torch.empty((m, k), device="cuda").uniform_(-0.1, 1.1, generator=gen)
        x = x.to(torch.bfloat16)
        w = torch.empty((k, n), device="cuda").uniform_(-1.1, 1.1, generator=gen)
        y = torch.empty((m, n), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def launch(lib):
            err = lib.imac_mvm_launch(x.data_ptr(), 1, w.data_ptr(), y.data_ptr(), m, k, n,
                                      dac_n, levels, step, 0, stream)
            if err != 0:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        want = ref.imac_mvm_ref(x, w)
        atol = 1e-6 * k * float(x.float().abs().max()) * float(w.abs().max())
        for tag, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            if not torch.allclose(y, want, rtol=1e-5, atol=atol):
                raise AssertionError(f"{tag} M={m} K={k} N={n}: differs from the plain version")
        times = {tag: [] for tag in libs}
        for tag in (*libs, *reversed(libs)):
            lib = libs[tag]
            launch(lib)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                launch(lib)
            end.record()
            end.synchronize()
            times[tag].append(start.elapsed_time(end) / REPS)
        print(f"M={m} K={k} N={n} bf16 x: " + ", ".join(
            f"{tag} {' / '.join(f'{t:.4f}' for t in ts)} ms" for tag, ts in times.items()),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
