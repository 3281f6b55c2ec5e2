#!/usr/bin/env python3
"""Time the phases of the `tridiag` kernel at layer 1 of testIMAC on a GPU.

    python3 tools/time_tridiag_phases.py

Builds copies of `kernels/tridiag/csrc/tridiag.cu` with one phase taken
out, each into its own library under build/tridiag_phases/, and times
each, through the shipped wrapper, on the "tridiag" backend's own row
(N=30) and column (N=31) operands and on four dense operands at layer 1
(256 samples x 104 tiles of 31x30):

- kernel: the shipped source;
- stage + write back: the solve taken out;
- solve + write back: the operands not loaded (shared memory filled with
  1.0 by the same loops, so the solve meets no special values);
- solve: as above, and x not written back.

The phases overlap across the blocks of an SM, so they do not add up to
the kernel's time. Prints the card's name and power limit, then one line
per variant with its times (ms, CUDA events over 50 launches).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

NO_SOLVE = ("    if (mine) {\n      const int o = tid;", "    if (false) {\n      const int o = tid;")
NO_LOADS = ("          cp_async4(ms + e * spad + k, gp);", "          ms[e * spad + k] = 1.0f;")
NO_WRITE_BACK = ("    move_slabs<false>(p, kX, p.x, smem + kSlotX * slot_floats, base[kX], count);", "")
VARIANTS = {
    "kernel": (),
    "stage + write back": (NO_SOLVE,),
    "solve + write back": (NO_LOADS,),
    "solve": (NO_LOADS, NO_WRITE_BACK),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_tridiag_phases: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.imac import IMACConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.tridiag import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    source = _build.source("tridiag").read_text()
    out = ROOT / "build" / "tridiag_phases"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = out / f"tridiag_{i}.cu"
        cu.write_text(text)
        lib = out / f"libtridiag_{i}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        libs[name] = ctypes.CDLL(str(lib))

    gen = torch.Generator(device="cuda").manual_seed(0)
    cp = IMACConfig().circuit_params(cs.M_L1, cs.N_L1)
    g, _ = cs._random_tiles(gen, (cs.TILES_L1,), cs.M_L1, cs.N_L1)
    g = g[None]
    v = 0.8 * torch.rand((cs.CHUNK, cs.TILES_L1, cs.M_L1), generator=gen, device="cuda")
    row, col = cs.backend_systems(g, v, cp)
    shape = (cs.CHUNK * cs.TILES_L1 * cs.M_L1, cs.N_L1)
    d = 2.0 + torch.rand(shape, generator=gen, device="cuda")
    off = -0.5 * torch.rand((2,) + shape, generator=gen, device="cuda")
    dense = (off[0], d, off[1], torch.randn(shape, generator=gen, device="cuda"))

    shipped = ops._lib
    argtypes = shipped().tridiag_launch.argtypes
    try:
        for name, lib in libs.items():
            lib.tridiag_launch.argtypes = argtypes
            lib.tridiag_launch.restype = ctypes.c_int
            ops._lib = lambda lib=lib: lib
            times = {label: cs.time_ms(lambda s=s: ops.tridiag(*s), reps=50)
                     for label, s in (("row", row), ("column", col), ("dense", dense))}
            print(f"{name}: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in times.items()), flush=True)
    finally:
        ops._lib = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
