#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of IMAC-Sim (`src/repro_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds the four CUDA kernels from the sources in this checkout (nvcc,
into build/repro_torch/) and holds each against its plain torch version
at the shapes of its path (`imac_mvm` on all three of its routes: the
exact integer tensor-core route for M >= 9 with integer quantisers, also
bit for bit against its exact plain version; otherwise split-K for
M <= 16 and the 64x64 tile above). Then it drives both main paths:

- testIMAC on the paper's 400x120x84x10 sigmoid MLP on MRAM 32x32
  arrays, 500 test samples, once per solver backend (the `tridiag` and
  `gs_fused` kernels), checked against the port's own CPU result;
- the LM substrate's analog serving path, yi-9b at full width with
  ``analog_mvm`` (the `imac_mvm` and `decode_attention` kernels): 6
  requests over 4 slots; then decode ticks at long context (32 slots of
  a 4096-position cache, lengths 2048-4096: every FFN projection on the
  integer route at M = 32), profiled; then the reduced model on the card
  against the CPU with the same weights, once with the launcher's
  prompts and once with a 24-token prompt.

Any failure exits non-zero. The last line of output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

preceded by the card's name and power limit and, before that, one JSON
line with each kernel's launches, error, times and bound.

Imports torch, numpy and repro_torch only.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Card peaks used for the bounds (H100 SXM data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12

# The serving path: yi-9b (K, N) of the FFN projections, the launcher's defaults.
YI_FFN = ((4096, 11008), (11008, 4096))
SERVE = dict(requests=6, slots=4, cache_len=256, max_tokens=16)

# Main-path shapes: layer 1 of the 400x120x84x10 MLP on 32x32 arrays is
# 13x4 tiles of 31x30, x2 for G+/G-, over a chunk of 256 samples.
CHUNK = 256
TILES_L1 = 104
M_L1, N_L1 = 31, 30
SWEEPS_L1 = 48


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def traced_kernels(fn, reps: int = 1) -> "dict[str, tuple[int, float]]":
    """Trace `reps` calls of `fn` with torch.profiler: {kernel name: (calls,
    device ms)} of the device kernels that took time (empty when the trace
    holds no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and getattr(e, "self_device_time_total", 0) > 0}


def device_ms(fn, reps: int) -> "float | None":
    """Mean device time of `fn` over `reps` calls after one warm-up call:
    the sum of its kernels' device times in a torch.profiler trace (None
    when the trace holds none). Unlike `time_ms` it leaves out the host's
    launch time, which bounds a call whose kernels take a few microseconds."""
    import torch

    fn()
    torch.cuda.synchronize()
    kernels = traced_kernels(fn, reps)
    return sum(ms for _, ms in kernels.values()) / reps if kernels else None


def kernel_name(name: str) -> str:
    """A profiler kernel name, shortened to the port's kernel function."""
    import re

    found = re.search(r"(imac_mvm|decode_attention|tridiag|gs_fused)\w*", name)
    return found.group(0) if found else name[:40]


def shown_ms(ms: "float | None") -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check_close(name, got, want, *, rtol, atol) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; max error."""
    import torch

    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol={rtol} atol="
            f"{float(torch.as_tensor(atol).max()):.3g}; max abs error {float(err.max()):.3g}"
        )
    return float(err.max())


def bound_of(bytes_moved: float, flops: float,
             ops_per_s: float = FP32_FLOPS_PER_S) -> "tuple[float, str]":
    """The least time (ms) the card could take, and which of the two bounds
    it: the bytes at the memory rate, the operations at `ops_per_s` (the
    fp32 CUDA-core rate unless the work runs at another's)."""
    t_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / ops_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_summary(report: str) -> "list[str]":
    """One line per kernel of an `nvcc -Xptxas -v` report: its name
    (demangled with cu++filt where the toolkit has it), registers, spills."""
    import re
    import shutil

    entries, entry, spill = [], None, ""
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = f"spills {m.group(1)} B stored, {m.group(2)} B loaded"
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            entries.append((entry, f"{m.group(1)} registers, {spill}"))
            entry, spill = None, ""
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    names = [e for e, _ in entries]
    if names and Path(filt).exists():
        out = subprocess.run([filt, *names], capture_output=True, text=True).stdout.splitlines()
        if len(out) == len(names):
            names = out
    return [f"{name}: {info}" for name, (_, info) in zip(names, entries)]


def phase_device():
    import torch
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc_version = subprocess.run(
        [_build.nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log(f"[device] {smi} | torch {torch.__version__} | torch.version.cuda {torch.version.cuda}")
    log(f"[device] nvcc: {nvcc_version}")
    seconds, reports = _build.build_all(ptxas_verbose=True)
    for name, report in reports.items():
        for line in ptxas_summary(report):
            log(f"[build] {name}: {line}")
    log(f"[build] kernels built and loaded in {seconds:.2f} s")
    return smi


def _random_tiles(gen, lead, m, n):
    import torch
    from repro_torch.core.devices import MRAM

    g = torch.empty(lead + (m, n), device="cuda").uniform_(MRAM.g_off, MRAM.g_on, generator=gen)
    v = 0.8 * torch.rand(lead + (m,), generator=gen, device="cuda")
    return g, v


def backend_systems(g, v, cp):
    """The (dl, d, du, b) of the first row and column half-sweeps of the
    "tridiag" backend's `_sweep_solve` on tiles g (..., M, N) driven by v,
    captured as the backend hands them to its inner solve."""
    import dataclasses

    from repro_torch.core.solver import SolveOptions, solve_crossbar
    from repro_torch.kernels.tridiag import ops

    captured = []

    def capture(*system):
        captured.append(system)
        return ops.tridiag(*system)

    solve_crossbar(g, v, dataclasses.replace(cp, gs_iters=1, tol=0.0),
                   options=SolveOptions(backend=capture))
    return captured[0], captured[1]


def tridiag_bytes(system) -> int:
    """Bytes a solve must move: each operand's distinct elements read once
    (a stride-0 axis holds one), x written once."""
    import torch

    shape = torch.broadcast_shapes(*(t.shape for t in system))
    distinct = sum(math.prod(size for size, stride in zip(shape, t.expand(shape).stride())
                             if stride != 0) for t in system)
    return 4 * (distinct + math.prod(shape))


def phase_tridiag(gen, cp):
    """The tridiag kernel against its plain version on the "tridiag"
    backend's own operands (views: stride-0 coefficients, transposed column
    systems), per-config coefficients, ragged, N = 1, N = 401 (past the
    on-chip limit) and dense operands; the trace of one call holds only the
    kernel; times beside the bounds; one layer-1 sweep's device time."""
    import dataclasses

    import torch
    from repro_torch.core.solver import SolveOptions, solve_crossbar
    from repro_torch.kernels.tridiag import ops, ref

    # Layer 1's chunk as linear_forward hands it over: tiles shared by the
    # samples (a stride-0 sample axis), one drive per sample and tile.
    g, _ = _random_tiles(gen, (TILES_L1,), M_L1, N_L1)
    g = g[None]
    v = 0.8 * torch.rand((CHUNK, TILES_L1, M_L1), generator=gen, device="cuda")
    row, col = backend_systems(g, v, cp)

    # Per-config circuit scalars, the stacked-sweep shape (C, 1, T, M, N).
    lead = (4,)
    r_wire = torch.empty(lead, device="cuda").uniform_(5.0, 40.0, generator=gen)
    cp_c = dataclasses.replace(
        cp, r_row=r_wire, r_col=r_wire,
        r_source=torch.empty(lead, device="cuda").uniform_(80.0, 150.0, generator=gen))
    g_c, _ = _random_tiles(gen, lead + (1, 16), M_L1, N_L1)
    v_c = 0.8 * torch.rand(lead + (64, 16, M_L1), generator=gen, device="cuda")
    row_c, col_c = backend_systems(g_c, v_c, cp_c)

    # The Table III 512x512 configuration's layer 1: a 401x120 tile, whose
    # column systems (N = 401) are past the on-chip limit.
    g_big, _ = _random_tiles(gen, (1, 2), 401, 120)
    v_big = 0.8 * torch.rand((16, 2, 401), generator=gen, device="cuda")
    row_big, col_big = backend_systems(g_big, v_big, cp)

    def diag_dominant(shape):
        d = 2.0 + torch.rand(shape, generator=gen, device="cuda")
        off = -0.5 * torch.rand((2,) + shape, generator=gen, device="cuda")
        return off[0], d, off[1], torch.randn(shape, generator=gen, device="cuda")

    dense = diag_dominant((CHUNK * TILES_L1 * M_L1, N_L1))
    # Sliced and permuted views: slabs that are not one run of memory.
    dl_s, d_s, du_s, b_s = diag_dominant((9, 64, 200, 30))
    strided = (dl_s[:, ::2].permute(1, 0, 2, 3), d_s[:, ::2].permute(1, 0, 2, 3)[..., :1, :],
               du_s[0, ::2, 0, :][:, None, None, :], b_s[:, ::2].permute(1, 0, 2, 3))
    cases = [("row N=30 (backend)", row), ("col N=31 (backend)", col),
             ("row N=30 (C,) per-config", row_c), ("col N=31 (C,) per-config", col_c),
             ("row N=120 (401x120 tile)", row_big), ("col N=401 (401x120 tile)", col_big),
             ("ragged B=1003 N=7", diag_dominant((1003, 7))), ("N=1 B=5", diag_dominant((5, 1))),
             ("dense (825344, 30)", dense), ("sliced and permuted (32, 9, 200, 30)", strided)]
    lib = ops._lib()
    built = (lib.tridiag_threads(), lib.tridiag_max_axes(), lib.tridiag_max_slabs(),
             lib.tridiag_static_smem_bytes())
    if built != (ops.THREADS, ops.MAX_AXES, ops.MAX_SLABS, ops.STATIC_SMEM_BYTES):
        raise AssertionError(f"tridiag: the wrapper's block constants disagree with the kernel's {built}")
    max_err = 0.0
    plans = {}
    for label, system in cases:
        shape = torch.broadcast_shapes(*(t.shape for t in system))
        x_like = torch.empty_like(system[3]) if system[3].shape == shape else torch.empty(shape)
        layout = ops.kernel_layout(shape, (*system, x_like))
        plan = plans[label] = ops.launch_plan(*layout, shape[-1])
        before = ops.launches
        got = ops.tridiag(*system)
        want = ref.tridiag_ref(*system)
        torch.cuda.synchronize()
        if ops.launches != before + 1:
            raise AssertionError(f"tridiag {label}: {ops.launches - before} launches, expected 1")
        atol = 1e-6 * float(want.abs().max())
        err = check_close(f"tridiag {label}", got, want, rtol=1e-5, atol=atol)
        max_err = max(max_err, err)
        log(f"[tridiag] {label}: shape {tuple(shape)}, strides "
            f"{[tuple(t.stride()) for t in system]} -> x {tuple(got.stride())}; merged axes "
            f"{layout[0]}; plan S={plan.systems} P={plan.slabs} dense_off {plan.dense_off} contig "
            f"{plan.contig} grid "
            f"{plan.grid} smem {plan.smem_bytes} B {'on chip' if plan.on_chip else 'workspace'}; "
            f"max abs err {err:.3g} (rtol 1e-5, atol {atol:.3g})")
    for label in ("row N=30 (backend)", "col N=31 (backend)", "dense (825344, 30)"):
        if not plans[label].on_chip:
            raise AssertionError(f"tridiag {label}: the multipliers left the chip")
    if plans["col N=401 (401x120 tile)"].on_chip:
        raise AssertionError("tridiag N=401: expected the workspace instance")
    if col[3].stride()[-2] != 1 or row[3].stride()[-1] != 1:
        raise AssertionError("the backend's right-hand sides are not in (..., M, N) order")

    out = {}
    for label, system in (("row", row), ("col", col)):
        # No copy and no workspace: the call allocates x and launches one kernel.
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        x = ops.tridiag(*system)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base - x.untyped_storage().nbytes()
        del x
        kernels = traced_kernels(lambda: ops.tridiag(*system))
        if len(kernels) != 1 or "tridiag" not in next(iter(kernels)) \
                or next(iter(kernels.values()))[0] != 1:
            raise AssertionError(f"tridiag {label}: the trace of one call holds {kernels}")
        if extra > 2 * 1024 * 1024:
            raise AssertionError(f"tridiag {label}: {extra} bytes allocated besides x")
        log(f"[tridiag] {label}: one call's trace holds only {kernel_name(next(iter(kernels)))} "
            f"(1 launch); nothing allocated besides x ({extra} B)")

    for label, system in (("row N=30 (backend)", row), ("col N=31 (backend)", col),
                          ("dense (825344, 30)", dense)):
        shape = torch.broadcast_shapes(*(t.shape for t in system))
        n = shape[-1]
        nodes = math.prod(shape)
        ms = time_ms(lambda: ops.tridiag(*system), reps=50)
        dev = device_ms(lambda: ops.tridiag(*system), reps=10)
        plain_ms = time_ms(lambda: ref.tridiag_ref(*system), reps=3)
        bytes_moved = tridiag_bytes(system)
        flops = 8 * nodes                    # 6 forward, 2 backward per node
        bound_ms, bound_by = bound_of(bytes_moved, flops)
        out[label] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, n=n, systems=nodes // n)
        log(f"[tridiag] time {label}: {nodes // n} systems of N={n}: kernel {ms:.4f} ms "
            f"(device {shown_ms(dev)}), {bytes_moved / ms / 1e9:.3f} TB/s; plain {plain_ms:.3f} "
            f"ms; bound {bound_ms:.4f} ms ({bound_by}: {bytes_moved / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP), {bound_ms / ms:.1%} of it")

    # One layer-1 sweep of the backend, on the device: a 48-sweep solve of
    # the chunk (plus its final row and column solve), over 49.
    cp48 = dataclasses.replace(cp, gs_iters=SWEEPS_L1, tol=0.0)
    parts = traced_kernels(lambda: solve_crossbar(g, v, cp48, options=SolveOptions(backend="tridiag")))
    busy = sum(ms for _, ms in parts.values())
    if busy:
        tri = sum(ms for name, (_, ms) in parts.items() if "tridiag" in name)
        sweep_ms = busy / (SWEEPS_L1 + 1)
        log(f"[tridiag] layer-1 sweep of the \"tridiag\" backend (256 x 104 tiles of 31x30): "
            f"device {sweep_ms:.4f} ms a sweep ({busy:.2f} ms for {SWEEPS_L1} sweeps + the "
            f"final one); tridiag kernel {tri / busy:.1%}, {len(parts)} kernel names")
        for name, (calls, ms) in sorted(parts.items(), key=lambda kv: -kv[1][1])[:8]:
            log(f"[tridiag]   {ms:9.3f} ms {ms / busy:6.1%} {calls:5d} calls  {name[:80]}")
    else:
        sweep_ms = None
        log("[tridiag] layer-1 sweep: the trace holds no device time (not measured)")
    out["sweep_device_ms"] = sweep_ms
    return max_err, out


def phase_gs_fused(gen, cp):
    """The gs_fused kernel against its plain version; the fallback past the limit."""
    import dataclasses

    import torch
    from repro_torch.core.solver import SolveOptions, Stamps, solve_crossbar
    from repro_torch.kernels.gs_fused import ops, ref
    from repro_torch.kernels.tridiag import ops as tridiag_ops

    lib_bytes = ops._lib().gs_fused_smem_bytes(M_L1, N_L1)
    if lib_bytes + ops.SMEM_STATIC_BYTES != ops.smem_bytes(M_L1, N_L1):
        raise AssertionError(f"shared-memory formula disagrees with the kernel: {lib_bytes}")
    limit = ops.smem_limit(torch.device("cuda"))
    log(f"[gs_fused] opt-in shared memory per block {limit} B; a {M_L1}x{N_L1} tile "
        f"needs {ops.smem_bytes(M_L1, N_L1)} B")

    def compare(label, args, sweeps, res_atol):
        vr, vc, res = ops.gs_fused(*args, sweeps=sweeps)
        rvr, rvc, rres = ref.gs_fused_ref(*args, sweeps=sweeps)
        torch.cuda.synchronize()
        errs = [
            check_close(f"gs_fused {label} vr", vr, rvr, rtol=1e-4, atol=1e-7),
            check_close(f"gs_fused {label} vc", vc, rvc, rtol=1e-4, atol=1e-7),
            check_close(f"gs_fused {label} res", res, rres, rtol=1e-4, atol=res_atol),
            check_close(f"gs_fused {label} i_out", cp.g_tia * vc[:, -1, :],
                        cp.g_tia * rvc[:, -1, :], rtol=1e-4, atol=1e-9),
        ]
        log(f"[gs_fused] {label}: {args[0].shape[0]} systems of {tuple(args[0].shape[1:])}, "
            f"{sweeps} sweeps: max abs err vr {errs[0]:.3g} vc {errs[1]:.3g} res {errs[2]:.3g} "
            f"i_out {errs[3]:.3g}")
        return max(errs)

    g, v = _random_tiles(gen, (CHUNK, TILES_L1), M_L1, N_L1)
    _, args = ops.prepare(g, v, cp)
    # After 48 sweeps the residual is at the rounding level of the
    # voltages (at most the 0.8 V drive); hold it to 64 ulps of that, and
    # strictly after 3 sweeps.
    res_atol = 64 * torch.finfo(torch.float32).eps * 0.8
    max_err = compare("main", args, SWEEPS_L1, res_atol)
    max_err = max(max_err, compare("main, 3 sweeps", args, 3, 1e-9))

    lead = (4, 512)
    gs, vs = _random_tiles(gen, lead, M_L1, N_L1)

    def rnd(lo, hi, shape=gs.shape):
        return torch.empty(shape, device="cuda").uniform_(lo, hi, generator=gen)

    # Every system gets its own wire, source and SOR scalars.
    r_wire = rnd(5.0, 40.0, lead)
    cp_c = dataclasses.replace(
        cp, r_row=r_wire, r_col=r_wire, r_source=rnd(80.0, 150.0, lead),
        omega=rnd(1.0, 1.8, lead),
    )

    stamps = Stamps(
        g_shunt_row=rnd(1e-4, 1e-2), g_shunt_col=rnd(1e-4, 1e-2),
        i_inj_row=rnd(-1e-4, 1e-4), i_inj_col=rnd(-1e-4, 1e-4), v_init=rnd(0.0, 0.1),
    )
    _, args_s = ops.prepare(gs, vs, cp_c, stamps)
    max_err = max(max_err, compare("stamps + per-system scalars", args_s, SWEEPS_L1, res_atol))

    # One tile past the residency limit goes through the tridiag kernel.
    big = 128
    gb, vb = _random_tiles(gen, (4,), big, big)
    cp_big = dataclasses.replace(cp, gs_iters=96, tol=0.0)
    fb0, tl0 = ops.fallbacks, tridiag_ops.launches
    sol = solve_crossbar(gb, vb, cp_big, options=SolveOptions(backend="fused"))
    torch.cuda.synchronize()
    if ops.fallbacks != fb0 + 1 or tridiag_ops.launches <= tl0:
        raise AssertionError("the 128x128 tile did not fall back to the tridiag kernel")
    _, args_b = ops.prepare(gb, vb, cp_big)
    rvr, rvc, _ = ref.gs_fused_ref(*args_b, sweeps=96)
    err_b = check_close("fallback 128x128 vc", sol.vc, rvc, rtol=1e-4, atol=1e-7)
    log(f"[gs_fused] 128x128 tile: fell back to the tridiag kernel "
        f"({tridiag_ops.launches - tl0} launches), max abs err vc {err_b:.3g} vs the plain fused version")

    ms = time_ms(lambda: ops.gs_fused(*args, sweeps=SWEEPS_L1), reps=5)
    plain_ms = time_ms(lambda: ref.gs_fused_ref(*args, sweeps=SWEEPS_L1), reps=1)
    nodes = math.prod(args[0].shape)
    systems = args[0].shape[0]
    bytes_moved = 4 * (10 * nodes + 4 * systems)   # 8 arrays + 3 scalars in, 2 arrays + res out
    flops = (20 * SWEEPS_L1 + 14) * nodes
    bound_ms, bound_by = bound_of(bytes_moved, flops)
    timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"[gs_fused] main: {systems} systems of {M_L1}x{N_L1}, {SWEEPS_L1} sweeps: kernel "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {timing['bound_ms']:.4f} ms "
        f"({timing['bound_by']}: {bytes_moved / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP)")
    return max_err, timing


def near_tie_agreement(label, a, b, *, min_agree=0.99):
    """Predictions of two (n, classes) outputs agree except at near-ties.

    A sample is a near-tie when the top-2 gap of `a` is within twice the
    largest output difference: only there may the argmax flip.
    """
    import torch

    diff = float((a - b).abs().max())
    top2 = torch.topk(a, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    tie = gap <= 2 * diff + 1e-6
    disagree = torch.argmax(a, -1) != torch.argmax(b, -1)
    if bool((disagree & ~tie).any()):
        raise AssertionError(f"{label}: predictions differ away from near-ties")
    agree = 1.0 - float(disagree.float().mean())
    if agree < min_agree:
        raise AssertionError(f"{label}: only {agree:.4f} of predictions agree")
    return agree, diff


def phase_main_path(tridiag_ops, fused_ops):
    import torch
    from repro_torch.configs.imac_mnist import TOPOLOGY
    from repro_torch.core import solver
    from repro_torch.core.digital import accuracy, train_mlp
    from repro_torch.core.evaluate import test_imac
    from repro_torch.core.imac import IMACConfig
    from repro_torch.core.solver import SolveOptions
    from repro_torch.data.digits import train_test_split

    xtr, ytr, xte, yte = train_test_split(4000, 500, seed=0, noise=0.4)
    t0 = time.perf_counter()
    params = train_mlp(TOPOLOGY, xtr, ytr, steps=500)
    torch.cuda.synchronize()
    log(f"[main] train_mlp {TOPOLOGY}, 500 steps on the card: {time.perf_counter() - t0:.2f} s, "
        f"digital test accuracy {accuracy(params, xte, yte):.4f}")

    cfg = IMACConfig(tech="MRAM", array_rows=32, array_cols=32)
    results, launches, walls = {}, {}, {}
    for backend in ("tridiag", "fused"):
        tridiag_ops.launches = 0
        fused_ops.launches = 0
        solver.residual_reads = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = test_imac(params, xte, yte, cfg, n_samples=500, chunk=CHUNK,
                        solve_options=SolveOptions(backend=backend))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        walls[backend] = seconds
        reads = solver.residual_reads
        # One read a group of sweeps, per (layer, chunk) under gs_tol.
        chunks = -(-500 // CHUNK)
        most = chunks * sum(-(-s // solver.GROUP_SWEEPS) for s in res.sweeps)
        if backend == "tridiag" and not 0 < reads <= most:
            raise AssertionError(f"{reads} host reads of the residual, expected 1 to {most}")
        launches[backend] = dict(tridiag=tridiag_ops.launches, gs_fused=fused_ops.launches)
        results[backend] = res
        if list(res.hp) != [13, 4, 3] or list(res.vp) != [4, 3, 1]:
            raise AssertionError(f"H_P/V_P {res.hp}/{res.vp} != [13,4,3]/[4,3,1]")
        if not math.isfinite(res.worst_residual) or not math.isfinite(res.avg_power):
            raise AssertionError(f"{backend}: non-finite residual or power")
        log(f"[main] test_imac backend={backend}: accuracy {res.accuracy:.4f} "
            f"(digital {res.digital_accuracy:.4f}), avg power {res.avg_power:.6f} W, "
            f"latency {res.latency * 1e9:.3f} ns, worst residual {res.worst_residual:.3g} V, "
            f"sweeps per layer {list(res.sweeps)}, {500 / seconds:.1f} samples/s "
            f"({seconds:.3f} s), launches {launches[backend]}, host reads of the residual "
            f"{reads} ({reads / (chunks * len(res.sweeps)):.1f} per (layer, chunk))")
    if launches["tridiag"]["tridiag"] == 0 or launches["fused"]["gs_fused"] == 0:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    t, f = results["tridiag"], results["fused"]
    agree, diff = near_tie_agreement("tridiag vs fused", t.outputs, f.outputs)
    rel = abs(t.avg_power - f.avg_power) / abs(t.avg_power)
    if rel > 1e-3:
        raise AssertionError(f"avg_power differs by {rel:.3g} between backends")
    log(f"[main] backends agree on {agree:.4f} of predictions (max output diff {diff:.3g}), "
        f"avg power within {rel:.3g} relative; H_P {list(t.hp)} V_P {list(t.vp)}")
    return params, xte, yte, cfg, launches, walls


def profile_device(label: str, fn, wall_ms: float, top: int) -> "dict[str, float]":
    """Trace `fn` with torch.profiler and log its device time by kernel.

    Device busy time is the sum of the kernels' device times, set against
    `wall_ms`, the wall time of the same work untraced. Launches made here
    are not part of any main path's counts. Returns {kernel name: device
    ms} (empty when the trace holds no device time).
    """
    kernels = traced_kernels(fn)
    busy_ms = sum(ms for _, ms in kernels.values())
    if busy_ms == 0:
        log(f"[profile] {label}: the trace holds no device time (not measured)")
        return {}
    log(f"[profile] {label}: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall (untraced): "
        f"idle share {1 - busy_ms / wall_ms:.3f}; {sum(n for n, _ in kernels.values())} device "
        "kernels")
    for name, (calls, ms) in sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:top]:
        log(f"[profile]   {ms:9.3f} ms {ms / busy_ms:6.1%} {calls:6d} calls  {name[:90]}")
    return {name: ms for name, (_, ms) in kernels.items()}


def phase_profile(params, xte, yte, cfg, walls):
    """Where the main path's device time goes, per backend."""
    from repro_torch.core import solver
    from repro_torch.core.evaluate import test_imac
    from repro_torch.core.solver import SolveOptions

    for backend in ("tridiag", "fused"):
        solver.residual_reads = 0
        profile_device(
            f"backend={backend}",
            lambda: test_imac(params, xte, yte, cfg, n_samples=500, chunk=CHUNK,
                              solve_options=SolveOptions(backend=backend)),
            1e3 * walls[backend], top=6)
        log(f"[profile] backend={backend}: host reads of the residual {solver.residual_reads}")


def phase_cpu_vs_card(params, xte, yte, cfg):
    import torch
    from repro_torch.core.evaluate import test_imac
    from repro_torch.core.solver import SolveOptions

    cpu_params = [(w.cpu(), b.cpu()) for w, b in params]
    for backend in ("tridiag", "fused"):
        opts = SolveOptions(backend=backend)
        on_cpu = test_imac(cpu_params, xte.cpu(), yte.cpu(), cfg, n_samples=32, chunk=32,
                           solve_options=opts, device="cpu")
        on_card = test_imac(params, xte, yte, cfg, n_samples=32, chunk=32, solve_options=opts)
        agree, diff = near_tie_agreement(f"card vs CPU ({backend})", on_card.outputs,
                                         on_cpu.outputs, min_agree=0.0)
        rel = abs(on_card.avg_power - on_cpu.avg_power) / abs(on_cpu.avg_power)
        if rel > 1e-4:
            raise AssertionError(f"card vs CPU ({backend}): power differs by {rel:.3g}")
        log(f"[cpu] backend={backend}, 32 samples: card and CPU agree on {agree:.4f} of "
            f"predictions (max output diff {diff:.3g}), power within {rel:.3g} relative")


# Times of the 16x32x64 tile that the split-K route replaced, bf16 x (ms;
# tools/time_imac_mvm_tiles.py on NVIDIA H100 80GB HBM3, 700.00 W).
TILE16_MS = {(4, 4096, 11008): 0.3402, (4, 11008, 4096): 0.6727,
                  (12, 4096, 11008): 0.3682, (12, 11008, 4096): 0.7982}


def phase_imac_mvm(gen):
    """The imac_mvm kernel against its plain version on all three routes
    (the integer route also bit for bit against its exact plain version),
    NaN rows and columns, bitwise relaunches; times at M in {4, 12} and
    32 (bf16 x) and 2048 (f32 x) on both yi-9b FFN shapes."""
    import torch
    from repro_torch.kernels.imac_mvm import ops, ref

    f32, bf16 = torch.float32, torch.bfloat16

    def operands(m, k, n, x_dtype=f32):
        # A little past [0, 1] and [-1, 1], so that clipping is exercised.
        x = torch.empty((m, k), device="cuda").uniform_(-0.1, 1.1, generator=gen)
        w = torch.empty((k, n), device="cuda").uniform_(-1.1, 1.1, generator=gen)
        return x.to(x_dtype), w

    # The serving shapes (decode's M=4, the prefills' M=8-12: buckets 4, 8
    # and 12, full and partial), then ragged ones: M at the split-K route's
    # edge and past it, K not a multiple of the splits or of 16, N not a
    # multiple of 4; the long-context tick's M=32 in both x types; M=2048.
    # Each with the x types held over the whole quantiser grid.
    shapes = ([(m, k, n, (f32,)) for m in (4, 8, 10, 12) for k, n in YI_FFN]
              + [(1003, 300, 129, (f32,)), (16, 4097, 4095, (f32,)), (1, 11008, 129, (f32,)),
                 (17, 4097, 129, (f32,)), (33, 300, 129, (f32,))]
              + [(32, k, n, (f32, bf16)) for k, n in YI_FFN] + [(2048, 11008, 4096, (f32,))])
    quants = [(bits, levels) for bits in (0, 1, 4, 8) for levels in (1, 2, 16, 128, 256)]
    max_err = 0.0
    for m, k, n, dtypes in shapes:
        worst, routes = 0.0, {}
        for x_dtype in dtypes:
            x, w = operands(m, k, n, x_dtype)
            atol = 1e-6 * k * float(x.float().abs().max()) * float(w.abs().max())
            for bits, levels in quants:
                route = ops.plan_for(x, w, dac_bits=bits, levels=levels).route
                got = ops.imac_mvm(x, w, dac_bits=bits, levels=levels)
                want = ref.imac_mvm_ref(x, w, dac_bits=bits, levels=levels)
                torch.cuda.synchronize()
                label = f"imac_mvm {m}x{k}x{n} {str(x_dtype)[6:]} dac={bits} levels={levels}"
                worst = max(worst, check_close(label, got, want, rtol=1e-5, atol=atol))
                if route == "int8":
                    exact = ref.imac_mvm_levels_ref(x, w, dac_bits=bits, levels=levels)
                    if not torch.equal(got, exact):
                        raise AssertionError(f"{label}: the int8 route differs from "
                                             f"imac_mvm_levels_ref in {int((got != exact).sum())} "
                                             "elements")
                routes.setdefault(route, set()).add((bits, levels))
        if m <= 16:   # the serving path hands the kernel bfloat16 activations
            xb = x.to(bf16)
            got = ops.imac_mvm(xb, w)
            want = ref.imac_mvm_ref(xb, w)
            torch.cuda.synchronize()
            atol = 1e-6 * k * float(xb.float().abs().max()) * float(w.abs().max())
            worst = max(worst, check_close(f"imac_mvm {m}x{k}x{n} bf16 x", got, want,
                                           rtol=1e-5, atol=atol))
        max_err = max(max_err, worst)
        taken = "; ".join(f"{route}: {' '.join(f'{b}/{lv}' for b, lv in sorted(pairs))}"
                          for route, pairs in sorted(routes.items()))
        extra = " and bf16 x at 8/16" if m <= 16 else ""
        log(f"[imac_mvm] M={m} K={k} N={n} x {'+'.join(str(d)[6:] for d in dtypes)}: dac_bits "
            f"{{0,1,4,8}} x levels {{1,2,16,128,256}}{extra}: max abs err {worst:.3g} (rtol "
            f"1e-5, atol 1e-6*K*max|x|*max|w|); routes (dac_bits/levels) {taken}"
            + ("; int8 bit-identical to imac_mvm_levels_ref" if "int8" in routes else ""))

    # NaN in a row of x or a column of w gives NaN there, as the reference
    # (NaN * 0 is NaN); +-inf clips.
    for m, k, n, x_dtype in ((40, 300, 129, f32), (32, 4096, 11008, bf16)):
        x, w = operands(m, k, n, x_dtype)
        x[3, 7], w[11, 5] = float("nan"), float("nan")
        x[5, 0], w[0, 9] = float("inf"), -float("inf")
        got, want = ops.imac_mvm(x, w), ref.imac_mvm_ref(x, w)
        exact = ref.imac_mvm_levels_ref(x, w)
        torch.cuda.synchronize()
        nan = got.isnan()
        if not (torch.equal(nan, want.isnan()) and torch.equal(nan, exact.isnan())
                and int(nan.sum()) == m + n - 1
                and torch.equal(got.nan_to_num(), exact.nan_to_num())):
            raise AssertionError(f"imac_mvm {m}x{k}x{n}: NaN rows and columns not reproduced")
        # atol 1e-6*K*max|x|*max|w| with the clipped maxima (x holds an inf).
        check_close(f"imac_mvm {m}x{k}x{n} with NaN (finite part)", got[~nan], want[~nan],
                    rtol=1e-5, atol=1e-6 * k)
    log(f"[imac_mvm] NaN rows and columns reproduced at 40x300x129 f32 and 32x4096x11008 bf16 "
        f"({ops.plan_for(x, w).route} route), +-inf clipped")

    # Two launches on the same inputs give the same bits (no atomics; the
    # integer route's sums are exact).
    relaunch = [*TILE16_MS, (8, 4096, 11008), (10, 11008, 4096), (16, 4097, 4095),
                (2048, 300, 129), (32, 4096, 11008), (2048, 4096, 11008)]
    for m, k, n in relaunch:
        x, w = operands(m, k, n, bf16 if m <= 32 else f32)
        first, again = ops.imac_mvm_2d(x, w), ops.imac_mvm_2d(x, w)
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise AssertionError(f"imac_mvm {m}x{k}x{n}: two launches differ by "
                                 f"{float((first - again).abs().max()):.3g}")
    log("[imac_mvm] two launches bit-identical at " + ", ".join(f"{m}x{k}x{n}"
                                                               for m, k, n in relaunch))

    timing = {}
    tile64 = ops.Plan("tile64", 0, 0, 0, 0, 0, 0)
    cases = ([(m, k, n, bf16) for m, k, n in TILE16_MS] + [(32, k, n, bf16) for k, n in YI_FFN]
             + [(2048, k, n, f32) for k, n in YI_FFN])
    for m, k, n, x_dtype in cases:
        x, w = operands(m, k, n, x_dtype)
        plan = ops.plan_for(x, w)
        xq = ref.dac_quant(x.float(), 8)
        wq = ref.weight_quant(w, 16)
        ms = time_ms(lambda: ops.imac_mvm_2d(x, w), reps=50)
        plain_ms = time_ms(lambda: ref.imac_mvm_ref(x, w), reps=5)
        library_ms = time_ms(lambda: torch.matmul(xq, wq), reps=50)
        bytes_moved = x.element_size() * m * k + 4 * k * n + 4 * m * n
        flops = 2 * m * k * n
        rate = INT8_OPS_PER_S if plan.route == "int8" else FP32_FLOPS_PER_S
        bound_ms, bound_by = bound_of(bytes_moved, flops, rate)
        fp32_bound_ms, fp32_by = bound_of(bytes_moved, flops)
        timing[(m, k, n)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                 bound_ms=bound_ms, bound_by=bound_by, route=plan.route)
        before = TILE16_MS.get((m, k, n))
        was = f" (the 16x32x64 tile it replaced: {before:.4f} ms, now {before / ms:.2f}x faster)" \
            if before else ""
        extra = ""
        if m > 16:
            tile_ms = time_ms(lambda: ops.launch(x, w, tile64), reps=10 if m > 32 else 50)
            a8 = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
            b8 = torch.randint(-128, 128, (n, k), generator=gen, device="cuda",
                               dtype=torch.int8).t()
            int_mm_ms = time_ms(lambda: torch._int_mm(a8, b8), reps=50)
            timing[(m, k, n)].update(tile64_ms=tile_ms, int_mm_ms=int_mm_ms)
            parts = traced_kernels(lambda: ops.imac_mvm_2d(x, w), reps=10)
            split = ", ".join(f"{kernel_name(name)} {dev / 10:.4f}" for name, (_, dev) in
                              sorted(parts.items(), key=lambda kv: -kv[1][1]))
            extra = (f"; 64x64 tile {tile_ms:.4f} ms ({tile_ms / ms:.2f}x the kernel); "
                     f"torch._int_mm on random s8 operands (int8 GEMM rate, not the same "
                     f"function) {int_mm_ms:.4f} ms; fp32 bound {fp32_bound_ms:.4f} ms "
                     f"({fp32_by}); device ms per call by kernel: {split or 'not measured'}")
        log(f"[imac_mvm] time M={m} K={k} N={n} x {str(x_dtype)[6:]} ({plan.route} route): "
            f"kernel {ms:.4f} ms{was}, {bytes_moved / ms / 1e9:.3f} TB/s; plain {plain_ms:.4f} "
            f"ms, torch.matmul of the quantised f32 operands (TF32 off) {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} "
            f"G{'OP at int8' if plan.route == 'int8' else 'FLOP at fp32'}); plan {tuple(plan)}"
            + extra)
    return max_err, timing


# decode_attention against its plain version. float32: rtol = atol = 1e-5.
# bfloat16: both round the same float32 sums (up to their order and P's
# hi + lo split) to bfloat16, so they differ by at most one bfloat16 ulp,
# <= 2^-7 of the value: within 1e-2 |want|, while two ulps are not; and
# 1e-3 of the row's largest |want| for float32 sums that cancel near 0.
F32_TOL, BF16_RTOL, BF16_ROW_ATOL = 1e-5, 1e-2, 1e-3


def phase_decode_attention(gen):
    """The decode_attention kernel against its plain version at the serving
    shape and lengths, at long context with ragged lengths, and on the rows
    route's shapes; bitwise relaunches; times at B=32 (S=8192 and 4096) and
    at the serving shape (full lengths and the serving path's 9-28)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref

    def operands(b, s, hkv, g, dk, dv, dtype, kind="random"):
        q = torch.randn((b, hkv * g, dk), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, s, hkv, dk), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, s, hkv, dv), generator=gen, device="cuda").to(dtype)
        if kind == "full":
            lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        elif kind == "serving":       # the serving path's lengths at the launcher's defaults
            lens = torch.randint(9, 29, (b,), generator=gen, device="cuda", dtype=torch.int32)
        else:
            lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
            if kind == "ragged":      # 1, S, a split boundary, one past it, past S
                fill = [1, s, s // 8, s // 8 + 1, s + 7][:b]
                lens[:len(fill)] = torch.tensor(fill, dtype=torch.int32)
        return q, k, v, lens

    def describe(plan):
        if plan.route == "rows":
            return f"rows route, {plan.blocks} blocks"
        return (f"split-KV route, {plan.splits} splits of {plan.chunk} positions, {plan.blocks} "
                f"blocks, {plan.resident // plan.splits} clusters resident")

    cases = [("serving B=4 S=256 Hkv=4 G=8 D=128", (4, 256, 4, 8, 128, 128), "random"),
             ("serving lengths B=4 S=256 Hkv=4 G=8 D=128", (4, 256, 4, 8, 128, 128), "serving"),
             ("B=32 S=8192 Hkv=4 G=8 D=128", (32, 8192, 4, 8, 128, 128), "ragged"),
             ("B=32 S=4096 Hkv=4 G=8 D=128", (32, 4096, 4, 8, 128, 128), "ragged"),
             ("MLA-like B=2 S=256 Hkv=1 G=8 Dk=576 Dv=512", (2, 256, 1, 8, 576, 512), "random"),
             # Rows not 16-byte aligned: the rows route's one-element loads.
             ("S=300 B=3 Hkv=4 G=8 Dk=30 Dv=20", (3, 300, 4, 8, 30, 20), "random")]
    def cancelling(b, s, hkv, g, d):
        """bfloat16 inputs whose output cancels: even positions score m,
        odd ones m - 6.9e-4 (p = 0.99931, which rounds to 1 in bfloat16),
        v = +/-1 by the position's parity (times a random sign per
        dimension), so out = +/-(1 - p) / (1 + p) = +/-3.45e-4 comes only
        from P's low half."""
        sign = torch.randint(0, 2, (d,), generator=gen, device="cuda") * 2.0 - 1.0
        parity = torch.arange(s, device="cuda") % 2
        q = torch.zeros((b, hkv * g, d), device="cuda")
        q[..., 0] = 2.0
        k = torch.zeros((b, s, hkv, d), device="cuda")
        k[..., 0] = (1.0 - 2.0 ** -8 * parity)[None, :, None]
        v = (1.0 - 2.0 * parity)[None, :, None, None] * sign * torch.ones((b, s, hkv, d),
                                                                           device="cuda")
        lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
        return q.bfloat16(), k.bfloat16(), v.bfloat16(), lens

    max_err = 0.0
    checks = [(label, dtype, lambda shape=shape, dtype=dtype, kind=kind:
               operands(*shape, dtype, kind))
              for label, shape, kind in cases for dtype in (torch.float32, torch.bfloat16)]
    checks.append(("P's low half (cancelling values) B=4 S=256 Hkv=4 G=8 D=128", torch.bfloat16,
                   lambda: cancelling(4, 256, 4, 8, 128)))
    for label, dtype, make in checks:
        q, k, v, lens = make()
        got = ops.decode_attention(q, k, v, lens)
        want = ref.decode_attention_ref(q, k, v, lens).float()
        again = ops.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            rtol, atol = F32_TOL, F32_TOL
        else:
            rtol, atol = BF16_RTOL, BF16_ROW_ATOL * want.abs().amax(-1, keepdim=True)
        err = check_close(f"decode_attention {label} {dtype}", got.float(), want,
                          rtol=rtol, atol=atol)
        used = float(((got.float() - want).abs() / (atol + rtol * want.abs())).max())
        if not torch.equal(got, again):
            raise AssertionError(f"decode_attention {label} {dtype}: two launches differ")
        if dtype == torch.float32:
            max_err = max(max_err, err)
            tol = f"rtol = atol = {F32_TOL:g}"
        else:
            tol = f"rtol {BF16_RTOL:g}, atol {BF16_ROW_ATOL:g} max|row|"
        shown = (lens.tolist() if len(lens) <= 4
                 else f"{lens[:5].tolist()} + {len(lens) - 5} more")
        log(f"[decode_attention] {label} {str(dtype)[6:]}: lengths {shown}; "
            f"{describe(ops.plan_for(q, k, v))}: max abs err {err:.3g}, max |want| "
            f"{float(want.abs().max()):.3g}, worst element at {used:.3f} of its tolerance "
            f"({tol}); relaunch bit-identical")

    timing = {}
    hkv, g, d = 4, 8, 128
    for label, b, s, lens_kind in (("B=32 S=8192", 32, 8192, "full"),
                                   ("B=32 S=4096", 32, 4096, "full"),
                                   ("B=4 S=256", 4, 256, "full"),
                                   ("B=4 S=256 serving lengths", 4, 256, "serving")):
        q, k, v, lens = operands(b, s, hkv, g, d, d, torch.bfloat16, lens_kind)
        q4 = q[:, :, None, :]                                   # (B, H, 1, D)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)           # (B, Hkv, S, D) views
        mask = torch.arange(s, device="cuda")[None, None, None, :] < lens[:, None, None, None]
        plan, rows = ops.plan_for(q, k, v), ops.Plan("rows", 0, 0, b * hkv)

        def kernel():
            return ops.decode_attention(q, k, v, lens)

        def rows_route():
            return ops.launch(q, k, v, lens, rows)

        def library():
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask, enable_gqa=True)

        ms = time_ms(kernel, reps=50)
        rows_ms = time_ms(rows_route, reps=20)
        plain_ms = time_ms(lambda: ref.decode_attention_ref(q, k, v, lens), reps=5)
        library_ms = time_ms(library, reps=50)
        dev = [device_ms(fn, reps=20) for fn in (kernel, rows_route, library)]
        valid = int(lens.clamp(max=s).sum())     # positions this run's lengths read
        bytes_moved = 2 * (valid * hkv * 2 * d + 2 * b * hkv * g * d) + 4 * b
        flops = 4 * valid * hkv * g * d
        bound_ms, bound_by = bound_of(bytes_moved, flops)
        timing[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        log(f"[decode_attention] time {label} Hkv={hkv} G={g} D={d} bf16, {lens_kind} lengths, "
            f"{describe(plan)}: kernel {ms:.4f} ms ({bytes_moved / ms / 1e9:.3f} TB/s), rows route "
            f"{rows_ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{bytes_moved / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
        log(f"[decode_attention] device time {label} (torch.profiler, no host launch time): "
            f"kernel {shown_ms(dev[0])}, rows route {shown_ms(dev[1])}, "
            f"scaled_dot_product_attention {shown_ms(dev[2])}")
    return max_err, timing


def phase_serve(mvm_ops, da_ops):
    """yi-9b at full width, analog FFN, through `launch.serve.serve`."""
    import torch
    from repro_torch.launch.serve import config_for, serve

    cfg = config_for("yi-9b", analog=True)
    torch.cuda.reset_peak_memory_stats()
    mvm_ops.launches = 0
    da_ops.launches = 0
    t0 = time.perf_counter()
    res = serve(cfg, device="cuda", seed=0, log=log, **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(imac_mvm=mvm_ops.launches, decode_attention=da_ops.launches)
    st = res.engine.stats
    bad = [r.rid for r in res.requests if not r.done or len(r.output) != SERVE["max_tokens"]]
    if bad:
        raise AssertionError(f"requests {bad} did not finish with {SERVE['max_tokens']} tokens")
    layers = cfg.n_layers
    want = dict(imac_mvm=3 * layers * (st.prefills + st.ticks), decode_attention=layers * st.ticks)
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"launches {launches}, expected {want}")
    log(f"[serve] yi-9b full width ({layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"analog_mvm, compute {cfg.compute_dtype}, params {cfg.param_dtype}): "
        f"{res.tokens} tokens, {res.tokens / res.seconds:.2f} tok/s over the run "
        f"({res.seconds:.3f} s; build + init + run {wall:.3f} s)")
    log(f"[serve] {st.prefills} prefills {1e3 * st.prefill_s:.1f} ms "
        f"({1e3 * st.prefill_s / st.prefills:.2f} ms each); {st.ticks} decode ticks "
        f"{1e3 * st.decode_s:.1f} ms ({1e3 * st.decode_s / st.ticks:.2f} ms per tick, "
        f"{SERVE['slots'] * st.ticks / st.decode_s:.1f} slot-tokens/s)")
    log(f"[serve] launches {launches}: {3 * layers} imac_mvm per prefill and per tick, "
        f"{layers} decode_attention per tick, over {st.prefills} prefills and {st.ticks} ticks")
    log(f"[serve] torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    eng = res.engine
    profile_device("serve decode tick", lambda: eng.model.decode_step(eng.cache, eng._last_tok),
                   1e3 * st.decode_s / st.ticks, top=8)
    return launches


# The long-context decode tick: yi-9b's published 4K context over 32 slots.
LONG = dict(slots=32, cache_len=4096, min_len=2048, ticks=3)


@contextlib.contextmanager
def recorded_routes(mvm_ops):
    """Record the route of every imac_mvm launch made inside the block:
    yields {(x shape, w shape): {route, ...}}."""
    taken, launch = {}, mvm_ops.launch

    def recording(x, w, plan, **kw):
        taken.setdefault((tuple(x.shape), tuple(w.shape)), set()).add(plan.route)
        return launch(x, w, plan, **kw)

    mvm_ops.launch = recording
    try:
        yield taken
    finally:
        mvm_ops.launch = launch


def phase_long_context(mvm_ops, da_ops):
    """yi-9b at full width, analog FFN, one decode tick at a time over 32
    slots of a 4096-position cache filled from the generator (lengths
    2048-4096, no prefill): tick wall, device busy time and the shares of
    imac_mvm (whose FFN projections take the int8 route at M = 32) and
    decode_attention; one layer's decode_attention on the live cache
    against its plain version."""
    import torch
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.launch.serve import config_for
    from repro_torch.models.model import build_model

    torch.cuda.empty_cache()
    cfg = config_for("yi-9b", analog=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_model(cfg, device="cuda")
    model.init(gen)
    slots, cap = LONG["slots"], LONG["cache_len"]
    cache = model.init_cache(slots, cap)
    for layer in range(cfg.n_layers):           # one layer at a time: no float32 copy of it
        cache.k[layer].normal_(generator=gen)
        cache.v[layer].normal_(generator=gen)
    # Every tick writes at `length`: leave room for the warm-up, timed and profiled ticks.
    cache.length.copy_(torch.randint(LONG["min_len"], cap - LONG["ticks"] - 1, (slots,),
                                     generator=gen, device="cuda", dtype=torch.int32))
    start_lens = cache.length.clone()
    tokens = torch.randint(0, cfg.vocab, (slots, 1), generator=gen, device="cuda")

    def tick():
        nonlocal tokens
        logits, _ = model.decode_step(cache, tokens)
        tokens = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
        return logits

    with recorded_routes(mvm_ops) as taken:     # the warm-up tick
        tick()
    torch.cuda.synchronize()
    ffn = {((slots, cfg.d_model), (cfg.d_model, cfg.d_ff)), ((slots, cfg.d_ff), (cfg.d_ff, cfg.d_model))}
    if set(taken) != ffn or any(routes != {"int8"} for routes in taken.values()):
        raise AssertionError(f"long-context imac_mvm launches took {taken}, expected the int8 "
                             f"route at {sorted(ffn)}")
    da_ops.launches = 0
    mvm_ops.launches = 0
    walls = []
    for _ in range(LONG["ticks"]):
        t0 = time.perf_counter()
        logits = tick()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    if da_ops.launches != cfg.n_layers * LONG["ticks"]:
        raise AssertionError(f"{da_ops.launches} decode_attention launches over "
                             f"{LONG['ticks']} ticks, expected {cfg.n_layers} per tick")
    if mvm_ops.launches != 3 * cfg.n_layers * LONG["ticks"]:
        raise AssertionError(f"{mvm_ops.launches} imac_mvm launches over {LONG['ticks']} ticks, "
                             f"expected {3 * cfg.n_layers} per tick")
    finite = bool(torch.isfinite(logits[..., :cfg.vocab]).all())
    if tuple(logits.shape[:2]) != (slots, 1) or not finite:
        raise AssertionError(f"long-context logits {tuple(logits.shape)} not finite")
    if not torch.equal(cache.length, start_lens + LONG["ticks"] + 1):
        raise AssertionError("the cache lengths did not advance one per tick")
    # The kernel on the live cache, as the model calls it: one layer's
    # (B, S, Hkv, D) view of the stacked cache, lengths cache.length + 1.
    layer = cfg.n_layers - 1
    q = torch.randn((slots, cfg.n_heads, cfg.head_dim), generator=gen, device="cuda")
    q = q.to(cache.k.dtype)
    attn_args = (q, cache.k[layer], cache.v[layer], cache.length + 1)
    got = da_ops.decode_attention(*attn_args, scale=cfg.head_dim ** -0.5).float()
    want = da_ref.decode_attention_ref(*attn_args, scale=cfg.head_dim ** -0.5).float()
    atol = BF16_ROW_ATOL * want.abs().amax(-1, keepdim=True)
    err = check_close("decode_attention on the live cache", got, want, rtol=BF16_RTOL, atol=atol)
    plan = da_ops.plan_for(q, cache.k[layer], cache.v[layer])
    log(f"[profile] long-context decode tick: layer {layer}'s decode_attention on the live cache "
        f"({q.dtype}, {plan.route} route, {plan.splits} splits of {plan.chunk} positions) within "
        f"rtol {BF16_RTOL:g}, atol {BF16_ROW_ATOL:g} max|row| of the plain version: max abs err "
        f"{err:.3g}, max |want| {float(want.abs().max()):.3g}")
    if plan.route != "splitkv":
        raise AssertionError(f"the long-context tick took the {plan.route} route")
    read_mb = 2 * 2 * cfg.n_kv_heads * cfg.head_dim * int(cache.length.sum()) * cfg.n_layers / 1e6
    wall = sum(walls) / len(walls)
    log(f"[profile] long-context decode tick: yi-9b full width, analog, {slots} slots, cache "
        f"{cap}, lengths {int(start_lens.min())}-{int(start_lens.max())} at the start: wall "
        f"{' / '.join(f'{w:.2f}' for w in walls)} ms per tick (mean {wall:.2f}), "
        f"{slots * 1e3 / wall:.1f} slot-tokens/s; {cfg.n_layers} decode_attention per tick "
        f"reading {read_mb:.1f} MB of cache; {3 * cfg.n_layers} imac_mvm per tick, all on the "
        f"int8 route at M={slots} (K, N = {cfg.d_model}, {cfg.d_ff} and {cfg.d_ff}, {cfg.d_model})")
    by_kernel = profile_device("long-context decode tick", tick, wall, top=8)
    if by_kernel:
        busy = sum(by_kernel.values())
        attn = sum(ms for name, ms in by_kernel.items() if "decode_attention" in name)
        log(f"[profile] long-context decode tick: decode_attention {attn:.3f} ms of {busy:.2f} ms "
            f"device busy ({attn / busy:.1%}), {attn / cfg.n_layers:.4f} ms per launch")
        mvm = {kernel_name(name): ms for name, ms in by_kernel.items() if "imac_mvm" in name}
        total = sum(mvm.values())
        log(f"[profile] long-context decode tick: imac_mvm {total:.3f} ms of {busy:.2f} ms device "
            f"busy ({total / busy:.1%}), {total / (3 * cfg.n_layers):.4f} ms per call: "
            + ", ".join(f"{name} {ms:.3f} ms" for name, ms in sorted(mvm.items(),
                                                                     key=lambda kv: -kv[1])))
    del model, cache
    torch.cuda.empty_cache()


# Card vs CPU engines: every logits row within rtol 1e-4 and 1e-5 * max|row|
# (float32 sums in another order), the card's DAC inputs within 1e-5 of
# the CPU's (one 8-bit level is 3.9e-3), and at least 90% of the tokens
# compared before any parting.
ENGINE_RTOL, ENGINE_ATOL, DAC_TOL, MIN_COMPARED = 1e-4, 1e-5, 1e-5, 0.9
# A prompt past the split-K route's 16 rows (its prefill takes the int8 route).
LONG_PROMPT = 24


class RecordingModel:
    """A model that records the logits rows its engine takes tokens from:
    one {rid: row} per prefill (requests are admitted in rid order) and
    per decode tick (the slots that hold a request)."""

    def __init__(self, model):
        self._model, self.engine, self.events, self._admitted = model, None, [], 0

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, tokens, cache_len):
        logits, cache = self._model.prefill(tokens, cache_len=cache_len)
        self.events.append({self._admitted: logits[0, -1].float().cpu()})
        self._admitted += 1
        return logits, cache

    def decode_step(self, cache, tokens):
        logits, cache = self._model.decode_step(cache, tokens)
        rows = logits[:, 0].float().cpu()
        self.events.append({req.rid: rows[slot] for slot, req in enumerate(self.engine.slot_req)
                            if req is not None})
        return logits, cache


def run_engine(model, prompts, dac_inputs, replay):
    """Serve `prompts` with greedy decoding and record the logits rows.

    Every `imac_mvm` call's normalised activations are appended to
    `dac_inputs`, or, with `replay`, checked against the recorded ones
    (DAC_TOL) and replaced by them, so that two runs pick the same DAC
    level where an input sits at a .5 boundary. Returns (requests,
    events, max DAC input difference).
    """
    from repro_torch.kernels.imac_mvm import ops
    from repro_torch.serving.engine import Request, ServeConfig, ServingEngine

    orig, calls, worst = ops.imac_mvm, iter(dac_inputs), [0.0]

    def dac_hook(xn, wn, **kw):
        if not replay:
            dac_inputs.append(xn.float().cpu())
            return orig(xn, wn, **kw)
        want = next(calls)
        err = float((xn.float().cpu() - want).abs().max())
        if xn.shape != want.shape or err > DAC_TOL:
            raise AssertionError(f"DAC inputs {tuple(xn.shape)} differ by {err:.3g} "
                                 f"(limit {DAC_TOL:g})")
        worst[0] = max(worst[0], err)
        return orig(want.to(xn.device, xn.dtype), wn, **kw)

    rec = RecordingModel(model)
    eng = ServingEngine(rec, ServeConfig(slots=SERVE["slots"], cache_len=SERVE["cache_len"]))
    rec.engine = eng
    reqs = [Request(rid=i, prompt=p, max_tokens=SERVE["max_tokens"]) for i, p in enumerate(prompts)]
    ops.imac_mvm = dac_hook
    try:
        eng.run(reqs, max_ticks=10_000)
    finally:
        ops.imac_mvm = orig
    if replay and next(calls, None) is not None:
        raise AssertionError("the replayed run made fewer imac_mvm calls than the recorded one")
    return reqs, rec.events, worst[0]


def engines_agree(label, run_a, run_b, vocab) -> "tuple[int, int, float]":
    """Two greedy engine runs agree, row by row in the order tokens were taken.

    Every row of `run_a` is held against `run_b`'s at ENGINE_RTOL plus
    ENGINE_ATOL * max|row|, the row where the tokens part included (so a
    parting is a near-tie inside that bound); nothing after the first
    parting is compared, and at least MIN_COMPARED of the tokens must be.
    Returns (tokens compared, tokens, max logits difference).
    """
    (reqs_a, events_a), (reqs_b, events_b) = run_a, run_b
    if len(events_a) != len(events_b):
        raise AssertionError(f"{label}: {len(events_a)} != {len(events_b)} model calls")
    taken = {r.rid: 0 for r in reqs_b}
    compared, diff = 0, 0.0
    for t, (ev_a, ev_b) in enumerate(zip(events_a, events_b)):
        if ev_a.keys() != ev_b.keys():
            raise AssertionError(f"{label} call {t}: requests {sorted(ev_a)} != {sorted(ev_b)}")
        parted = False
        for rid in ev_b:
            la, lb = ev_a[rid], ev_b[rid]
            d = (la[:vocab] - lb[:vocab]).abs()
            bound = ENGINE_RTOL * lb[:vocab].abs() + ENGINE_ATOL * float(lb[:vocab].abs().max())
            if bool((d > bound).any()):
                raise AssertionError(f"{label} call {t} request {rid}: logits differ by "
                                     f"{float(d.max()):.3g} beyond rtol {ENGINE_RTOL:g} + "
                                     f"atol {ENGINE_ATOL:g}*max|row|")
            i = taken[rid]
            ta, tb = reqs_a[rid].output[i], reqs_b[rid].output[i]
            if (ta, tb) != (int(la.argmax()), int(lb.argmax())):
                raise AssertionError(f"{label} request {rid}: token {i} is not its row's argmax")
            taken[rid] += 1
            compared += 1
            diff = max(diff, float(d.max()))
            parted |= ta != tb
        if parted:
            log(f"[serve-cpu] {label}: tokens parted at a near-tie at model call {t}")
            break
    total = sum(len(r.output) for r in reqs_b)
    if compared < MIN_COMPARED * total:
        raise AssertionError(f"{label}: only {compared} of {total} tokens compared")
    return compared, total, diff


def phase_serve_cpu_vs_card(mvm_ops):
    """yi-9b reduced (2 layers, float32, analog) on the card and on the CPU:
    the launcher's prompts (8-12 tokens: prefills on split-K at M = 8 and on
    the int8 route at 9-12), then the same with one prompt of 24 tokens
    (past the split-K route's 16 rows)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.launch.serve import config_for
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(config_for("yi-9b", reduced=True, analog=True), n_layers=2)
    card = build_model(cfg, device="cuda")
    card.init(torch.Generator(device="cuda").manual_seed(0))
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    rng = np.random.default_rng(0)   # the launcher's prompts
    prompts = [rng.integers(0, cfg.vocab, size=(8 + i % 5,)) for i in range(SERVE["requests"])]
    long_prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=(LONG_PROMPT,))
    runs = {"launcher prompts": prompts,
            f"one prompt of {LONG_PROMPT} tokens": [*prompts[:2], long_prompt, *prompts[3:]]}
    for label, run_prompts in runs.items():
        dac_inputs = []
        *cpu_run, _ = run_engine(cpu, run_prompts, dac_inputs, replay=False)
        with recorded_routes(mvm_ops) as taken:
            *card_run, dac_err = run_engine(card, run_prompts, dac_inputs, replay=True)
        compared, total, diff = engines_agree(f"card vs CPU, {label}", card_run, cpu_run,
                                              cfg.vocab)
        routes = sorted({route for r in taken.values() for route in r})
        int8_m = sorted({x[0] for (x, _), r in taken.items() if "int8" in r})
        if (LONG_PROMPT in int8_m) != (label != "launcher prompts"):
            raise AssertionError(f"{label}: the int8 route ran at M = {int8_m}")
        log(f"[serve-cpu] yi-9b reduced (2 layers, float32, analog), {label}: card and CPU "
            f"engines agree on {compared} of {total} tokens compared, max logits diff {diff:.3g} "
            f"(rtol {ENGINE_RTOL:g} + atol {ENGINE_ATOL:g}*max|row|); the card's "
            f"{len(dac_inputs)} DAC inputs within {dac_err:.3g} of the CPU's, replayed from the "
            f"CPU run; card routes {routes}, int8 at M = {int8_m}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.imac import IMACConfig
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.gs_fused import ops as fused_ops
    from repro_torch.kernels.imac_mvm import ops as mvm_ops
    from repro_torch.kernels.tridiag import ops as tridiag_ops

    t_start = time.perf_counter()
    smi = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cp = IMACConfig().circuit_params(M_L1, N_L1)
    tri_err, tri_time = phase_tridiag(gen, cp)
    fused_err, fused_time = phase_gs_fused(gen, cp)
    mvm_err, mvm_time = phase_imac_mvm(gen)
    da_err, da_time = phase_decode_attention(gen)
    params, xte, yte, cfg, launches, walls = phase_main_path(tridiag_ops, fused_ops)
    phase_profile(params, xte, yte, cfg, walls)
    phase_cpu_vs_card(params, xte, yte, cfg)
    del params
    serve_launches = phase_serve(mvm_ops, da_ops)
    phase_long_context(mvm_ops, da_ops)
    phase_serve_cpu_vs_card(mvm_ops)

    row = tri_time["row N=30 (backend)"]
    col = tri_time["col N=31 (backend)"]
    dense = tri_time["dense (825344, 30)"]
    m32 = mvm_time[(32, 4096, 11008)]
    kernels = [
        dict(name="tridiag", route="cuda",
             source="src/repro_torch/kernels/tridiag/csrc/tridiag.cu",
             replaces="src/repro/kernels/tridiag/kernel.py:26",
             launches=launches["tridiag"]["tridiag"], max_abs_err=tri_err,
             ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=None,
             col_ms=col["ms"], col_bound_ms=col["bound_ms"], dense_ms=dense["ms"],
             dense_bound_ms=dense["bound_ms"], sweep_device_ms=tri_time["sweep_device_ms"]),
        dict(name="gs_fused", route="cuda",
             source="src/repro_torch/kernels/gs_fused/csrc/gs_fused.cu",
             replaces="src/repro/kernels/gs_fused/kernel.py:47",
             launches=launches["fused"]["gs_fused"], max_abs_err=fused_err,
             ms=fused_time["ms"], plain_ms=fused_time["plain_ms"],
             bound_ms=fused_time["bound_ms"], bound_by=fused_time["bound_by"],
             library_ms=None),
        dict(name="imac_mvm", route="cuda",
             source="src/repro_torch/kernels/imac_mvm/csrc/imac_mvm.cu",
             replaces="src/repro/kernels/imac_mvm/kernel.py:38",
             launches=serve_launches["imac_mvm"], max_abs_err=mvm_err,
             **{key: mvm_time[(4, 4096, 11008)][key]
                for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             plan_route=mvm_time[(4, 4096, 11008)]["route"],
             m32_plan_route=m32["route"], m32_ms=m32["ms"], m32_bound_ms=m32["bound_ms"],
             m32_bound_by=m32["bound_by"], m32_library_ms=m32["library_ms"]),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:30",
             launches=serve_launches["decode_attention"], max_abs_err=da_err,
             **da_time["B=32 S=8192"]),
    ]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
