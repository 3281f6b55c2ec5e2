#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of IMAC-Sim (`src/repro_torch`) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds both CUDA kernels from the sources in this checkout (nvcc, into
build/repro_torch/), holds each kernel against its plain torch version at
the shapes of the main path, then runs the main path — testIMAC on the
paper's 400x120x84x10 sigmoid MLP on MRAM 32x32 arrays, 500 test samples
— once per solver backend, and checks the card against the port's own
CPU result. Any failure exits non-zero. The last line of output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

preceded by the card's name and power limit and, before that, one JSON
line with each kernel's launches, error, times and bound.

Imports torch, numpy and repro_torch only.
"""
from __future__ import annotations

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


def check_close(name, got, want, *, rtol, atol) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; max error."""
    import torch

    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol={rtol} atol={atol:.3g}; "
            f"max abs error {float(err.max()):.3g}"
        )
    return float(err.max())


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
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] kernels built and loaded in {seconds:.2f} s")
    return smi


def _random_tiles(gen, lead, m, n):
    import torch
    from repro_torch.core.devices import MRAM

    g = torch.empty(lead + (m, n), device="cuda").uniform_(MRAM.g_off, MRAM.g_on, generator=gen)
    v = 0.8 * torch.rand(lead + (m,), generator=gen, device="cuda")
    return g, v


def phase_tridiag(gen, cp):
    """The tridiag kernel against its plain version at the main path's shapes."""
    import torch
    from repro_torch.core import solver
    from repro_torch.kernels.tridiag import ops, ref

    g, v = _random_tiles(gen, (CHUNK, TILES_L1), M_L1, N_L1)
    vc = 0.1 * torch.rand(g.shape, generator=gen, device="cuda")
    row = solver._row_system(g, vc, v, cp)        # N=30 along the rows
    col = solver._col_system(g, vc, cp)           # N=31 along the columns

    def diag_dominant(b_count, n):
        d = 2.0 + torch.rand((b_count, n), generator=gen, device="cuda")
        off = -0.5 * torch.rand((2, b_count, n), generator=gen, device="cuda")
        return off[0], d, off[1], torch.randn((b_count, n), generator=gen, device="cuda")

    cases = [("row N=30", row), ("col N=31", col),
             ("ragged B=1003 N=7", diag_dominant(1003, 7)), ("N=1 B=5", diag_dominant(5, 1))]
    max_err = 0.0
    out = {}
    for label, system in cases:
        got = ops.tridiag(*system)
        want = ref.tridiag_ref(*system)
        torch.cuda.synchronize()
        atol = 1e-6 * float(want.abs().max())
        err = check_close(f"tridiag {label}", got, want, rtol=1e-5, atol=atol)
        max_err = max(max_err, err)
        log(f"[tridiag] {label}: shape {tuple(want.shape)} max abs err {err:.3g} "
            f"(rtol 1e-5, atol {atol:.3g})")

    for label, system in cases[:2]:
        shape = torch.broadcast_shapes(*(t.shape for t in system))
        n = shape[-1]
        batch = math.prod(shape[:-1])
        lanes = [t.expand(shape).reshape(batch, n).t().contiguous() for t in system]
        flat = [t.expand(shape).reshape(batch, n) for t in system]
        ms = time_ms(lambda: ops.tridiag_nb(*lanes), reps=20)
        plain_ms = time_ms(lambda: ref.tridiag_ref(*flat), reps=3)
        nodes = n * batch
        bytes_moved = 5 * 4 * nodes          # 4 inputs read once, x written once
        flops = 8 * nodes                    # 6 forward, 2 backward per node
        t_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
        t_ops = 1e3 * flops / FP32_FLOPS_PER_S
        out[label] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            n=n, batch=batch,
        )
        log(f"[tridiag] {label}: N={n} B={batch}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {max(t_bytes, t_ops):.4f} ms ({out[label]['bound_by']}: "
            f"{bytes_moved / 1e9:.3f} GB, {flops / 1e9:.3f} GFLOP)")
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
    t_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOPS_PER_S
    timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations")
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = test_imac(params, xte, yte, cfg, n_samples=500, chunk=CHUNK,
                        solve_options=SolveOptions(backend=backend))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        walls[backend] = seconds
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
            f"({seconds:.3f} s), launches {launches[backend]}")
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


def phase_profile(params, xte, yte, cfg, walls):
    """Where the main path's device time goes, per backend (torch.profiler).

    The same test_imac call as the main path, traced; device busy time is
    the sum of the kernels' device times, against the wall time of the
    untraced run. Launches here are not part of the main path's counts.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.evaluate import test_imac
    from repro_torch.core.solver import SolveOptions

    def device_us(event):
        return getattr(event, "self_device_time_total", 0.0)

    for backend in ("tridiag", "fused"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            test_imac(params, xte, yte, cfg, n_samples=500, chunk=CHUNK,
                      solve_options=SolveOptions(backend=backend))
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0]
        busy_ms = sum(device_us(e) for e in kernels) / 1e3
        wall_ms = 1e3 * walls[backend]
        if busy_ms == 0:
            log(f"[profile] backend={backend}: the trace holds no device time (not measured)")
            continue
        log(f"[profile] backend={backend}: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms "
            f"wall (untraced run): idle share {1 - busy_ms / wall_ms:.3f}")
        for e in sorted(kernels, key=device_us, reverse=True)[:6]:
            log(f"[profile]   {device_us(e) / 1e3:9.3f} ms {device_us(e) / 1e3 / busy_ms:6.1%} "
                f"{e.count:6d} calls  {e.key[:90]}")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.imac import IMACConfig
    from repro_torch.kernels.gs_fused import ops as fused_ops
    from repro_torch.kernels.tridiag import ops as tridiag_ops

    t_start = time.perf_counter()
    smi = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cp = IMACConfig().circuit_params(M_L1, N_L1)
    tri_err, tri_time = phase_tridiag(gen, cp)
    fused_err, fused_time = phase_gs_fused(gen, cp)
    params, xte, yte, cfg, launches, walls = phase_main_path(tridiag_ops, fused_ops)
    phase_profile(params, xte, yte, cfg, walls)
    phase_cpu_vs_card(params, xte, yte, cfg)

    row = tri_time["row N=30"]
    kernels = [
        dict(name="tridiag", route="cuda",
             source="src/repro_torch/kernels/tridiag/csrc/tridiag.cu",
             replaces="src/repro/kernels/tridiag/kernel.py:26",
             launches=launches["tridiag"]["tridiag"], max_abs_err=tri_err,
             ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=None),
        dict(name="gs_fused", route="cuda",
             source="src/repro_torch/kernels/gs_fused/csrc/gs_fused.cu",
             replaces="src/repro/kernels/gs_fused/kernel.py:47",
             launches=launches["fused"]["gs_fused"], max_abs_err=fused_err,
             ms=fused_time["ms"], plain_ms=fused_time["plain_ms"],
             bound_ms=fused_time["bound_ms"], bound_by=fused_time["bound_by"],
             library_ms=None),
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
