"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel's source is ``kernels/<name>/csrc/<name>.cu``, with a plain C
interface. It is compiled for Hopper (``sm_90a``) into
``build/repro_torch/`` at the repository root, at first use, under a name
keyed by a hash of the source and the flags, and loaded with `ctypes`.
Nothing is compiled when this module is imported.

Every C entry point takes its pointers and the stream as ``void*``
(`ctypes.c_void_p`) and returns ``cudaGetLastError()`` as an int.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable

KERNELS = ("tridiag", "gs_fused", "imac_mvm", "decode_attention")

_KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNEL_DIR.parents[2] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: "dict[str, ctypes.CDLL]" = {}


def source(name: str) -> Path:
    return _KERNEL_DIR / name / "csrc" / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc() -> str:
    """The CUDA compiler: on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def nvcc_command(name: str, out: Path, *, ptxas_verbose: bool = False) -> "list[str]":
    cmd = [nvcc(), *NVCC_FLAGS]
    if ptxas_verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + ["-o", str(out), str(source(name))]


def build(
    names: Iterable[str] = KERNELS, *, ptxas_verbose: bool = False
) -> "dict[str, str]":
    """Compile every named kernel whose library is missing, in parallel.

    One nvcc per source, all started together. Each library is written
    under a temporary name and renamed into place, so concurrent builders
    never load a partial file.

    Returns:
      {name: compiler stderr} for the kernels built by this call (with
      ``ptxas_verbose`` it holds the register and shared-memory report).

    Raises:
      RuntimeError: if a compilation fails (with nvcc's output).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            nvcc_command(name, tmp, ptxas_verbose=ptxas_verbose),
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        jobs[name] = (proc, tmp, out)
    reports = {}
    failures = []
    for name, (proc, tmp, out) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{stdout}{stderr}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        reports[name] = stderr
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def build_all(*, ptxas_verbose: bool = False) -> "tuple[float, dict[str, str]]":
    """Build and load every kernel; returns (seconds, compiler reports)."""
    t0 = time.perf_counter()
    reports = build(KERNELS, ptxas_verbose=ptxas_verbose)
    for name in KERNELS:
        load(name)
    return time.perf_counter() - t0, reports
