#!/usr/bin/env python3
"""Time the yi-9b long-context analog decode tick of one source tree on a GPU.

    python3 tools/time_long_context_tick.py [--src DIR] [--ticks 3]

Imports `repro_torch` from DIR (default: this checkout's `src`), so that
two trees can be compared on one card in one run (e.g. a parent
commit unpacked with `git archive` beside this one, run in the order
parent, change, change, parent). Builds the kernels of that tree, then
runs the tick that `chip_smoke.py`'s `[profile] long-context decode tick`
runs: yi-9b at full width with `analog_mvm`, 32 slots over a
4096-position cache filled from `torch.Generator` seed 0, lengths drawn
in 2048-4096, no prefill. One warm-up tick, `--ticks` timed ticks (host
wall around each, ending in a synchronize), one profiled tick (device
busy time from torch.profiler, `imac_mvm`'s and `decode_attention`'s
shares).

Prints the card's name and power limit, then one JSON line:
{"src", "wall_ms": [...], "device_ms", "imac_mvm_ms", "decode_attention_ms",
 "kernels": {name: ms}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SLOTS, CACHE_LEN, MIN_LEN = 32, 4096, 2048


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    ap.add_argument("--ticks", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_long_context_tick: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import config_for
    from repro_torch.models.model import build_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all()
    cfg = config_for("yi-9b", analog=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_model(cfg, device="cuda")
    model.init(gen)
    cache = model.init_cache(SLOTS, CACHE_LEN)
    for layer in range(cfg.n_layers):
        cache.k[layer].normal_(generator=gen)
        cache.v[layer].normal_(generator=gen)
    cache.length.copy_(torch.randint(MIN_LEN, CACHE_LEN - args.ticks - 2, (SLOTS,), generator=gen,
                                     device="cuda", dtype=torch.int32))
    tokens = torch.randint(0, cfg.vocab, (SLOTS, 1), generator=gen, device="cuda")

    def tick():
        nonlocal tokens
        logits, _ = model.decode_step(cache, tokens)
        tokens = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)

    tick()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.ticks):
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tick()
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    print(json.dumps({
        "src": args.src, "wall_ms": walls, "device_ms": sum(kernels.values()),
        "imac_mvm_ms": sum(ms for k, ms in kernels.items() if "imac_mvm" in k),
        "decode_attention_ms": sum(ms for k, ms in kernels.items() if "decode_attention" in k),
        "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8]),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
