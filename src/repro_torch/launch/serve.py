"""Serving launcher: the continuous-batching engine for --arch <id>.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --reduced \
      --analog --device cpu

--analog routes the FFN projections through the simulated IMAC crossbars
(the paper's inference-accelerator mode, the `imac_mvm` kernel on a GPU).
--device defaults to cuda. Weights are drawn from a seeded
`torch.Generator` on the device; prompts are the reference launcher's
(`np.random.default_rng(0)`, 8-12 tokens).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, build_model
from repro_torch.serving.engine import Request, ServeConfig, ServingEngine


@dataclasses.dataclass
class ServeResult:
    requests: "list[Request]"
    engine: ServingEngine
    seconds: float                 # host wall of the whole run

    @property
    def tokens(self) -> int:
        return sum(len(r.output) for r in self.requests)


def config_for(arch: str, *, reduced: bool = False, analog: bool = False) -> ModelConfig:
    """The launcher's config: `reduced` is the float32 CPU-test size."""
    cfg = get_config(arch)
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), param_dtype="float32",
                                  compute_dtype="float32")
    if analog:
        cfg = dataclasses.replace(cfg, analog_mvm=True)
    return cfg


def serve(
    cfg: ModelConfig,
    *,
    requests: int = 6,
    slots: int = 4,
    cache_len: int = 256,
    max_tokens: int = 16,
    device: "str | torch.device | None" = None,
    seed: int = 0,
    model: Optional[Model] = None,
    log: Callable[[str], None] = print,
) -> ServeResult:
    """Serve `requests` prompts with greedy decoding and print the counts.

    Builds the model on `device` (None: the GPU) with weights from
    ``torch.Generator(device).manual_seed(seed)``, unless a `model` is
    given (its device is used then).
    """
    if model is None:
        dev = resolve_device(device)
        model = build_model(cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(seed))
    engine = ServingEngine(model, ServeConfig(slots=slots, cache_len=cache_len))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=(8 + i % 5,)),
                    max_tokens=max_tokens)
            for i in range(requests)]
    t0 = time.perf_counter()
    engine.run(reqs, max_ticks=10_000)
    result = ServeResult(reqs, engine, time.perf_counter() - t0)
    for r in reqs:
        log(f"[serve] req {r.rid}: {len(r.output)} tokens "
            f"{'done' if r.done else 'INCOMPLETE'}")
    st = engine.stats
    log(f"[serve] {result.tokens} tokens in {result.seconds:.3f}s "
        f"({result.tokens / result.seconds:.1f} tok/s, slots={slots}, "
        f"analog={'on' if cfg.analog_mvm else 'off'}, device={model.device}); "
        f"{st.prefills} prefills {st.prefill_s:.3f}s, {st.ticks} decode ticks "
        f"{st.decode_s:.3f}s")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--analog", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = config_for(args.arch, reduced=args.reduced, analog=args.analog)
    serve(cfg, requests=args.requests, slots=args.slots, cache_len=args.cache_len,
          max_tokens=args.max_tokens, device=args.device)


if __name__ == "__main__":
    main()
