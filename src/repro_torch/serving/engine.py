"""Slot-based continuous-batching serving engine.

A fixed pool of B slots shares one decode step. New requests prefill
into free slots (one at a time) while the other slots keep decoding;
finished slots (EOS or max_tokens) are reusable at once. The decode step
runs every slot, idle ones included, as the reference does: with
``analog_mvm`` the FFN's per-call normalisation spans all slots, so an
engine's tokens match another engine's on the same schedule, not those
of a lone decode.

The admission, tick and retire logic is the reference's
(`repro/serving/engine.py`). Slot placement indexes the cache tensors
directly. Each prefill and each tick reads its argmax back to the host
once; `stats` keeps the host time of both (each ends in that read, so
the device work is inside it).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: "np.ndarray"           # (S,) int
    max_tokens: int = 32
    eos_id: int = -1               # -1: never
    # filled by the engine:
    output: "list[int]" = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 4
    cache_len: int = 512
    greedy: bool = True            # as the reference: read by nothing, decoding is greedy


@dataclasses.dataclass
class EngineStats:
    prefills: int = 0
    ticks: int = 0                 # batched decode steps
    prefill_s: float = 0.0         # host seconds in prefill, readback included
    decode_s: float = 0.0          # host seconds in decode ticks, readback included


class ServingEngine:
    def __init__(self, model: Model, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        self.cache = model.init_cache(cfg.slots, cfg.cache_len)
        self.slot_req: "list[Optional[Request]]" = [None] * cfg.slots
        self._last_tok = torch.zeros((cfg.slots, 1), dtype=torch.int32, device=model.device)
        self._queue: "list[Request]" = []
        self.stats = EngineStats()

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def _free_slots(self) -> "list[int]":
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self) -> None:
        """Prefill queued requests into free slots, one at a time."""
        for slot in self._free_slots():
            if not self._queue:
                break
            req = self._queue.pop(0)
            t0 = time.perf_counter()
            tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32)[None, :]
            logits, one = self.model.prefill(tokens, cache_len=self.cfg.cache_len)
            self.cache.k[:, slot] = one.k[:, 0]
            self.cache.v[:, slot] = one.v[:, 0]
            self.cache.length[slot] = one.length[0]
            tok = int(torch.argmax(logits[0, -1]))
            self.stats.prefill_s += time.perf_counter() - t0
            self.stats.prefills += 1
            req.output.append(tok)
            self.slot_req[slot] = req
            self._last_tok[slot, 0] = tok

    # -- decode ------------------------------------------------------------

    def step(self) -> None:
        """One engine tick: admit, batched-decode, retire."""
        self._admit()
        if all(r is None for r in self.slot_req):
            return
        t0 = time.perf_counter()
        logits, self.cache = self.model.decode_step(self.cache, self._last_tok)
        nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
        nxt_host = nxt.cpu().numpy()
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.ticks += 1
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(nxt_host[slot])
            req.output.append(tok)
            if tok == req.eos_id or len(req.output) >= req.max_tokens:
                req.done = True
                self.slot_req[slot] = None
        self._last_tok = nxt[:, None]

    def run(self, requests: "list[Request]", max_ticks: int = 1000) -> "list[Request]":
        for r in requests:
            self.submit(r)
        for _ in range(max_ticks):
            if not self._queue and all(r is None for r in self.slot_req):
                break
            self.step()
        return requests
