"""Batched token serving engine.

The port of ``repro.serve.engine``.  Gang-scheduled batching: admit up to
``max_batch`` queued requests, left-pad prompts to a common length, run
one batched prefill, then a decode loop where finished requests are masked
(EOS or per-request ``max_new``).  Greedy sampling by default; temperature
sampling optional, from an explicit ``torch.Generator`` seeded with
``seed`` on the model's device (it cannot reproduce the reference's
``jax.random`` draws).  The KV cache is allocated once per gang at
``cap = max_prompt + max_new`` (ring-bounded for sliding-window layers by
``init_cache``).

Padding is the reference's: prompts are left-padded with token 0, nothing
is masked (padded positions are attended to) and positions start at 0 for
every row.  The engine reads each step's sampled tokens with one host copy
and runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.lm import LM, decode_fn, init_cache, prefill_fn, resolve_device

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [len] int32
    max_new: int = 16
    eos_id: int | None = None
    submitted_at: float = field(default_factory=time.perf_counter)
    tokens: list = field(default_factory=list)
    first_token_at: float | None = None
    done_at: float | None = None


class ServeEngine:
    """Serves ``model`` (a ``repro_torch.models.LM``) on ``device``, by
    default ``cuda:0`` (raises without a GPU); the model must lie there.
    Pass ``device="cpu"`` with a model on the CPU to run on the host."""

    def __init__(self, model: LM, *, max_batch: int = 8,
                 temperature: float = 0.0, seed: int = 0, device=None):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if model.device != dev:
            raise ValueError(f"the model lies on {model.device}, not on "
                             f"the engine's device {dev}")
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.max_batch = max_batch
        self.temperature = temperature
        self._queue: deque[Request] = deque()
        self._next_rid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._prefill = prefill_fn(with_cache=True)
        self._decode = decode_fn()
        self.completed: dict[int, Request] = {}

    def submit(self, prompt, max_new: int = 16,
               eos_id: int | None = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, np.asarray(prompt, np.int32),
                                   max_new, eos_id))
        return rid

    # -- one gang: admit, prefill, decode to completion --

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].to(
            torch.int32)

    def run_once(self) -> list[Request]:
        if not self._queue:
            return []
        with torch.inference_mode():
            return self._run_gang()

    def _run_gang(self) -> list[Request]:
        gang = [self._queue.popleft()
                for _ in range(min(self.max_batch, len(self._queue)))]
        B = len(gang)
        lp = max(len(r.prompt) for r in gang)
        max_new = max(r.max_new for r in gang)
        cap = lp + max_new
        dev = self.device

        # left-pad prompts so every last prompt token sits at index lp-1
        toks = np.zeros((B, lp), np.int32)
        for i, r in enumerate(gang):
            toks[i, lp - len(r.prompt):] = r.prompt

        cache = init_cache(self.cfg, B, cap=cap, device=dev,
                           dtype=self.model.dtype)
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if self.cfg.enc_dec:
            batch["frames"] = torch.zeros((B, lp, self.cfg.d_model),
                                          dtype=torch.float32, device=dev)
        logits, cache = self._prefill(self.model, cache, batch)
        nxt = self._sample(logits)
        first = nxt.tolist()
        now = time.perf_counter()
        for r, tok in zip(gang, first):
            r.first_token_at = now
            r.tokens.append(tok)

        alive = np.ones(B, bool)
        for i, r in enumerate(gang):
            if r.eos_id is not None and r.tokens[-1] == r.eos_id:
                alive[i] = False
        for step in range(max_new - 1):
            if not alive.any():
                break
            dec = {"token": nxt[:, None],
                   "pos": torch.full((B,), lp + step, dtype=torch.int32,
                                     device=dev)}
            if self.cfg.mrope_sections:
                dec["positions"] = torch.full((3, B, 1), lp + step,
                                              dtype=torch.int32, device=dev)
            logits, cache = self._decode(self.model, cache, dec)
            nxt = self._sample(logits)
            for i, tok in enumerate(nxt.tolist()):
                if not alive[i]:
                    continue
                r = gang[i]
                r.tokens.append(tok)
                if (len(r.tokens) >= r.max_new or
                        (r.eos_id is not None and tok == r.eos_id)):
                    alive[i] = False
        now = time.perf_counter()
        for r in gang:
            r.done_at = now
            r.tokens = r.tokens[: r.max_new]
            self.completed[r.rid] = r
        return gang

    def run(self) -> dict:
        """Drain the queue; returns latency/throughput stats."""
        n_tokens = 0
        t0 = time.perf_counter()
        while self._queue:
            for r in self.run_once():
                n_tokens += len(r.tokens)
        dt = time.perf_counter() - t0
        ttfts = [r.first_token_at - r.submitted_at
                 for r in self.completed.values()]
        return {"requests": len(self.completed), "tokens": n_tokens,
                "wall_s": dt, "tok_per_s": n_tokens / max(dt, 1e-9),
                "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0}
