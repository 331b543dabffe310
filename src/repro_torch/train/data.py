"""Synthetic LM data pipeline with host-side prefetch and straggler backup.

The port of ``repro.train.data``, unchanged: numpy batches and a producer
thread (the trainer moves each batch onto the model's device).

A deterministic per-step token stream (seeded by step id, so restarts are
bitwise reproducible), prefetched on a background thread.  If the producer
stalls past ``timeout_s`` (a host-side straggler), the consumer synthesises
the batch inline from the same seed — the step never blocks on a sick host.
"""

from __future__ import annotations

import queue
import threading
import time as _time

import numpy as np

__all__ = ["SyntheticLM", "PrefetchIterator"]


class SyntheticLM:
    """Markov-bigram synthetic corpus: learnable structure, zero deps."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def batch_for_step(self, step: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        base = rng.integers(0, self.vocab, (self.batch, self.seq + 1))
        # inject bigram structure: even tokens are followed by token+1
        nxt = np.where(base[:, :-1] % 2 == 0,
                       (base[:, :-1] + 1) % self.vocab, base[:, 1:])
        tokens = base[:, :-1].astype(np.int32)
        labels = nxt.astype(np.int32)
        return {"tokens": tokens, "labels": labels}


class PrefetchIterator:
    """Prefetch ``depth`` batches ahead; fall back to inline synthesis on a
    producer stall (straggler mitigation)."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2, timeout_s: float = 5.0):
        self.source = source
        self.step = start_step
        self.timeout_s = timeout_s
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next_produce = start_step
        self._stop = False
        self.stall_fallbacks = 0
        # daemon=True is a last-resort backstop for callers that drop the
        # iterator without close(); the supported lifecycle is close()
        # (or a with-block), which joins the thread deterministically
        self._t = threading.Thread(target=self._producer, daemon=True)
        self._t.start()

    def _producer(self):
        while not self._stop:
            b = self.source.batch_for_step(self._next_produce)
            try:
                self._q.put((self._next_produce, b), timeout=0.1)
                self._next_produce += 1
            except queue.Full:
                continue

    def __next__(self) -> dict:
        want = self.step
        try:
            while True:
                got_step, b = self._q.get(timeout=self.timeout_s)
                if got_step == want:
                    break
                if got_step > want:           # queue ran ahead of a restart
                    b = self.source.batch_for_step(want)
                    break
        except queue.Empty:
            # producer straggling: synthesise inline (deterministic)
            self.stall_fallbacks += 1
            b = self.source.batch_for_step(want)
        self.step += 1
        return b

    def close(self, timeout_s: float = 5.0):
        """Stop and join the producer thread (idempotent).

        The producer may be blocked in a bounded ``put``; draining the
        queue while joining guarantees it observes ``_stop`` within one
        put timeout instead of leaking past interpreter teardown.
        """
        self._stop = True
        t = self._t
        if t is None or not t.is_alive():
            return
        deadline = _time.monotonic() + timeout_s
        while t.is_alive() and _time.monotonic() < deadline:
            try:                                   # unblock a full put
                self._q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
        t.join(timeout=max(0.0, deadline - _time.monotonic()))

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
