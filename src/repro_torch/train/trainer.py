"""Fault-tolerant training loop: the port of ``repro.train.trainer``.

* the train step (loss + grads + AdamW, :func:`~repro_torch.models.lm.
  train_step_fn`), updating the model and optimizer state in place,
* periodic asynchronous checkpoints (CheckpointManager) of ``{"params",
  "opt"}``,
* crash/preemption recovery: on start, restore the latest committed
  checkpoint and resume from its step — bitwise identical to an
  uninterrupted run (the data pipeline is step-seeded),
* optional failure injection for tests (``fail_at_step``),
* host-side straggler mitigation via the prefetching data iterator.

The model runs on ``cuda:0`` unless the caller passes another ``device``;
without a GPU it raises.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field

import torch

from ..distributed.checkpoint import CheckpointManager
from ..models.lm import LM, resolve_device, train_step_fn
from ..train.data import PrefetchIterator, SyntheticLM
from ..train.optimizer import AdamW

__all__ = ["TrainLoopConfig", "InjectedFailure", "run_training"]


class InjectedFailure(RuntimeError):
    pass


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainLoopConfig:
    steps: int = 50
    batch: int = 8
    seq: int = 64
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    ckpt_interval: int = 10
    lr: float = 1e-3
    fail_at_step: int | None = None
    seed: int = 0


def run_training(cfg_model, loop: TrainLoopConfig, *, device=None):
    """Returns (model, losses list, resumed_from_step).  The model is
    ``LM(cfg_model, device=device, seed=loop.seed)``, trained in place."""
    dev = resolve_device(device)
    opt = AdamW(lr=loop.lr)
    step_fn = train_step_fn(opt)

    model = LM(cfg_model, device=dev, seed=loop.seed)
    params = dict(model.named_parameters())
    opt_state = opt.init(params)

    mgr = CheckpointManager(loop.ckpt_dir, interval=loop.ckpt_interval)
    start = 0
    step0, restored = mgr.restore_latest({"params": params, "opt": opt_state})
    if step0 is not None:
        start = step0
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(restored["params"][name])
        opt_state = restored["opt"]

    src = SyntheticLM(cfg_model.vocab, loop.batch, loop.seq, seed=loop.seed)
    it = PrefetchIterator(src, start_step=start)
    losses = []
    try:
        for step in range(start, loop.steps):
            if loop.fail_at_step is not None and step == loop.fail_at_step:
                raise InjectedFailure(f"injected failure at step {step}")
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(it).items()}
            loss = step_fn(model, opt_state, batch)
            losses.append(float(loss))
            mgr.maybe_save(step + 1, {"params": params, "opt": opt_state})
    finally:
        # join the in-flight async write even when crashing out: an
        # immediate restart must discover the highest committed step, not
        # race the background thread for it
        mgr.wait()
        it.close()
    return model, losses, start
