"""A run with the timed path broken underneath reads as not correct.

Each test skips the harness's look for a card (``run_cell`` on the CPU,
the port's plain PyTorch backend, the cell's mix cut to two districts) and
drives the rest of a run with one fault planted in the program.  The
exchange between chips is not among them: every cell runs on one chip.
"""

import numpy as np
import pytest
from conftest import cells

from hbench import run


def _run(root, cell, seed=2**31 + 5):
    return run.run_cell(cell, seed, 1.0, False, backend="torch",
                        device="cpu", root=root)


@pytest.mark.parametrize("cell", cells())
def test_sound_run_is_correct(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["max_rel_gap"]["value"] <= 1e-12


def _state_unchanged(mp):
    """A fold step that leaves every window's state as it was."""
    from repro_torch.core import engine
    from repro_torch.overload import runtime

    def frozen(M, insts):
        return None

    mp.setattr(engine, "advance_instances", frozen)
    mp.setattr(runtime, "advance_instances", frozen)


def _half_batch(mp):
    """Half of each group's events left out of every batch processed."""
    from repro_torch.core.events import EventBatch

    whole = EventBatch.partition_by_group

    def half(self):
        return {g: b.select(np.arange(0, len(b), 2))
                for g, b in whole(self).items()}

    mp.setattr(EventBatch, "partition_by_group", half)


def _answer_altered(mp):
    """One window in 97 with trends has its COUNT(*) moved by a part in
    10^7 where it is emitted."""
    from repro_torch.core.engine import HamletRuntime

    emit = HamletRuntime._emit
    seen = [0]

    def altered(self, *a, **k):
        vals = emit(self, *a, **k)
        if vals.get("COUNT(*)", 0) > 0:
            seen[0] += 1
            if seen[0] % 97 == 0:
                vals["COUNT(*)"] *= 1 + 1e-7
        return vals

    mp.setattr(HamletRuntime, "_emit", altered)


def _kernel_output_off(mp):
    """The propagation kernels' outputs off by a part in 10^8."""
    from repro_torch.kernels import ops

    for name in ("propagate_batched", "propagate_dense_batched"):
        f = getattr(ops, name)
        mp.setattr(ops, name, lambda *a, _f=f, **k: _f(*a, **k) * (1 + 1e-8))


def _event_dropped(mp):
    """The ingress queue loses one event of each offer."""
    from repro_torch.overload.ingress import IngressQueue

    offer = IngressQueue.offer

    def lossy(self, batch):
        if len(batch) < 2:
            return offer(self, batch)
        return offer(self, batch.select(np.arange(1, len(batch))))

    mp.setattr(IngressQueue, "offer", lossy)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered,
          "kernel_output_off": _kernel_output_off}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", cells())
def test_fault_reads_not_correct(tiny_root, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    out = _run(tiny_root, cell)
    assert not out["correct"]
    assert out["failed"] > 0


def test_dropped_event_reads_not_correct(tiny_root, monkeypatch):
    cell = next(c for c in cells() if c.endswith(".open"))
    _event_dropped(monkeypatch)
    out = _run(tiny_root, cell)
    assert not out["correct"]
    assert out["checks"]["lost_events"]["value"] > 0
