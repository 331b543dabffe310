"""The port's training loop, data pipeline, checkpointing and launcher
(``repro_torch.train``, ``repro_torch.distributed.checkpoint``,
``repro_torch.launch.train``) on the CPU.

* Three steps of the JAX package's ``run_training`` against the port's
  ``train_step_fn`` from the same carried ``init_params(PRNGKey(0))`` on
  the same ``SyntheticLM`` batches, float32: losses within ``RTOL_LOSS =
  1e-5`` relative; then a two-step JAX state (parameters and AdamW
  moments, read from the JAX loop's own checkpoint) carried across with
  ``lm_params_from`` and ``adamw_state_from`` takes the third step within
  the same bound.
* ``SyntheticLM`` batches bitwise equal to the reference's.
* Twins of ``tests/test_train.py`` (loss decreases, crash/resume bitwise,
  latest-checkpoint discovery, straggler fallback) and of
  ``tests/test_serving.py``'s prefetch and checkpoint-manager joins.
* Checkpoints cross between the packages both ways, bfloat16 leaves
  included; an asynchronous save of a model updated in place right after
  it is not torn.
"""

import os
import re
import subprocess
import sys
import threading
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.distributed import checkpoint as jck
from repro.models.lm import init_params
from repro.train import data as jdata
from repro.train import trainer as jtrainer
from repro.train.optimizer import AdamW as JAdamW
from repro_torch import interop
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.distributed.checkpoint import (CheckpointManager,
                                                latest_step,
                                                restore_checkpoint,
                                                save_checkpoint)
from repro_torch.models.lm import train_step_fn
from repro_torch.train.data import PrefetchIterator, SyntheticLM
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import (InjectedFailure, TrainLoopConfig,
                                       run_training)

RTOL_LOSS = 1e-5
ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny_cfg():
    return reduce_for_smoke(get_config("h2o-danube-1.8b"))


def np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_three_steps_match_reference_run_training(tmp_path):
    arch, batch, seq, lr = "h2o-danube-1.8b", 4, 32, 1e-3
    jcfg = replace(jax_reduce(jax_config(arch)), dtype="float32")
    cfg = replace(reduce_for_smoke(get_config(arch)), dtype="float32")
    loop = jtrainer.TrainLoopConfig(steps=3, batch=batch, seq=seq, lr=lr,
                                    ckpt_dir=str(tmp_path / "a"),
                                    ckpt_interval=1000)
    _, want, _ = jtrainer.run_training(jcfg, loop)

    params0 = init_params(jcfg, jax.random.PRNGKey(0))
    model = interop.lm_params_from(cfg, np32(params0), device=CPU)
    opt = AdamW(lr=lr)
    state = opt.init(dict(model.named_parameters()))
    step = train_step_fn(opt)
    src = SyntheticLM(cfg.vocab, batch, seq, seed=0)

    def on(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}

    got = [float(step(model, state, on(src.batch_for_step(i))))
           for i in range(3)]
    assert np.allclose(got, want, rtol=RTOL_LOSS, atol=0), (got, want)

    # carry a two-step JAX state (its own checkpoint at step 2) across
    d = str(tmp_path / "b")
    jtrainer.run_training(jcfg, replace(loop, steps=2, ckpt_dir=d,
                                        ckpt_interval=2))
    like = {"params": params0, "opt": JAdamW(lr=lr).init(params0)}
    two = jck.restore_checkpoint(d, 2, like)
    model2 = interop.lm_params_from(cfg, np32(two["params"]), device=CPU)
    state2 = interop.adamw_state_from(
        cfg, jax.tree.map(np.asarray, two["opt"]), device=CPU)
    assert int(state2["step"]) == 2 and state2["step"].dtype == torch.int32
    assert state2["m"].keys() == dict(model2.named_parameters()).keys()
    third = float(step(model2, state2, on(src.batch_for_step(2))))
    assert abs(third - want[2]) <= RTOL_LOSS * abs(want[2]), (third, want)
    assert int(state2["step"]) == 3


def test_adamw_state_from_keeps_bf16_moments():
    cfg = reduce_for_smoke(get_config("gemma2-2b"))
    jcfg = jax_reduce(jax_config("gemma2-2b"))
    params = init_params(jcfg, jax.random.PRNGKey(0))
    js = JAdamW(state_dtype="bfloat16").init(params)
    js["m"] = jax.tree.map(lambda a: (a + 0.375).astype(a.dtype), js["m"])
    st = interop.adamw_state_from(cfg, jax.tree.map(np.asarray, js),
                                  device="cpu")
    ref = AdamW(state_dtype="bfloat16").init(
        dict(interop.lm_params_from(cfg, np32(params),
                                    device=CPU).named_parameters()))
    assert st["m"].keys() == ref["m"].keys()
    assert all(t.dtype == torch.bfloat16 and bool((t == 0.375).all())
               for t in st["m"].values())
    assert int(st["step"]) == 0


@pytest.mark.parametrize("vocab,batch,seq,seed", [(256, 2, 16, 0),
                                                  (256000, 2, 64, 3),
                                                  (64, 8, 32, 1)])
def test_synthetic_batches_bitwise_equal_reference(vocab, batch, seq, seed):
    ours = SyntheticLM(vocab, batch, seq, seed=seed)
    ref = jdata.SyntheticLM(vocab, batch, seq, seed=seed)
    for step in range(10):
        a, b = ours.batch_for_step(step), ref.batch_for_step(step)
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            assert np.array_equal(a[k], b[k]), (step, k)
    with PrefetchIterator(ours, start_step=4) as it, \
            jdata.PrefetchIterator(ref, start_step=4) as jt:
        for _ in range(3):
            a, b = next(it), next(jt)
            assert np.array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------- twins of test_train.py


def test_loss_decreases(tiny_cfg, tmp_path):
    loop = TrainLoopConfig(steps=30, batch=8, seq=32, ckpt_dir=str(tmp_path),
                           ckpt_interval=1000, lr=3e-3)
    _, losses, _ = run_training(tiny_cfg, loop, device="cpu")
    assert len(losses) == 30
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])


def test_crash_resume_bitwise(tiny_cfg, tmp_path):
    seq, batch, lr = 32, 4, 1e-3
    loop = TrainLoopConfig(steps=12, batch=batch, seq=seq,
                           ckpt_dir=str(tmp_path / "plain"), ckpt_interval=4,
                           lr=lr)
    model_ref, losses_ref, _ = run_training(tiny_cfg, loop, device="cpu")

    crash = replace(loop, ckpt_dir=str(tmp_path / "crash"), fail_at_step=9)
    with pytest.raises(InjectedFailure):
        run_training(tiny_cfg, crash, device="cpu")
    assert latest_step(crash.ckpt_dir) == 8

    # restart: resumes from step 8's checkpoint and finishes
    model_res, losses_res, resumed = run_training(
        tiny_cfg, replace(crash, fail_at_step=None), device="cpu")
    assert resumed == 8
    for (n, a), (_, b) in zip(model_ref.named_parameters(),
                              model_res.named_parameters()):
        assert torch.equal(a, b), n
    assert losses_ref[8:] == losses_res
    # retention keeps the last three checkpoints
    assert sorted(os.listdir(crash.ckpt_dir)) == [
        f"step_{s:010d}" for s in (4, 8, 12)]


def test_latest_checkpoint_discovery(tmp_path):
    """Discovery picks the highest *committed* step among many checkpoints,
    ignoring uncommitted partials and stale .tmp dirs."""
    d = str(tmp_path)
    assert latest_step(d) is None
    tree = {"w": torch.arange(4.0)}
    for step in (4, 12, 8):                  # out of order on purpose
        save_checkpoint(d, step, {"w": tree["w"] * step})
    assert latest_step(d) == 12
    os.makedirs(os.path.join(d, "step_0000000099"))
    os.makedirs(os.path.join(d, "step_0000000050.tmp"))
    assert latest_step(d) == 12
    restored = restore_checkpoint(d, 12, tree)
    assert torch.equal(restored["w"], tree["w"] * 12)


def test_straggler_fallback():
    src = SyntheticLM(vocab=64, batch=2, seq=8, seed=0)
    it = PrefetchIterator(src, timeout_s=0.0)  # force immediate fallback
    b0 = next(it)
    b1 = next(it)
    it.close()
    again = src.batch_for_step(0)
    assert np.array_equal(b0["tokens"], again["tokens"])
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_prefetch_iterator_close_joins_producer():
    before = set(threading.enumerate())
    with PrefetchIterator(SyntheticLM(64, 2, 8), depth=2) as it:
        next(it)
    after = [t for t in threading.enumerate()
             if t not in before and t.is_alive()]
    assert not after, "producer thread survived close()"


def test_checkpoint_manager_close_joins_async_write(tmp_path):
    with CheckpointManager(str(tmp_path), interval=1, keep=2) as mgr:
        mgr.maybe_save(1, {"x": torch.zeros(128)})
    assert latest_step(str(tmp_path)) == 1
    assert not any(t.name == "ckpt-write" for t in threading.enumerate()
                   if t.is_alive())


# ----------------------------------------------------------- checkpoints


def _tree_np(rng):
    """A tree of dicts, a tuple, a list and None with float32, bfloat16 and
    int32 leaves, as numpy (bfloat16 as its float32 values)."""
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = np.asarray(torch.tensor(rng.standard_normal((4, 2)),
                                 dtype=torch.bfloat16).float())
    return {"z": f32, "a": (bf, None, np.arange(6, dtype=np.int32)),
            "m": [np.float32(2.5) * f32[:1]]}


def test_checkpoint_from_the_reference_restores_in_the_port(tmp_path):
    tree = _tree_np(np.random.default_rng(0))
    jtree = {"z": jnp.asarray(tree["z"]),
             "a": (jnp.asarray(tree["a"][0], jnp.bfloat16), None,
                   jnp.asarray(tree["a"][2])),
             "m": [jnp.asarray(tree["m"][0])]}
    jck.save_checkpoint(str(tmp_path), 3, jtree)
    like = {"z": torch.zeros(3, 5), "m": [torch.zeros(1, 5)],
            "a": (torch.zeros(4, 2, dtype=torch.bfloat16), None,
                  torch.zeros(6, dtype=torch.int32))}
    got = restore_checkpoint(str(tmp_path), 3, like)
    assert got["a"][1] is None and isinstance(got["a"], tuple)
    assert got["a"][0].dtype == torch.bfloat16
    assert np.array_equal(got["a"][0].float().numpy(), tree["a"][0])
    assert np.array_equal(got["z"].numpy(), tree["z"])
    assert np.array_equal(got["a"][2].numpy(), tree["a"][2])
    assert np.array_equal(got["m"][0].numpy(), tree["m"][0])


def test_checkpoint_from_the_port_restores_in_the_reference(tmp_path):
    tree = _tree_np(np.random.default_rng(1))
    ttree = {"z": torch.tensor(tree["z"]),
             "a": (torch.tensor(tree["a"][0]).bfloat16(), None,
                   torch.tensor(tree["a"][2])),
             "m": [torch.tensor(tree["m"][0])]}
    save_checkpoint(str(tmp_path), 5, ttree)
    like = {"z": jnp.zeros((3, 5), jnp.float32), "m": [jnp.zeros((1, 5))],
            "a": (jnp.zeros((4, 2), jnp.bfloat16), None,
                  jnp.zeros(6, jnp.int32))}
    assert jck.latest_step(str(tmp_path)) == 5
    got = jck.restore_checkpoint(str(tmp_path), 5, like)
    assert got["a"][0].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(got["a"][0], np.float32),
                          tree["a"][0])
    assert np.array_equal(np.asarray(got["z"]), tree["z"])
    assert np.array_equal(np.asarray(got["a"][2]), tree["a"][2])
    assert np.array_equal(np.asarray(got["m"][0], np.float32), tree["m"][0])


def test_async_save_of_an_in_place_update_is_not_torn(tmp_path,
                                                     monkeypatch):
    """The optimizer writes parameters and moments in place; a save started
    before such writes holds the values at the save, every leaf of them.
    The writer thread is held back until ``wait()``, so the writes surely
    land before it runs."""
    from types import SimpleNamespace

    from repro_torch.distributed import checkpoint as ck

    class Deferred:
        def __init__(self, target, name):
            self.target, self.name = target, name

        def start(self):
            pass

        def join(self):
            self.target()

    monkeypatch.setattr(ck, "threading", SimpleNamespace(Thread=Deferred))
    mgr = CheckpointManager(str(tmp_path), interval=1)
    tree = {"params": {f"w{i}": torch.full((64,), float(i))
                       for i in range(4)},
            "opt": {"step": torch.tensor(1, dtype=torch.int32)}}
    snap = {k: v.clone() for k, v in tree["params"].items()}
    mgr.maybe_save(1, tree)
    for v in tree["params"].values():
        v.add_(1.0)
    tree["opt"]["step"] += 1
    mgr.wait()
    got = restore_checkpoint(str(tmp_path), 1, tree)
    assert int(got["opt"]["step"]) == 1
    for k, v in snap.items():
        assert torch.equal(got["params"][k], v), k


# --------------------------------------------------- launcher and devices


def test_launch_train_prints_the_reference_line(tmp_path, capsys):
    from repro_torch.launch import train

    res = train.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16",
                      "--ckpt", str(tmp_path), "--ckpt-interval", "2"])
    out = capsys.readouterr().out.strip()
    assert re.fullmatch(r"arch=gemma2-2b resumed_from=0 first_loss=\d+\.\d{4}"
                        r" last_loss=\d+\.\d{4}", out), out
    assert res["resumed_from"] == 0 and len(res["losses"]) == 3
    assert latest_step(str(tmp_path)) == 2


def test_launch_train_module_on_the_host(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma2-2b", "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("arch=gemma2-2b resumed_from=0 first_loss=")


def test_train_entry_points_default_to_the_card(tiny_cfg, tmp_path):
    """``run_training``, the launcher and ``adamw_state_from`` run on
    ``cuda:0`` unless told otherwise: without a GPU they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import train

    loop = TrainLoopConfig(steps=1, batch=1, seq=8, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(tiny_cfg, loop)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1", "--ckpt", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.adamw_state_from(tiny_cfg, {"step": 0, "m": {}, "v": {}})
    assert latest_step(str(tmp_path)) is None
