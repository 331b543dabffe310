"""The training path of the seven architectures ``chip_smoke.py``'s
``train_width`` phase trains at their published widths on the card
(whisper-tiny, h2o-danube-1.8b, gemma3-4b, zamba2-7b, olmoe-1b-7b,
rwkv6-7b, qwen2-vl-7b), held here on the CPU at ``reduce_for_smoke`` size
against the JAX package, weights carried by ``interop.lm_params_from`` and
inputs seeded with numpy:

* bfloat16 loss and gradients of each against the reference, under
  ``tests/test_torch_train.py``'s gemma2-2b bounds (``RTOL_LOSS_BF16 =
  5e-4`` relative, ``RTOL_GRAD_BF16 = 5e-2`` of each leaf's max abs);
* AdamW with bfloat16 moments (the phase's plan for the four 7 B models)
  against the reference's, within one bf16 ulp;
* ``run_training``'s crash at step 9 and resume from step 8 bitwise for
  olmoe-1b-7b, zamba2-7b and rwkv6-7b;
* Mamba2's chunk gradient: the reference's is NaN once a chunk's decays
  pass float32's exp range (32 tokens at zamba2's smoke size); the
  port's is finite and equals the single-step recurrence's;
* the phase's memory plan on ``meta`` and its inputs' layout;
* ``hlo_analysis.MatmulFlops``'s matrix-product FLOPs (the phase's bound)
  over one train step equal to ``FlopCounterMode``'s and
  ``CollectiveCounter``'s for an MoE, a Mamba2 and an RWKV-6
  architecture, and, split by type, to ``chip_smoke.train_flops`` for
  gemma2-2b.
"""

import sys
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import lm as J
from repro_torch import interop
from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
from repro_torch.configs.base import step_specs
from repro_torch.launch.hlo_analysis import CollectiveCounter, MatmulFlops
from repro_torch.models import lm as T
from repro_torch.models import mamba2
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import (InjectedFailure, TrainLoopConfig,
                                       run_training)
from test_torch_train import (BF16_ULP, LR, RTOL_ADAMW, RTOL_GRAD,
                              RTOL_GRAD_BF16, RTOL_LOSS_BF16, Pair,
                              _adamw_pair, jx, leaf_err, np32, tt)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

CPU = torch.device("cpu")
WIDTH_TRAINED = ("whisper-tiny", "h2o-danube-1.8b", "gemma3-4b", "zamba2-7b",
                 "olmoe-1b-7b", "rwkv6-7b", "qwen2-vl-7b")
BF16_MOMENTS = ("zamba2-7b", "olmoe-1b-7b", "rwkv6-7b", "qwen2-vl-7b")
LEFT_OUT = ("starcoder2-15b", "llama4-maverick-400b-a17b")


@pytest.fixture(scope="module", params=WIDTH_TRAINED)
def bf16_pair(request):
    return Pair(request.param, dtype="bfloat16")


def _worst(got: dict, want: dict) -> tuple:
    errs = {n: leaf_err(torch.as_tensor(got[n]), want[n]) for n in want}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def test_bf16_loss_and_grads_match_reference(bf16_pair):
    """zamba2-7b's gradients are held otherwise: its random Mamba2 stack
    amplifies bf16 rounding past any leaf-relative bound (the reference's
    own jitted and eager bf16 gradients differ by 0.86 of a leaf's max,
    and its bf16 from its f32 ones by 4.3), so the port's bf16 gradients
    must lie no further from the reference's f32 gradients, from the same
    bf16 weights, than the reference's bf16 gradients do."""
    p = bf16_pair
    loss, grads = p.port_grads()
    want = float(p.loss)
    assert abs(loss - want) <= RTOL_LOSS_BF16 * abs(want), (loss, want)
    jg = interop.lm_state_from(p.cfg, np32(p.grads))
    assert jg.keys() == grads.keys()
    if p.cfg.name != "zamba2-7b":
        err, worst = _worst(grads, jg)
        assert err <= RTOL_GRAD_BF16, (p.cfg.name, worst, err)
        return
    f32 = replace(p.jcfg, dtype="float32")
    up = jax.tree.map(lambda a: a.astype(np.float32), p.params)
    jb = jx(p.batch)
    fg = jax.jit(jax.grad(lambda q: J.loss_fn(q, f32, jb)))(up)
    fg = interop.lm_state_from(p.cfg, np32(fg))
    port, ref = _worst(grads, fg), _worst(jg, fg)
    assert port[0] <= ref[0], (port, ref)


@pytest.mark.parametrize("arch", BF16_MOMENTS)
def test_bf16_adamw_with_bf16_moments_matches_reference(arch):
    """bf16 parameters updated in float32 and rounded once; bf16 moments;
    weight decay added to the step: two updates within one bf16 ulp, and a
    parameter that an update brings near 0 within ``RTOL_ADAMW * LR`` (the
    float32 rule of ``test_adamw_update_matches_reference``: it keeps the
    few-ulp error of its step; seen 2.0e-11 on an rwkv6-7b ``lm_head``
    element of 3.7e-10)."""
    got, want = _adamw_pair(Pair(arch, dtype="bfloat16"), "bfloat16",
                            weight_decay=0.1)
    for key in ("params", "m", "v"):
        for n, w in want[key].items():
            t = got[key][n]
            assert key == "params" or t.dtype == torch.bfloat16
            g = t.detach().float().numpy()
            step = RTOL_ADAMW * LR if key == "params" else 0.0
            ok = np.abs(g - w) <= BF16_ULP * np.abs(w) + step
            assert ok.all(), (arch, key, n, float(np.abs(g - w).max()))


@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "zamba2-7b", "rwkv6-7b"))
def test_crash_resume_bitwise(arch, tmp_path):
    """12 steps with a checkpoint every 4, against a run that crashes at
    step 9 and its restart from step 8: parameters and losses 8-11 bit for
    bit, as ``chip_smoke.py``'s ``train_resume`` holds them on the card."""
    cfg = reduce_for_smoke(get_config(arch))
    loop = TrainLoopConfig(steps=12, batch=4, seq=32, lr=1e-3,
                           ckpt_dir=str(tmp_path / "plain"), ckpt_interval=4)
    ref, ref_losses, _ = run_training(cfg, loop, device="cpu")
    crash = replace(loop, ckpt_dir=str(tmp_path / "crash"), fail_at_step=9)
    with pytest.raises(InjectedFailure):
        run_training(cfg, crash, device="cpu")
    res, res_losses, resumed = run_training(
        cfg, replace(crash, fail_at_step=None), device="cpu")
    assert resumed == 8
    assert all(np.isfinite(ref_losses))
    for (n, a), (_, b) in zip(ref.named_parameters(),
                              res.named_parameters()):
        assert torch.equal(a, b), (arch, n)
    assert ref_losses[8:] == res_losses


def test_mamba2_chunk_gradient_finite_past_exp_range():
    """The reference forms ``exp(l_t - l_j)`` above the diagonal too and
    masks the product after, so once a chunk's decays sum past float32's
    exp range there its gradient is 0 * inf = NaN: zamba2 at smoke size
    over 32 tokens (its forward is finite).  The port masks the exponent
    first: the same loss, every gradient finite."""
    jcfg = replace(jax_reduce(jax_config("zamba2-7b")), dtype="float32")
    cfg = replace(reduce_for_smoke(get_config("zamba2-7b")), dtype="float32")
    params = J.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (1, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    jloss, jgrads = jax.value_and_grad(
        lambda p: J.loss_fn(p, jcfg, jx(batch)))(params)
    assert any(np.isnan(np.asarray(g)).any()
               for g in jax.tree.leaves(jgrads))
    model = interop.lm_params_from(cfg, np32(params), device=CPU)
    names, ps = zip(*model.named_parameters())
    loss = T.loss_fn(model, tt(batch))
    grads = torch.autograd.grad(loss, ps, materialize_grads=True)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_mamba2_chunked_gradient_equals_the_recurrence():
    """At 256 tokens (two 128-token chunks, decays past exp's range above
    the diagonal) the chunked block's output and gradients equal those of
    the same block run as 256 single-token decode steps, the recurrence
    ``S_t = a_t S_{t-1} + dt_t x_t B_t`` with ``a_t`` in (0, 1), which
    forms no such exponent: within ``RTOL_GRAD`` of each leaf's max."""
    cfg = replace(reduce_for_smoke(get_config("zamba2-7b")), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = mamba2.Mamba2(cfg, torch.float32, CPU, gen)
    rng = np.random.default_rng(1)
    u0 = torch.tensor(rng.standard_normal((1, 256, cfg.d_model)),
                      dtype=torch.float32)
    r = torch.tensor(rng.standard_normal((1, 256, cfg.d_model)),
                     dtype=torch.float32)
    names, leaves = zip(*p.named_parameters())

    def grads(run):
        u = u0.clone().requires_grad_()
        y = run(u)
        return y.detach(), torch.autograd.grad((y * r).sum(),
                                               (u, *leaves))

    def chunked(u):
        return mamba2.mamba2_block(p, u, cfg)[0]

    def recurrence(u):
        S, conv = mamba2.init_mamba2_state(cfg, 1, CPU)
        ys = []
        for t in range(u.shape[1]):
            y, (S, conv) = mamba2.mamba2_decode(p, u[:, t:t + 1], cfg, S,
                                                conv)
            ys.append(y)
        return torch.cat(ys, dim=1)

    yc, gc = grads(chunked)
    yr, gr = grads(recurrence)
    assert leaf_err(yc, yr.numpy()) <= RTOL_GRAD
    for n, a, b in zip(("u", *names), gc, gr):
        assert bool(torch.isfinite(a).all()), n
        assert leaf_err(a, b.numpy()) <= RTOL_GRAD, (n, leaf_err(a, b.numpy()))


def test_plan_on_meta():
    """The seven architectures planned with f32 moments where 12 B a
    parameter leaves room, else bf16 (8 B a parameter), the 7 B
    models at batch 1 (the cut listed); starcoder2-15b and llama4-maverick
    left out with their bytes; every planned total within the budget less
    the activations the plan assumes."""
    plan = cs.train_width_plan(torch)
    assert set(plan) == set(ARCHS) - {cs.LM_ARCH}
    assert tuple(a for a, e in plan.items() if "moments" in e) == \
        WIDTH_TRAINED
    for arch in WIDTH_TRAINED:
        e = plan[arch]
        small = arch not in BF16_MOMENTS
        assert e["moments"] == ("float32" if small else "bfloat16")
        assert e["seq"] == cs.TRAIN_WIDTH_SEQ == 4096
        assert e["batch"] == (2 if small else 1)
        assert e["reduced"] == ([] if small else ["batch 2 -> 1"])
        assert e["state_bytes"][e["moments"]] + e["batch"] * \
            cs.TRAIN_WIDTH_ROW == e["planned_bytes"] <= cs.TRAIN_WIDTH_BUDGET
    gb = {a: round(plan[a]["state_bytes"]["bfloat16"] / 1e9, 1)
          for a in BF16_MOMENTS}
    assert gb == {"zamba2-7b": 53.1, "olmoe-1b-7b": 55.4, "rwkv6-7b": 60.3,
                  "qwen2-vl-7b": 60.9}
    for arch in LEFT_OUT:
        e = plan[arch]
        assert "moments" not in e
        assert e["state_bytes"]["bfloat16"] + cs.TRAIN_WIDTH_ROW > \
            cs.TRAIN_WIDTH_BUDGET
    assert round(plan["starcoder2-15b"]["state_bytes"]["bfloat16"] / 1e9,
                 1) == 127.6
    assert round(plan["llama4-maverick-400b-a17b"]["weight_bytes"] / 1e9,
                 1) == 801.5


@pytest.mark.parametrize("arch", ("whisper-tiny", "qwen2-vl-7b",
                                  "rwkv6-7b"))
def test_width_batch_is_the_train_cell_layout(arch):
    """The phase's inputs have the keys and shapes of the train_4k cell's
    (``step_specs``), ids as int32; embeddings come as float32."""
    cfg = get_config(arch)
    got = cs._width_batch(np, cfg, 2, 1024, 3)
    want = step_specs(cfg, 1024, 2, "train")
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.shape == tuple(want[k].shape), k
        assert (v.dtype == np.int32) == (want[k].dtype == torch.int32), k


def _step_flops(arch, B, S, mode):
    """One bf16 ``train_step_fn`` step of ``arch`` at smoke size under
    ``mode`` (a fresh model, seed 0; bf16 moments)."""
    cfg = reduce_for_smoke(get_config(arch))
    model = T.LM(cfg, device=CPU, seed=0)
    opt = AdamW(lr=1e-3, state_dtype="bfloat16")
    state = opt.init(dict(model.named_parameters()))
    batch = tt(cs._width_batch(np, cfg, B, S))
    with mode:
        loss = T.train_step_fn(opt)(model, state, batch)
    assert bool(torch.isfinite(loss))
    return cfg, mode


@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "zamba2-7b", "rwkv6-7b"))
def test_counter_flops_equal_flop_counter_mode(arch):
    """256 tokens: two Mamba2 chunks, four RWKV-6 chunks, MoE capacity
    dispatch; the counter's total and its split add up to
    ``FlopCounterMode``'s and to ``CollectiveCounter``'s over the same
    step."""
    _, counter = _step_flops(arch, 2, 256, MatmulFlops())
    _, fc = _step_flops(arch, 2, 256, FlopCounterMode(display=False))
    _, cc = _step_flops(arch, 2, 256, CollectiveCounter())
    assert counter.flops == fc.get_total_flops() == cc.flops > 0
    assert counter.flops_by_dtype == cc.flops_by_dtype
    assert sum(counter.flops_by_dtype.values()) == counter.flops
    assert set(counter.flops_by_dtype) == {"bfloat16", "float32"}


def test_counter_flops_equal_train_flops():
    """gemma2-2b, batch 2 x 1,024 (two CE chunks; its local layers'
    banded attention): the counter's bf16 and f32 FLOPs are
    ``train_flops``'s."""
    cfg, counter = _step_flops("gemma2-2b", 2, 1024, MatmulFlops())
    want = cs.train_flops(cfg, 2, 1024)
    assert counter.flops_by_dtype == {"bfloat16": want["bf16"],
                                      "float32": want["f32"]}
