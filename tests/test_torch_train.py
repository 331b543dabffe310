"""The port's training step (``repro_torch.models.lm.loss_fn`` /
``train_step_fn`` and ``repro_torch.train.optimizer.AdamW``) against the
JAX package's, on the CPU, for every assigned architecture at
``reduce_for_smoke`` size.

The weights are the JAX ``init_params`` tree carried across with
``interop.lm_params_from``; the inputs are numpy, from a seed, laid out as
``tests/test_models_smoke.py``'s ``_batch_for`` lays them out.  Bounds:

* float32 loss within ``RTOL_LOSS = 1e-5`` relative (seen: <= 1.5e-7);
* every gradient, mapped with ``lm_state_from``, within ``RTOL_GRAD =
  1e-4`` of the leaf's max abs (seen: <= 3.3e-6), except zamba2's: its six
  random-weight Mamba2 layers are ill-conditioned, and the reference's own
  gradient moves by 1.46e-4 of its ``A_log`` leaf's max under a 1e-7
  relative perturbation of the weights (3.8e-5 between its jitted and
  eager runs), so zamba2 is held within ``RTOL_GRAD_ZAMBA2 = 5e-4`` (seen:
  1.40e-4, layer 0's ``A_log``);
* AdamW fed the JAX gradients: moments after two updates within
  ``RTOL_ADAMW = 1e-6`` of the reference's, elementwise relative, and
  parameters within ``RTOL_ADAMW * (|want| + lr)``: a parameter that an
  update brings near 0 keeps the few-ulp error of its step ``lr * d``
  (|d| ~ 1; seen: 1.2e-10 absolute, gemma3's ``w_down``);
* bfloat16 (gemma2-2b smoke): loss within ``RTOL_LOSS_BF16 = 5e-4``
  (seen: 8.2e-5) and gradients within ``RTOL_GRAD_BF16 = 5e-2`` of the
  leaf's max abs (seen: 1.73e-2; bf16 storage rounds every layer's output
  on both sides, in other places), and AdamW with bf16 moments and weight
  decay within one bf16 ulp (``2**-7`` relative) of the reference's;
* the chunked cross entropy against an unchunked one within 1e-6
  relative; remat (per-group ``checkpoint``) bitwise against the same
  layers run without it.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import lm as J
from repro.train.optimizer import AdamW as JAdamW
from repro_torch import interop
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import lm as T
from repro_torch.train.optimizer import AdamW

RTOL_LOSS = 1e-5
RTOL_GRAD = 1e-4
RTOL_GRAD_ZAMBA2 = 5e-4
RTOL_ADAMW = 1e-6
RTOL_LOSS_BF16 = 5e-4
RTOL_GRAD_BF16 = 5e-2
BF16_ULP = 2.0 ** -7
LR = 1e-3
B, S = 2, 16
CPU = torch.device("cpu")


def batch_for(cfg, key=0) -> dict:
    """numpy inputs as ``tests/test_models_smoke.py:_batch_for`` makes
    them: tokens and labels [B, S], frames, 4 patch embeddings (tokens cut
    to S - 4) and M-RoPE positions where the config has them."""
    rng = np.random.default_rng(key)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)
                                          ).astype(np.float32)
    if cfg.frontend == "patches":
        b["patch_embeds"] = rng.standard_normal((B, 4, cfg.d_model)
                                                ).astype(np.float32)
        b["tokens"] = b["tokens"][:, :S - 4]
    if cfg.mrope_sections:
        b["positions"] = np.broadcast_to(np.arange(S), (3, B, S)
                                         ).astype(np.int32)
    return b


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tt(batch):
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in batch.items()}


def np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def leaf_err(got, want) -> float:
    """max |got - want| over the leaf's max |want|."""
    g = got.detach().float().numpy()
    assert g.shape == want.shape
    return float(np.abs(g - want).max() / max(np.abs(want).max(), 1e-30))


class Pair:
    """One architecture in both packages: configs, the JAX weights and the
    port's model carrying them, one batch, and the JAX loss and grads."""

    def __init__(self, arch, dtype="float32", seed=0, **kw):
        self.jcfg = replace(jax_reduce(jax_config(arch)), dtype=dtype, **kw)
        self.cfg = replace(reduce_for_smoke(get_config(arch)), dtype=dtype,
                           **kw)
        self.params = J.init_params(self.jcfg, jax.random.PRNGKey(seed))
        self.model = interop.lm_params_from(self.cfg, np32(self.params),
                                            device=CPU)
        self.batch = batch_for(self.cfg)
        jb = jx(self.batch)
        self.loss, self.grads = jax.jit(jax.value_and_grad(
            lambda p: J.loss_fn(p, self.jcfg, jb)))(self.params)

    def port_grads(self):
        names, params = zip(*self.model.named_parameters())
        loss = T.loss_fn(self.model, tt(self.batch))
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        return float(loss.detach()), dict(zip(names, grads))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


def test_loss_and_grads_match_reference(pair):
    loss, grads = pair.port_grads()
    want = float(pair.loss)
    assert abs(loss - want) <= RTOL_LOSS * abs(want), (loss, want)
    jg = interop.lm_state_from(pair.cfg, np32(pair.grads))
    assert jg.keys() == grads.keys()
    bound = RTOL_GRAD_ZAMBA2 if pair.cfg.name == "zamba2-7b" else RTOL_GRAD
    errs = {n: leaf_err(grads[n], jg[n]) for n in grads}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= bound, (pair.cfg.name, worst, errs[worst])


def _adamw_pair(pair, dtype_state=None, weight_decay=0.0):
    """Two updates of each package's AdamW with the JAX gradients; the port
    starts from a fresh copy of the carried weights.  Returns the port's
    params and moments and the reference's, as numpy arrays named as the
    port names its parameters."""
    kw = dict(lr=LR, state_dtype=dtype_state, weight_decay=weight_decay)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    jp, js = pair.params, jopt.init(pair.params)
    update = jax.jit(jopt.update)
    for _ in range(2):
        jp, js = update(jp, pair.grads, js)
    model = interop.lm_params_from(pair.cfg, np32(pair.params), device=CPU)
    params = dict(model.named_parameters())
    grads = {n: torch.tensor(g).to(params[n].dtype) for n, g in
             interop.lm_state_from(pair.cfg, np32(pair.grads)).items()}
    state = topt.init(params)
    for _ in range(2):
        topt.update(params, grads, state)
    want = {"params": interop.lm_state_from(pair.cfg, np32(jp)),
            "m": interop.lm_state_from(pair.cfg, np32(js["m"])),
            "v": interop.lm_state_from(pair.cfg, np32(js["v"]))}
    assert int(state["step"]) == int(js["step"]) == 2
    assert state["step"].dtype == torch.int32
    return {"params": params, "m": state["m"], "v": state["v"]}, want


def test_adamw_update_matches_reference(pair):
    got, want = _adamw_pair(pair)
    for key in ("params", "m", "v"):
        step = LR if key == "params" else 0.0
        for n, w in want[key].items():
            g = got[key][n].detach().numpy()
            assert got[key][n].dtype == torch.float32
            ok = np.abs(g - w) <= RTOL_ADAMW * (np.abs(w) + step)
            assert ok.all(), (pair.cfg.name, key, n,
                              float(np.abs(g - w).max()))


@pytest.fixture(scope="module")
def bf16_pair():
    return Pair("gemma2-2b", dtype="bfloat16")


def test_bf16_loss_and_grads_match_reference(bf16_pair):
    p = bf16_pair
    assert p.model.embed.dtype == torch.bfloat16
    loss, grads = p.port_grads()
    want = float(p.loss)
    assert abs(loss - want) <= RTOL_LOSS_BF16 * abs(want)
    jg = interop.lm_state_from(p.cfg, np32(p.grads))
    for n, g in grads.items():
        assert g.dtype == torch.bfloat16
        assert leaf_err(g, jg[n]) <= RTOL_GRAD_BF16, (n, leaf_err(g, jg[n]))


def test_bf16_adamw_with_bf16_moments_matches_reference(bf16_pair):
    """bf16 parameters updated in float32 and rounded once; bf16 moments;
    weight decay added to the step."""
    got, want = _adamw_pair(bf16_pair, "bfloat16", weight_decay=0.1)
    for key in ("params", "m", "v"):
        for n, w in want[key].items():
            assert got[key][n].dtype == torch.bfloat16
            g = got[key][n].detach().float().numpy()
            assert (np.abs(g - w) <= BF16_ULP * np.abs(w)).all(), (key, n)


def test_adamw_grad_transform_hook():
    """``grad_transform.apply(grads, state) -> (grads, state)`` runs before
    the update, and keys it adds to the state survive the step."""
    class Halve:
        def apply(self, grads, state):
            state = dict(state, calls=state.get("calls", 0) + 1)
            return {n: g * 0.5 for n, g in grads.items()}, state

    p = {"w": torch.ones(3)}
    g = {"w": torch.full((3,), 2.0)}
    plain, hooked = AdamW(lr=0.1), AdamW(lr=0.1, grad_transform=Halve())
    sp, sh = plain.init(p), hooked.init(p)
    pp = {"w": p["w"].clone()}
    plain.update(pp, {"w": torch.ones(3)}, sp)
    _, sh = hooked.update(p, g, sh)
    assert sh["calls"] == 1 and int(sh["step"]) == 1
    assert torch.equal(p["w"], pp["w"])
    assert torch.equal(sh["m"]["w"], sp["m"]["w"])


def test_chunked_ce_against_unchunked():
    """S = 1,024: two 512-position chunks, each under ``checkpoint``; the
    value and the gradient w.r.t. the hidden states equal an unchunked CE
    over the full logits (and the reference's ``_chunked_ce``).  S = 1,000
    (S % 512 != 0): one chunk of length S."""
    jcfg = replace(jax_reduce(jax_config("gemma2-2b")), dtype="float32")
    cfg = replace(reduce_for_smoke(get_config("gemma2-2b")), dtype="float32")
    params = J.init_params(jcfg, jax.random.PRNGKey(1))
    model = interop.lm_params_from(cfg, np32(params), device=CPU)
    rng = np.random.default_rng(7)
    calls = []

    def counting(fn, *a, **kw):
        calls.append(a[1].shape[1])
        return torch.utils.checkpoint.checkpoint(fn, *a, **kw)

    for seq, chunks in ((1024, [512, 512]), (1000, [1000])):
        xn = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
        ln = rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32)
        x = torch.tensor(xn, requires_grad=True)
        labels = torch.tensor(ln)
        calls.clear()
        T.checkpoint, saved = counting, T.checkpoint
        try:
            got = T._chunked_ce(model, x, labels)
        finally:
            T.checkpoint = saved
        assert calls == chunks
        (gx,) = torch.autograd.grad(got, x)
        x2 = torch.tensor(xn, requires_grad=True)
        lg = T._logits(model, x2)
        want = (torch.logsumexp(lg, -1) -
                torch.gather(lg, -1, labels[..., None].long())[..., 0]).mean()
        (wx,) = torch.autograd.grad(want, x2)
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
        assert float((gx - wx).abs().max()) <= 1e-6 * float(wx.abs().max())
        ref = float(J._chunked_ce(params, jcfg, jnp.asarray(xn),
                                  jnp.asarray(ln)))
        assert abs(float(got) - ref) <= 1e-6 * abs(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_leaves_gradients_bitwise(arch):
    """Each cycle group runs under ``checkpoint`` when grad is enabled (the
    tail does not); the gradients equal, bit for bit, those of the same
    layers run without it.  Five layers where the cycle has two, so the
    stack has groups and a tail."""
    base = reduce_for_smoke(get_config(arch))
    cyc = len(base.layer_plan()[0])
    kw = {} if base.shared_block_period else {"n_layers": 2 * cyc + 1}
    cfg = replace(base, dtype="float32", **kw)
    cyc, n_groups, tail = cfg.layer_plan()
    model = T.LM(cfg, device=CPU, seed=3)
    batch = tt(batch_for(cfg, key=4))
    names, params = zip(*model.named_parameters())
    groups = []

    def counting(fn, *a, **k):
        if fn is not T._ce_chunk:
            groups.append((a[0], a[1]))
        return torch.utils.checkpoint.checkpoint(fn, *a, **k)

    def plain(fn, *a, **k):
        return fn(*a)

    got = {}
    for name, ck in (("remat", counting), ("plain", plain)):
        T.checkpoint, saved = ck, T.checkpoint
        try:
            loss = T.loss_fn(model, batch)
            got[name] = (loss, torch.autograd.grad(
                loss, params, materialize_grads=True))
        finally:
            T.checkpoint = saved
    n = len(cyc)
    assert groups == [(g * n, (g + 1) * n) for g in range(n_groups)]
    assert torch.equal(got["remat"][0], got["plain"][0])
    for name, a, b in zip(names, got["remat"][1], got["plain"][1]):
        assert torch.equal(a, b), (arch, name)
    groups.clear()
    T.checkpoint, saved = counting, T.checkpoint
    try:
        with torch.no_grad():
            model(batch)
    finally:
        T.checkpoint = saved
    assert not groups                  # no recompute without grad


def test_train_step_updates_in_place(pair):
    """``train_step_fn(AdamW)``: returns the loss (the reference's train
    step's, within RTOL_LOSS), steps the state and moves every parameter
    the loss reaches, in place."""
    opt = AdamW(lr=1e-3)
    model = interop.lm_params_from(pair.cfg, np32(pair.params), device=CPU)
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    state = opt.init(params)
    loss = T.train_step_fn(opt)(model, state, tt(pair.batch))
    want = float(pair.loss)
    assert abs(float(loss) - want) <= RTOL_LOSS * abs(want)
    assert int(state["step"]) == 1
    assert dict(model.named_parameters())["embed"] is params["embed"]
    moved = sum(not torch.equal(p, before[n]) for n, p in params.items())
    assert moved >= len(params) // 2, (moved, len(params))
