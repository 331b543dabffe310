"""The port's LM (``repro_torch.models.lm``) against the JAX package's, on
the CPU, for every assigned architecture at ``reduce_for_smoke`` size.

The weights are the JAX ``init_params`` tree carried across with
``interop.lm_params_from``; the inputs are numpy, from a seed.  Float32,
with ``|got - want| <= RTOL * (1 + |want|)`` elementwise:

* ``RTOL = 1e-4`` against the reference: the forward logits, the cache
  after prefill (K/V, Mamba and RWKV states, cross K/V; ring positions and
  ``x_len`` exactly), and the logits of one decode step from it (the two
  frameworks add in other orders through a few layers; the largest error
  seen is ~2e-5, zamba2's SSD);
* ``2e-3`` for the port's own prefill-plus-decode against its forward, the
  bound of the reference's ``test_smoke_decode_consistency`` (with its
  ``capacity_factor=8.0``, so no MoE token is dropped either way);
* bfloat16: ``RTOL_BF16 = 6e-2`` for the forward logits against the
  reference's bf16 forward (bf16 storage rounds every layer's output, and
  XLA keeps some bf16 elementwise chains in float32; the largest error
  seen is 4.2e-2, qwen2-vl).  zamba2 is held layer by layer instead,
  each layer fed the reference's own input, within ``RTOL_BF16_LAYER =
  3e-2`` (seen: 2.3e-2, one bf16 ulp of the layer's output): its six
  random-weight Mamba2 layers amplify a one-ulp difference ~5x a layer,
  to 0.34 at the logits.
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
from repro_torch import interop
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import layers as TL
from repro_torch.models.lm import (LM, decode_fn, init_cache, prefill_fn,
                                   resolve_device)

RTOL = 1e-4
RTOL_SELF = 2e-3
RTOL_BF16 = 6e-2
RTOL_BF16_LAYER = 3e-2
B, S = 2, 16
N_VIS = 4                              # qwen2-vl's stub patch embeddings
CPU = torch.device("cpu")


def err(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.max(np.abs(g - w) / (1.0 + np.abs(w)))) if w.size \
        else 0.0


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


class Pair:
    """One architecture in both packages: configs, weights, inputs."""

    def __init__(self, arch, dtype="float32", seed=1, **kw):
        self.arch = arch
        self.jcfg = replace(jax_reduce(jax_config(arch)), dtype=dtype, **kw)
        self.cfg = replace(reduce_for_smoke(get_config(arch)), dtype=dtype,
                           **kw)
        self.params = J.init_params(self.jcfg, jax.random.PRNGKey(seed))
        self.tree = numpy_tree(self.params)
        self.model = interop.lm_params_from(self.cfg, self.tree, device=CPU)

    def inputs(self, T, n_dec=0, seed=3):
        """numpy batches over T positions: ``full`` (all T), ``pre`` (the
        first T - n_dec) and ``dec[j]`` (position T - n_dec + j)."""
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        n_vis = N_VIS if cfg.frontend == "patches" else 0
        toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
        full = {"tokens": toks[:, :T - n_vis]}
        pre = {"tokens": toks[:, :T - n_vis - n_dec]}
        dec = [{"token": toks[:, T - n_vis - n_dec + j][:, None],
                "pos": np.full((B,), T - n_dec + j, np.int32)}
               for j in range(n_dec)]
        if cfg.enc_dec:
            frames = rng.standard_normal((B, T - n_dec, cfg.d_model)
                                         ).astype(np.float32)
            full["frames"] = pre["frames"] = frames
        if n_vis:
            pe = rng.standard_normal((B, n_vis, cfg.d_model)
                                     ).astype(np.float32)
            full["patch_embeds"] = pre["patch_embeds"] = pe
        if cfg.mrope_sections:
            P = np.broadcast_to(np.arange(T), (3, B, T)).astype(np.int32)
            full["positions"] = P
            pre["positions"] = P[:, :, :T - n_dec]
            for j, d in enumerate(dec):
                d["positions"] = P[:, :, T - n_dec + j:T - n_dec + j + 1]
        return full, pre, dec


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tt(batch):
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in batch.items()}


def unstack_cache(cfg, cache) -> list[dict]:
    """The reference's stacked cache as one dict of numpy arrays a layer,
    in layer order (the port's layout)."""
    cyc, n_groups, tail = cfg.layer_plan()
    out = [None] * cfg.n_layers
    for ci, c in enumerate(cache["scan"]):
        for g in range(n_groups):
            out[g * len(cyc) + ci] = jax.tree.map(
                lambda a: np.asarray(a[g], np.float32), c)
    for i, c in enumerate(cache["tail"]):
        out[n_groups * len(cyc) + i] = jax.tree.map(
            lambda a: np.asarray(a, np.float32), c)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


@pytest.fixture(scope="module")
def prefilled(pair):
    """Both packages' caches after prefilling S tokens, and one decode
    step's logits from each."""
    full, pre, dec = pair.inputs(S + 1, n_dec=1)
    jc = J.init_cache(pair.jcfg, B, cap=S + 1)
    jlast, jc = J.prefill_fn(pair.jcfg, with_cache=True)(pair.params, jc,
                                                         jx(pre))
    wcache = unstack_cache(pair.jcfg, jc)
    jdec, _ = J.decode_fn(pair.jcfg)(pair.params, jc, jx(dec[0]))
    with torch.inference_mode():
        tc = init_cache(pair.cfg, B, S + 1, device=CPU)
        tlast, tc = prefill_fn(with_cache=True)(pair.model, tc, tt(pre))
        gcache = [{k: (tuple(x.clone() for x in v) if isinstance(v, tuple)
                       else v.clone()) for k, v in c.items()} for c in tc]
        tdec, tc = decode_fn()(pair.model, tc, tt(dec[0]))
    return {"want_last": jlast, "got_last": tlast, "want": wcache,
            "got": gcache, "want_dec": jdec, "got_dec": tdec}


def test_forward_matches_reference(pair):
    full, _, _ = pair.inputs(S)
    want, _, _ = J.forward(pair.params, pair.jcfg, jx(full))
    with torch.inference_mode():
        got, aux, _ = pair.model(tt(full))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert err(got, want) <= RTOL, (pair.arch, err(got, want))


def test_prefill_cache_matches_reference(pair, prefilled):
    """Every layer's cache after prefill: K/V (ring slots for local
    layers), ring positions, Mamba (S, conv) and RWKV (last x, S, last h)
    states, cross K/V and ``x_len``."""
    assert err(prefilled["got_last"], prefilled["want_last"]) <= RTOL
    got, want = prefilled["got"], prefilled["want"]
    assert len(got) == len(want) == pair.cfg.n_layers
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), (pair.arch, i, g.keys(), w.keys())
        for key in g:
            gs = g[key] if isinstance(g[key], tuple) else (g[key],)
            ws = w[key] if isinstance(w[key], tuple) else (w[key],)
            assert len(gs) == len(ws)
            for a, b in zip(gs, ws):
                if key in ("pos", "x_len"):
                    assert np.array_equal(a.numpy(), b), (pair.arch, i, key)
                else:
                    assert err(a, b) <= RTOL, (pair.arch, i, key, err(a, b))


def test_decode_matches_reference(pair, prefilled):
    e = err(prefilled["got_dec"], prefilled["want_dec"])
    assert e <= RTOL, (pair.arch, e)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_forward(arch):
    """The port alone: prefill S tokens, decode tokens S and S + 1; each
    step's logits equal the forward over S + 2 at that position.  The
    second step reads what the first wrote (ring slots, states, and for
    whisper the cross K/V, which the reference's decode step drops)."""
    p = Pair(arch, seed=2, capacity_factor=8.0)
    full, pre, dec = p.inputs(S + 2, n_dec=2)
    with torch.inference_mode():
        want, _, _ = p.model(tt(full))
        cache = init_cache(p.cfg, B, S + 2, device=CPU)
        _, cache = prefill_fn(with_cache=True)(p.model, cache, tt(pre))
        for j, d in enumerate(dec):
            got, cache = decode_fn()(p.model, cache, tt(d))
            e = err(got, want[:, S + j])
            assert e < RTOL_SELF, (arch, j, e)
    if p.cfg.enc_dec:
        assert {"xk", "xv", "x_len"} <= cache[0].keys()


@pytest.mark.parametrize("arch", ["gemma2-2b", "h2o-danube-1.8b"])
def test_banded_prefill_and_ring_wrap(arch):
    """Prompts past one query chunk plus the window (T = 1100 > 512 + 8):
    the banded local prefill with a short last chunk, the chunked global
    prefill, and a ring of 8 slots that has wrapped; decode token 1100
    equals the forward over 1101 (whose last chunk is short too)."""
    p = Pair(arch, seed=4)
    T = 1101
    full, pre, dec = p.inputs(T, n_dec=1)
    with torch.inference_mode():
        want, _, _ = p.model(tt(full), last_only=True)
        cache = init_cache(p.cfg, B, T, device=CPU)
        _, cache = prefill_fn(with_cache=True)(p.model, cache, tt(pre))
        got, cache = decode_fn()(p.model, cache, tt(dec[0]))
    assert err(got, want[:, -1]) < RTOL_SELF
    ring = [c["pos"] for c in cache if "pos" in c]
    assert ring and all(int(r.max()) == T - 1 and int(r.min()) == T - 8
                        for r in ring)
    assert T > TL.ATTN_Q_CHUNK + p.cfg.window and (T - 1) % TL.ATTN_Q_CHUNK


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference(arch):
    p = Pair(arch, dtype="bfloat16", seed=5)
    assert p.model.embed.dtype == torch.bfloat16
    full, _, _ = p.inputs(S)
    want, _, _ = J.forward(p.params, p.jcfg, jx(full))
    with torch.inference_mode():
        got, _, _ = p.model(tt(full))
    assert bool(torch.isfinite(got).all()) and got.shape == want.shape
    if arch != "zamba2-7b":
        assert err(got, want) <= RTOL_BF16, (arch, err(got, want))
        return
    from repro_torch.models import lm as T

    x, positions = J._embed_inputs(p.params, p.jcfg, jx(full))
    _, tpos = T._embed_inputs(p.model, tt(full))
    cyc, n_groups, _ = p.jcfg.layer_plan()
    shared = p.params["shared_block"]
    with torch.inference_mode():
        for g in range(n_groups):
            for ci, kind in enumerate(cyc):
                lp = jax.tree.map(lambda a: a[g], p.params["scan"][ci])
                xin = torch.tensor(np.asarray(x, np.float32)).bfloat16()
                y, _ = T._layer_apply(p.model.layers[g * len(cyc) + ci], xin,
                                      p.cfg, kind, tpos,
                                      p.model.shared_block, None, None, None,
                                      False, True)
                x, _, _ = J._layer_apply(lp, x, p.jcfg, kind, positions,
                                         shared, None, None, None, False,
                                         True)
                assert err(y, x) <= RTOL_BF16_LAYER, (kind, err(y, x))


def test_lm_params_from_round_trips_every_leaf(pair):
    """Every leaf of the JAX tree lands, unstacked, on the parameter of the
    same name; every parameter of the port comes from a leaf."""
    state = interop.lm_state_from(pair.cfg, pair.tree)
    params = dict(pair.model.named_parameters())
    assert state.keys() == params.keys()
    n_tree = sum(a.size for a in jax.tree.leaves(pair.tree))
    assert n_tree == sum(p.numel() for p in params.values())
    for name, a in state.items():
        assert np.array_equal(params[name].detach().numpy(), a), name
    with pytest.raises(ValueError):
        interop.load_state(pair.model, dict(list(state.items())[1:]))


def test_model_defaults_to_the_card():
    """The model, its cache and ``interop.lm_params_from`` run on ``cuda:0``
    unless told otherwise: without a GPU they raise; on the host only when
    asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reduce_for_smoke(get_config("gemma2-2b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.lm_params_from(cfg, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == CPU
    m = LM(cfg, device="cpu")
    assert m.device == CPU and m.embed.dtype == torch.bfloat16
    assert LM(cfg, device="cpu", dtype="float32").embed.dtype == \
        torch.float32
    assert all(c["k"].device == CPU for c in init_cache(cfg, 1, 4,
                                                        device="cpu"))


def test_random_init_is_seeded():
    cfg = reduce_for_smoke(get_config("zamba2-7b"))
    a, b = LM(cfg, device="cpu", seed=3), LM(cfg, device="cpu", seed=3)
    c = LM(cfg, device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
