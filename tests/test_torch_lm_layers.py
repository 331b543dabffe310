"""The port's LM layers against the JAX package's, on the CPU.

Each function of ``repro_torch.models.{layers,moe,mamba2,rwkv6}`` gets the
same inputs (numpy, from a seed) and the same weights (the JAX init
function's, carried across with ``repro_torch.interop``) as its JAX
counterpart.  Tolerances:

* float32: ``|got - want| <= 1e-5 * (1 + |want|)`` elementwise (the two
  frameworks add in other orders and round ``pow``/``exp`` differently);
* bfloat16 spot checks: ``<= 2e-2 * (1 + |want|)`` — a few bf16 roundings
  (8-bit mantissa, 3.9e-3 relative each) that land on other sides in the
  two frameworks.

The banded local path with a short last chunk is held against the
reference's own definition of local attention (``_sdpa`` over the full
mask): the reference's ``sdpa_chunked`` misplaces that chunk's key
positions (a pinned difference, ROADMAP.md queue 3).
"""

from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models import moe as JMoE
from repro.models import rwkv6 as JR
from repro_torch import interop
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import moe as TMoE
from repro_torch.models import rwkv6 as TR

RTOL_F32 = 1e-5
RTOL_BF16 = 2e-2
CPU = torch.device("cpu")


def close(got, want, rtol=RTOL_F32, what=""):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.max(np.abs(g - w) / (1.0 + np.abs(w)))
    assert err <= rtol, (what, err)
    return err


def configs(arch, dtype="float32", **kw):
    """The JAX and port smoke configs of ``arch`` (equal values)."""
    return (replace(jax_reduce(jax_config(arch)), dtype=dtype, **kw),
            replace(reduce_for_smoke(get_config(arch)), dtype=dtype, **kw))


def port(module, tree):
    """``module`` loaded with the JAX parameter tree ``tree``."""
    state = interop.tree_state(jax.tree.map(
        lambda a: np.asarray(a, np.float32), tree))
    return interop.load_state(module, state)


def arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both(a, dtype="float32"):
    """``a`` as a JAX array and a torch tensor of ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


# ------------------------------------------------------------------ basics


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = arr(rng, 2, 5, 16), arr(rng, 16, scale=0.1)
    close(TL.rms_norm(torch.tensor(x), torch.tensor(s), 1e-6),
          JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = arr(rng, 2, 6, 4, 16)
    pos = rng.integers(0, 5000, (2, 6)).astype(np.int32)
    close(TL.apply_rope(torch.tensor(x), torch.tensor(pos), theta),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_mrope():
    rng = np.random.default_rng(2)
    x = arr(rng, 2, 6, 4, 16)
    pos = rng.integers(0, 300, (3, 2, 6)).astype(np.int32)
    close(TL.apply_mrope(torch.tensor(x), torch.tensor(pos), 1e6, (2, 3, 3)),
          JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (2, 3, 3)))


def test_sincos_positions_are_the_reference_table():
    got = TL.sincos_positions(10, 64, offset=3).numpy()
    want = np.asarray(JL.sincos_positions(10, 64, offset=3))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


# --------------------------------------------------------------- attention


def _qkv(rng, B, S, T, H, KV, hd, dtype="float32"):
    return [both(arr(rng, B, n, h, hd), dtype)
            for n, h in ((S, H), (T, KV), (T, KV))]


@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("kind", ["causal", "local"])
def test_sdpa(softcap, kind):
    rng = np.random.default_rng(3)
    W = 5
    cfg = SimpleNamespace(attn_logit_softcap=softcap, window=W)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 12, 12, 4, 2, 8)
    qp, kp = np.arange(12)[:, None], np.arange(12)[None, :]
    m = kp <= qp
    if kind == "local":
        m &= kp > qp - W
    close(TL._sdpa(tq, tk, tv, torch.tensor(m)[None, None, None], cfg),
          JL._sdpa(jq, jk, jv, jnp.asarray(m)[None, None, None], cfg))


def _mask_fns(W, local):
    def jmask(qpos, kpos):
        qp, kp = qpos[:, None], kpos[None, :]
        m = (kp <= qp) & (kpos >= 0)[None, :]
        return m & (jnp.abs(kp - qp) < W) if local else m

    def tmask(qpos, kpos):
        qp, kp = qpos[:, None], kpos[None, :]
        m = (kp <= qp) & (kpos >= 0)[None, :]
        return m & (torch.abs(kp - qp) < W) if local else m

    return jmask, tmask


@pytest.mark.parametrize("path,S,local", [
    ("one chunk", 48, False),
    ("stacked chunks", 256, False),
    ("chunks with a remainder", 200, False),
    ("banded local", 256, True),
    ("banded local, one chunk", 60, True),
])
def test_sdpa_chunked_paths(path, S, local):
    """Each path of ``sdpa_chunked`` (chunk 64; window 48 for the banded
    path, where window + chunk < T) against the reference's."""
    rng = np.random.default_rng(4)
    W = 48
    cfg = SimpleNamespace(attn_logit_softcap=50.0, window=W)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, S, S, 4, 2, 8)
    jmask, tmask = _mask_fns(W, local)
    lw = W if local else None
    got = TL.sdpa_chunked(tq, tk, tv, cfg, tmask, chunk=64, local_window=lw)
    want = JL.sdpa_chunked(jq, jk, jv, cfg, jmask, chunk=64, local_window=lw)
    close(got, want, what=path)


@pytest.mark.parametrize("S", [200, 257])
def test_banded_local_with_a_remainder_follows_the_full_mask(S):
    """Banded local attention whose last chunk is short: the port equals
    the reference's full-mask ``_sdpa`` on every row.  The reference's
    ``sdpa_chunked`` takes that chunk's band from a clamped slice but keeps
    the unclamped key positions, so its last rows differ (pinned)."""
    rng = np.random.default_rng(5)
    W = 48
    cfg = SimpleNamespace(attn_logit_softcap=None, window=W)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, S, S, 4, 2, 8)
    jmask, tmask = _mask_fns(W, True)
    got = TL.sdpa_chunked(tq, tk, tv, cfg, tmask, chunk=64, local_window=W)
    m = jmask(jnp.arange(S), jnp.arange(S))
    want = JL._sdpa(jq, jk, jv, m[None, None, None], cfg)
    close(got, want)
    ref_chunked = np.asarray(JL.sdpa_chunked(jq, jk, jv, cfg, jmask, chunk=64,
                                             local_window=W))
    tail = S - S % 64
    assert np.allclose(ref_chunked[:, :tail], np.asarray(want)[:, :tail],
                       atol=1e-5)
    assert not np.allclose(ref_chunked[:, tail:], np.asarray(want)[:, tail:],
                           atol=1e-2)


@pytest.mark.parametrize("mode", ["causal", "local", "bidirectional",
                                  "decode", "cross"])
def test_attention_block(mode):
    jcfg, tcfg = configs("gemma3-4b")             # QK-norm, local theta
    p = JL.init_attention(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = port(TL.Attention(tcfg, torch.float32, CPU), p)
    rng = np.random.default_rng(6)
    B, S = 2, 12
    jx, tx = both(arr(rng, B, S, tcfg.d_model))
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jpos, tpos = jnp.asarray(pos), torch.tensor(pos)
    kind = "local" if mode == "local" else "global"
    kw_j, kw_t = {}, {}
    if mode == "bidirectional":
        kw_j = kw_t = {"causal": False}
    if mode == "cross":
        je, te = both(arr(rng, B, 7, tcfg.d_model))
        kw_j, kw_t = {"kv_from": je}, {"kv_from": te}
    if mode == "decode":
        ck = arr(rng, B, S, tcfg.n_kv_heads, tcfg.head_dim)
        cv = arr(rng, B, S, tcfg.n_kv_heads, tcfg.head_dim)
        cp = np.array([5, 9], np.int32)
        jx, tx = jx[:, :1], tx[:, :1]
        jpos, tpos = jnp.asarray(cp[:, None]), torch.tensor(cp[:, None])
        kw_j = {"cache": {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                "cache_pos": jnp.asarray(cp)}
        kw_t = {"cache": {"k": torch.tensor(ck), "v": torch.tensor(cv)},
                "cache_pos": torch.tensor(cp)}
    got, gkv = TL.attention_block(tp, tx, tcfg, kind, tpos, **kw_t)
    want, wkv = JL.attention_block(p, jx, jcfg, kind, jpos, **kw_j)
    close(got, want, what=mode)
    for key in ("k", "v"):
        close(gkv[key], wkv[key], what=key)
    if mode == "decode":                  # the given cache is not changed
        assert np.array_equal(kw_t["cache"]["k"].numpy(), ck)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False)])
def test_mlp(act, gated):
    p = JL.init_mlp(jax.random.PRNGKey(1), 64, 128, gated, jnp.float32)
    tp = port(TL.MLP(64, 128, gated, torch.float32, CPU), p)
    rng = np.random.default_rng(7)
    jx, tx = both(arr(rng, 2, 9, 64))
    close(TL.mlp_block(tp, tx, act), JL.mlp_block(p, jx, act))


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    assert torch.allclose(TL._act("gelu")(x),
                          torch.nn.functional.gelu(x, approximate="tanh"))
    assert not torch.allclose(TL._act("gelu")(x),
                              torch.nn.functional.gelu(x), atol=1e-5)


# --------------------------------------------------------------------- MoE


@pytest.mark.parametrize("arch,cap,S", [
    ("olmoe-1b-7b", 0.5, 16),                     # prefill, capacity drops
    ("olmoe-1b-7b", 1.25, 1),                     # decode: over the batch
    ("llama4-maverick-400b-a17b", 1.25, 12),      # top-1 + shared expert
])
def test_moe_block(arch, cap, S):
    jcfg, tcfg = configs(arch, capacity_factor=cap)
    p = JMoE.init_moe(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = port(TMoE.MoE(tcfg, torch.float32, CPU), p)
    rng = np.random.default_rng(8)
    jx, tx = both(arr(rng, 3, S, tcfg.d_model))
    got, gaux = TMoE.moe_block(tp, tx, tcfg)
    want, waux = JMoE.moe_block(p, jx, jcfg)
    close(got, want)
    close(gaux, waux)
    if cap < 1:                                   # some tokens were dropped
        N, k, E = S, tcfg.top_k, tcfg.n_experts
        assert N * k > E * int(np.ceil(N * k * cap / E))


# ------------------------------------------------------------- recurrences


def test_mamba2_block_and_decode():
    """Two SSD chunks (T = 256) from a carried state and conv state, then
    four decode steps, all against the reference."""
    jcfg, tcfg = configs("zamba2-7b")
    p = JM.init_mamba2(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = port(TM.Mamba2(tcfg, torch.float32, CPU), p)
    rng = np.random.default_rng(9)
    B, T = 2, 256
    H, hd, st = tcfg.ssm_heads, tcfg.d_inner // tcfg.ssm_heads, tcfg.ssm_state
    ju, tu = both(arr(rng, B, T, tcfg.d_model, scale=0.5))
    jS, tS = both(arr(rng, B, H, hd, st, scale=0.1))
    jc, tc = both(arr(rng, B, tcfg.ssm_conv - 1, tcfg.d_inner, scale=0.1))
    got, (gS, gc) = TM.mamba2_block(tp, tu, tcfg, tS, tc)
    want, (wS, wc) = JM.mamba2_block(p, ju, jcfg, jS, jc)
    close(got, want)
    close(gS, wS)
    close(gc, wc)
    for t in range(4):
        jx, tx = both(arr(rng, B, 1, tcfg.d_model, scale=0.5))
        got, (gS, gc) = TM.mamba2_decode(tp, tx, tcfg, gS, gc)
        want, (wS, wc) = JM.mamba2_decode(p, jx, jcfg, wS, wc)
        close(got, want, what=t)
        close(gS, wS, what=t)


def test_mamba2_asserts_whole_chunks():
    _, tcfg = configs("zamba2-7b")
    tp = TM.Mamba2(tcfg, torch.float32, CPU)
    with pytest.raises(AssertionError):
        TM.mamba2_block(tp, torch.zeros(1, 130, tcfg.d_model), tcfg)


def test_rwkv6_block_and_decode():
    """Three WKV chunks (T = 192) from a carried state, then four decode
    steps, all against the reference."""
    jcfg, tcfg = configs("rwkv6-7b")
    p = JR.init_rwkv6(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = port(TR.RWKV6(tcfg, torch.float32, CPU), p)
    rng = np.random.default_rng(10)
    B, T, d = 2, 192, tcfg.d_model
    H = d // tcfg.rwkv_head_size
    hs = tcfg.rwkv_head_size
    ju, tu = both(arr(rng, B, T, d, scale=0.5))
    st = [both(arr(rng, B, d, scale=0.5)),
          both(arr(rng, B, H, hs, hs, scale=0.1)),
          both(arr(rng, B, d, scale=0.5))]
    got, gst = TR.rwkv6_block(tp, tu, tcfg, tuple(s[1] for s in st))
    want, wst = JR.rwkv6_block(p, ju, jcfg, tuple(s[0] for s in st))
    close(got, want)
    for g, w in zip(gst, wst):
        close(g, w)
    for t in range(4):
        jx, tx = both(arr(rng, B, 1, d, scale=0.5))
        got, gst = TR.rwkv6_decode(tp, tx, tcfg, gst)
        want, wst = JR.rwkv6_decode(p, jx, jcfg, wst)
        close(got, want, what=t)
        close(gst[1], wst[1], what=t)


def test_rwkv6_asserts_whole_chunks():
    _, tcfg = configs("rwkv6-7b")
    tp = TR.RWKV6(tcfg, torch.float32, CPU)
    with pytest.raises(AssertionError):
        TR.rwkv6_block(tp, torch.zeros(1, 70, tcfg.d_model), tcfg)


# ------------------------------------------------------------------- bf16


def test_bf16_spot_checks():
    """bf16 storage, float32 accumulation where the reference asks for it:
    the MLP, attention (softcapped) and both recurrences within
    ``RTOL_BF16``."""
    rng = np.random.default_rng(11)
    bf = "bfloat16"
    p = JL.init_mlp(jax.random.PRNGKey(5), 64, 128, True, jnp.bfloat16)
    tp = port(TL.MLP(64, 128, True, torch.bfloat16, CPU), p)
    jx, tx = both(arr(rng, 2, 9, 64), bf)
    close(TL.mlp_block(tp, tx, "gelu"), JL.mlp_block(p, jx, "gelu"),
          RTOL_BF16, "mlp")

    cfg = SimpleNamespace(attn_logit_softcap=50.0, window=8)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 16, 16, 4, 2, 16, bf)
    m = np.tril(np.ones((16, 16), bool))
    got = TL._sdpa(tq, tk, tv, torch.tensor(m)[None, None, None], cfg)
    assert got.dtype == torch.bfloat16
    close(got, JL._sdpa(jq, jk, jv, jnp.asarray(m)[None, None, None], cfg),
          RTOL_BF16, "sdpa")

    jcfg, tcfg = configs("zamba2-7b", dtype=bf)
    p = JM.init_mamba2(jax.random.PRNGKey(6), jcfg, jnp.bfloat16)
    tp = port(TM.Mamba2(tcfg, torch.bfloat16, CPU), p)
    ju, tu = both(arr(rng, 2, 128, tcfg.d_model, scale=0.5), bf)
    close(TM.mamba2_block(tp, tu, tcfg)[0], JM.mamba2_block(p, ju, jcfg)[0],
          RTOL_BF16, "mamba2")

    jcfg, tcfg = configs("rwkv6-7b", dtype=bf)
    p = JR.init_rwkv6(jax.random.PRNGKey(7), jcfg, jnp.bfloat16)
    tp = port(TR.RWKV6(tcfg, torch.bfloat16, CPU), p)
    ju, tu = both(arr(rng, 2, 64, tcfg.d_model, scale=0.5), bf)
    close(TR.rwkv6_block(tp, tu, tcfg)[0], JR.rwkv6_block(p, ju, jcfg)[0],
          RTOL_BF16, "rwkv6")
