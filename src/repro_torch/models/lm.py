"""Unified LM assembly for the assigned architecture pool.

The port of ``repro.models.lm``: the model, caches, serving steps and the
training step (loss with a chunked cross entropy, gradients by autograd,
an optimizer update).  A model
(:class:`LM`) holds its layers in one ``nn.ModuleList`` in layer order: the
reference's scanned cycle groups unstacked (layer ``g * len(cycle) + ci``
is group g's ``ci``-th layer), then its unrolled tail.  Layer kinds:

    "global" / "local"            GQA attention (full / sliding window) + MLP
    "global+moe" / "local+moe"    attention + MoE FFN
    "mamba2"                      Mamba2/SSD block
    "mamba2+shared"               Mamba2 + the weight-tied shared attention
                                  block (zamba2)
    "rwkv6"                       RWKV-6 time mix + channel mix

Steps: ``train`` (:func:`train_step_fn`: loss + grads + optimizer update,
in place), ``prefill`` (forward; can also fill the decode cache) and
``decode`` (one token against the cache; local layers use a ring buffer
bounded by the window).  With grad enabled a forward recomputes each cycle
group's activations in the backward (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` per scanned group), and the loss projects
onto the vocabulary one 512-position chunk at a time.  Encoder-decoder
(whisper) runs a bidirectional encoder over stub frame embeddings and a
causal decoder with cross attention (cross K/V cached for decode).
Modality frontends are stubs: frames / patch embeddings arrive
precomputed.

A cache (:func:`init_cache`) is a list with one dict of tensors per layer.
Prefill and decode write it in place and return it, so a step never copies
the KV cache; the reference builds a new cache each step.  A whisper
layer's cross K/V stay in the cache through decode (the reference's decode
step drops them; ROADMAP.md, queue 3).  The reference's GSPMD sharding
constraints sit at its call sites as :func:`~repro_torch.models.
partitioning.constrain`, which redistributes a ``DTensor`` and leaves a
plain tensor as it is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .layers import (MLP, Attention, _sdpa, apply_mrope, apply_rope,
                     mlp_block, normal_, rms_norm, sdpa_chunked,
                     sincos_positions)
from .mamba2 import Mamba2, init_mamba2_state, mamba2_block, mamba2_decode
from .moe import MoE, moe_block
from .partitioning import (as_layout, constrain, gather_rows, is_dtensor,
                           relayout, replicate_like, split_dim)
from .rwkv6 import RWKV6, init_rwkv6_state, rwkv6_block, rwkv6_decode

__all__ = ["LM", "resolve_device", "init_cache", "loss_fn", "train_step_fn",
           "prefill_fn", "decode_fn"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """``device``, by default ``cuda:0``; raises when a CUDA device is asked
    for and none is present (the model never falls back to the CPU unless
    the caller asks for it)."""
    dev = torch.device(device if device is not None else "cuda:0")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for the model on {dev}; pass "
                           "device='cpu' to run on the host")
    return dev


def _dtype(dtype) -> torch.dtype:
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def _ffn_is_moe(kind: str) -> bool:
    return kind.endswith("+moe")


# ------------------------------------------------------------------ modules


def _zeros(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


class Layer(nn.Module):
    """One layer (``_init_layer``); its members are the reference's keys:
    ``ln`` + ``rwkv`` | ``ln`` + ``mamba`` | ``ln1``, ``attn``, ``ln2``,
    ``mlp`` or ``moe``, and the post-block norms and cross attention where
    the config has them."""

    def __init__(self, cfg: ModelConfig, kind: str, cross: bool, dtype,
                 device, gen=None):
        super().__init__()
        d = cfg.d_model
        if kind == "rwkv6":
            self.ln = _zeros(d, dtype, device)
            self.rwkv = RWKV6(cfg, dtype, device, gen)
            return
        if kind.startswith("mamba2"):
            self.ln = _zeros(d, dtype, device)
            self.mamba = Mamba2(cfg, dtype, device, gen)
            return
        self.ln1 = _zeros(d, dtype, device)
        self.attn = Attention(cfg, dtype, device, gen)
        self.ln2 = _zeros(d, dtype, device)
        if _ffn_is_moe(kind):
            self.moe = MoE(cfg, dtype, device, gen)
        else:
            ff = cfg.moe_dense_ff if cfg.moe_dense_ff else cfg.d_ff
            self.mlp = MLP(d, ff, cfg.mlp_gated, dtype, device, gen)
        if cfg.post_block_norm:
            self.post_ln1 = _zeros(d, dtype, device)
            self.post_ln2 = _zeros(d, dtype, device)
        if cross:
            self.ln_cross = _zeros(d, dtype, device)
            self.cross = Attention(cfg, dtype, device, gen)


class SharedBlock(nn.Module):
    """zamba2's weight-tied attention + MLP block (``shared_block``)."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _zeros(d, dtype, device)
        self.attn = Attention(cfg, dtype, device, gen)
        self.ln2 = _zeros(d, dtype, device)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp_gated, dtype, device, gen)


class Encoder(nn.Module):
    """whisper's bidirectional encoder (``enc``)."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen=None):
        super().__init__()
        self.layers = nn.ModuleList(
            Layer(cfg, "global", False, dtype, device, gen)
            for _ in range(cfg.n_enc_layers))
        self.final_norm = _zeros(cfg.d_model, dtype, device)


class LM(nn.Module):
    """The model of one configuration (``init_params``), with random
    weights drawn from a ``torch.Generator`` seeded with ``seed`` on the
    model's device.

    ``device`` defaults to ``cuda:0`` and raises without a GPU; pass
    ``device="cpu"`` to run on the host (``"meta"`` allocates nothing, for
    weights loaded later).  ``dtype`` (default: the config's) is the storage
    type of every weight the reference stores in the config's type; the
    router, SSM and decay parameters it keeps in float32 stay float32."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        dt = _dtype(dtype if dtype is not None else cfg.dtype)
        self.cfg = cfg
        self.dtype = dt
        self.kinds = tuple(cfg.layer_kinds())
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        d = cfg.d_model
        self.embed = nn.Parameter(normal_(gen, (cfg.vocab, d), 0.02, dt, dev))
        self.final_norm = _zeros(d, dt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(normal_(gen, (d, cfg.vocab),
                                                1.0 / math.sqrt(d), dt, dev))
        self.layers = nn.ModuleList(
            Layer(cfg, kind, cfg.enc_dec, dt, dev, gen)
            for kind in self.kinds)
        if cfg.shared_block_period:
            self.shared_block = SharedBlock(cfg, dt, dev, gen)
        if cfg.enc_dec:
            self.enc = Encoder(cfg, dt, dev, gen)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, batch: dict, *, cache: list | None = None,
                decode: bool = False, last_only: bool = False,
                return_hidden: bool = False):
        """Returns (logits | hidden, aux_loss, cache).

        ``last_only``: project only the final position to logits (prefill).
        ``return_hidden``: skip the LM head entirely (the chunked-CE loss
        projects per sequence chunk to bound logits memory).  With
        ``cache`` the step writes it in place and returns it."""
        cfg = self.cfg
        enc_out = None
        if cfg.enc_dec and "frames" in batch:
            enc_out = _encode(self, batch["frames"])

        if decode:
            tok = batch["token"]
            pos = batch["pos"]
            x = _embed(self, tok).to(self.dtype)
            if cfg.enc_dec:
                table = replicate_like(
                    sincos_positions(_cache_cap(cache), cfg.d_model,
                                     device=x.device).to(self.dtype), x)
                x = x + table[pos.long()][:, None, :]
                positions = None
            elif cfg.mrope_sections is not None:
                positions = batch["positions"]
            else:
                positions = None
            x, aux = _run_stack(self, x, positions, cache=cache, pos=pos,
                                enc_out=enc_out, decode=True)
            x = rms_norm(x, self.final_norm, cfg.norm_eps)
            return _logits(self, x), aux, cache

        x, positions = _embed_inputs(self, batch)
        x, aux = _run_stack(self, x, positions, cache=cache, enc_out=enc_out,
                            decode=False)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if return_hidden:
            return x, aux, cache
        if last_only:
            return _logits(self, x[:, -1:, :]), aux, cache
        return _logits(self, x), aux, cache


# ------------------------------------------------------------------ caches


def init_cache(cfg: ModelConfig, batch: int, cap: int, *, device=None,
               dtype=None) -> list[dict]:
    """Decode state for a KV capacity of ``cap`` tokens: one dict per layer.
    Local (sliding-window) layers allocate only ``min(cap, window)`` slots,
    a ring whose ``pos`` holds each slot's token position (-1: empty).

    ``device`` defaults to ``cuda:0`` and raises without a GPU; ``dtype``
    (default: the config's) is the KV cache's type."""
    dev = resolve_device(device)
    dt = _dtype(dtype if dtype is not None else cfg.dtype)

    def z(*s):
        return torch.zeros(s, dtype=dt, device=dev)

    def layer_cache(kind: str) -> dict:
        if kind == "rwkv6":
            return {"rwkv_state": init_rwkv6_state(cfg, batch, dt, dev)}
        if kind.startswith("mamba2"):
            c = {"mamba_state": init_mamba2_state(cfg, batch, dev)}
            if kind == "mamba2+shared":
                c["k"] = z(batch, cap, cfg.n_kv_heads, cfg.head_dim)
                c["v"] = z(batch, cap, cfg.n_kv_heads, cfg.head_dim)
            return c
        span = min(cap, cfg.window) if kind.startswith("local") else cap
        c = {"k": z(batch, span, cfg.n_kv_heads, cfg.head_dim),
             "v": z(batch, span, cfg.n_kv_heads, cfg.head_dim)}
        if kind.startswith("local"):
            c["pos"] = torch.full((batch, span), -1, dtype=torch.int32,
                                  device=dev)
        if cfg.enc_dec:
            c["xk"] = z(batch, cap, cfg.n_kv_heads, cfg.head_dim)
            c["xv"] = z(batch, cap, cfg.n_kv_heads, cfg.head_dim)
            c["x_len"] = torch.zeros((), dtype=torch.int32, device=dev)
        return c

    return [layer_cache(kind) for kind in cfg.layer_kinds()]


def _cache_cap(cache: list[dict]) -> int:
    """The largest token capacity among the cache's K/V tensors (the
    reference's ``_cache_cap`` over its stacked leaves)."""
    caps = [c[key].shape[1] for c in cache for key in ("k", "v", "xk", "xv")
            if key in c]
    return max(caps) if caps else 0


# ------------------------------------------------------------------ layers


def _theta(cfg, kind):
    return (cfg.rope_local_theta if (kind == "local" and
                                     cfg.rope_local_theta) else
            cfg.rope_theta)


def _project_kv(ap, h, cfg, kind, positions):
    heads = (cfg.n_kv_heads, cfg.head_dim)
    k = split_dim(h @ ap.wk, -1, heads)
    v = split_dim(h @ ap.wv, -1, heads)
    if cfg.qk_norm:
        k = rms_norm(k, ap.k_norm, cfg.norm_eps)
    if not cfg.enc_dec:
        if cfg.mrope_sections is not None:
            k = apply_mrope(k, positions, _theta(cfg, kind),
                            cfg.mrope_sections)
        else:
            k = apply_rope(k, positions, _theta(cfg, kind))
    return k, v


def _project_q(ap, h, cfg, kind, positions):
    q = split_dim(h @ ap.wq, -1, (cfg.n_heads, cfg.head_dim))
    if cfg.qk_norm:
        q = rms_norm(q, ap.q_norm, cfg.norm_eps)
    if not cfg.enc_dec:
        if cfg.mrope_sections is not None:
            q = apply_mrope(q, positions, _theta(cfg, kind),
                            cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, _theta(cfg, kind))
    return q


def _put_rows(buf, idx, rows) -> None:
    """``buf[b, idx[b]] = rows[b]`` for every batch row ``b``, in place.  A
    ``DTensor`` cache (batch and sequence sharded: no ``index_put_``
    strategy keeps that) takes the same write as a select against each
    row's one-hot position, every rank rewriting its own shard."""
    if not is_dtensor(buf):
        buf[torch.arange(buf.shape[0], device=buf.device), idx] = rows
        return
    from torch.distributed.tensor import Replicate

    from ..distributed.comm import redistribute

    t = replicate_like(torch.arange(buf.shape[1], device=buf.device), buf)
    hit = (t[None, :] == idx[:, None]).reshape(
        (*buf.shape[:2], *([1] * (buf.ndim - 2))))
    # both operands in the cache's own layout (a local slice of each), so
    # that the select moves no cache shard
    pl = buf.placements
    hit = redistribute(hit, pl)
    rows = redistribute(rows[:, None].to(buf.dtype),
                        [Replicate() if p.is_shard(1) else p for p in pl])
    buf.copy_(torch.where(hit, rows, buf))


def _self_attention(ap, h, cfg, kind, positions, cache, pos, decode, causal):
    """Self attention in three modes: full-sequence, prefill-fill, decode.
    The cache's K/V (and ring positions) are written in place."""
    akind = kind.split("+")[0]
    dev = h.device
    if decode:
        qpos = pos[:, None] if positions is None else positions
        q = _project_q(ap, h, cfg, akind, qpos)
        k, v = _project_kv(ap, h, cfg, akind, qpos)
        ck, cv = cache["k"], cache["v"]
        if "pos" in cache:                      # local ring buffer
            span = ck.shape[1]
            slot = pos % span
            _put_rows(ck, slot, k[:, 0])
            _put_rows(cv, slot, v[:, 0])
            cp = cache["pos"]
            _put_rows(cp, slot, pos.to(cp.dtype))
            mask = ((cp <= pos[:, None]) & (cp >= 0) &
                    (cp > (pos - cfg.window)[:, None]))
        else:
            _put_rows(ck, pos, k[:, 0])
            _put_rows(cv, pos, v[:, 0])
            tpos = replicate_like(torch.arange(ck.shape[1], device=dev),
                                  h)[None, :]
            mask = tpos <= pos[:, None]
        out = _sdpa(q, ck, cv, mask[:, None, None, None, :], cfg)
        return out @ ap.wo

    S = h.shape[1]
    q = _project_q(ap, h, cfg, akind, positions)
    k, v = _project_kv(ap, h, cfg, akind, positions)
    # sequence-parallel attention: where the head count does not divide
    # the model axis, the query sequence shards instead (k, v replicate)
    q = constrain(q, "attn_q")
    k = constrain(k, "attn_kv")
    v = constrain(v, "attn_kv")

    def mask_fn(qpos, kpos):
        qp, kp = qpos[:, None], kpos[None, :]
        m = (kp <= qp) if causal else replicate_like(torch.ones(
            (qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=dev), h)
        m = m & (kpos >= 0)[None, :]            # banded path left-pads K/V
        if akind == "local":
            m = m & (torch.abs(kp - qp) < cfg.window)
        return m

    out = sdpa_chunked(q, k, v, cfg, mask_fn,
                       local_window=cfg.window if (akind == "local" and
                                                   causal) else None)
    out = constrain(out, "attn_out")
    if cache is not None:                       # prefill: fill the cache
        if "pos" in cache:
            span = cache["k"].shape[1]
            take = min(S, span)
            idx = replicate_like(torch.arange(S - take, S, device=dev) % span,
                                 h)
            cache["k"][:, idx] = k[:, S - take:]
            cache["v"][:, idx] = v[:, S - take:]
            cache["pos"][:, idx] = replicate_like(torch.arange(
                S - take, S, dtype=torch.int32, device=dev), h)[None, :]
        else:
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
    return out @ ap.wo


def _cross_attention(p, x, cfg, enc_out, cache, decode):
    """Whisper cross attention; caches encoder K/V at prefill."""
    h = gather_rows(rms_norm(x, p.ln_cross, cfg.norm_eps))
    B, S, _ = h.shape
    q = split_dim(h @ p.cross.wq, -1, (cfg.n_heads, cfg.head_dim))
    if decode:
        xk, xv = cache["xk"], cache["xv"]
        mask = (replicate_like(torch.arange(xk.shape[1], device=x.device),
                               x) < cache["x_len"])[None, None, None, None, :]
    else:
        T = enc_out.shape[1]
        heads = (cfg.n_kv_heads, cfg.head_dim)
        xk = split_dim(enc_out @ p.cross.wk, -1, heads)
        xv = split_dim(enc_out @ p.cross.wv, -1, heads)
        if cache is not None:
            n = min(T, cache["xk"].shape[1])
            cache["xk"][:, :n] = xk[:, :n]
            cache["xv"][:, :n] = xv[:, :n]
            cache["x_len"].fill_(n)
        mask = replicate_like(torch.ones((1, 1, 1, S, xk.shape[1]),
                                         dtype=torch.bool, device=x.device),
                              x)
    out = _sdpa(q, xk, xv, mask, cfg)
    return x + as_layout(out @ p.cross.wo, x)


def _attn_layer(p, x, cfg, kind, positions, cache, pos, enc_out, decode,
                causal):
    h = gather_rows(rms_norm(x, p.ln1, cfg.norm_eps))
    a = as_layout(_self_attention(p.attn, h, cfg, kind, positions, cache,
                                  pos, decode, causal), x)
    if cfg.post_block_norm:
        a = rms_norm(a, p.post_ln1, cfg.norm_eps)
    x = x + a

    if hasattr(p, "cross") and (enc_out is not None or
                                (cache is not None and "xk" in cache)):
        x = _cross_attention(p, x, cfg, enc_out, cache, decode)

    h = gather_rows(rms_norm(x, p.ln2, cfg.norm_eps))
    aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                     device=x.device), x)
    if hasattr(p, "moe"):
        f, aux = moe_block(p.moe, h, cfg)
    else:
        f = mlp_block(p.mlp, h, cfg.act)
    f = as_layout(f, x)
    if cfg.post_block_norm:
        f = rms_norm(f, p.post_ln2, cfg.norm_eps)
    return x + f, aux


def _layer_apply(p, x, cfg, kind, positions, shared_p, cache, pos, enc_out,
                 decode, causal):
    zero = replicate_like(torch.zeros((), dtype=torch.float32,
                                      device=x.device), x)
    if kind == "rwkv6":
        h = gather_rows(rms_norm(x, p.ln, cfg.norm_eps))
        if decode:
            delta, st = rwkv6_decode(p.rwkv, h, cfg, cache["rwkv_state"])
        else:
            delta, st = rwkv6_block(p.rwkv, h, cfg, None if cache is None
                                    else cache["rwkv_state"])
        if cache is not None:
            cache["rwkv_state"] = st
        return x + as_layout(delta, x), zero
    if kind.startswith("mamba2"):
        h = gather_rows(rms_norm(x, p.ln, cfg.norm_eps))
        if decode:
            S, conv = cache["mamba_state"]
            delta, st = mamba2_decode(p.mamba, h, cfg, S, conv)
        else:
            st = None if cache is None else cache["mamba_state"]
            delta, st = mamba2_block(
                p.mamba, h, cfg,
                state=None if st is None else st[0],
                conv_state=None if st is None else st[1])
        if cache is not None:
            cache["mamba_state"] = st
        x = x + as_layout(delta, x)
        if kind == "mamba2+shared":
            sub = cache if cache is not None and "k" in cache else None
            return _attn_layer(shared_p, x, cfg, "global", positions, sub,
                               pos, None, decode, causal)
        return x, zero
    return _attn_layer(p, x, cfg, kind, positions, cache, pos, enc_out,
                       decode, causal)


# ------------------------------------------------------------------ stacks


def _run_stack(model: LM, x, positions, *, cache=None, pos=None,
               enc_out=None, decode=False, causal=True):
    """The layers in order, summing their aux losses.  With grad enabled
    and no cache, each cycle group (layers ``g * len(cycle)`` to ``(g + 1)
    * len(cycle) - 1``) runs under ``checkpoint``: its activations are
    recomputed in the backward, as the reference's ``jax.checkpoint`` of
    its scanned group body does; the tail runs unwrapped."""
    cfg = model.cfg
    shared_p = getattr(model, "shared_block", None)

    def run(lo, hi, x, aux):
        for i in range(lo, hi):
            c = None if cache is None else cache[i]
            x, a = _layer_apply(model.layers[i], x, cfg, model.kinds[i],
                                positions, shared_p, c, pos, enc_out, decode,
                                causal)
            aux = aux + a
        return x, aux

    cyc, n_groups, _ = cfg.layer_plan()
    n = len(cyc)

    def group(lo, hi, x, aux):      # the residual stream's "act" spec at
        x, aux = run(lo, hi, constrain(x, "act"), aux)  # a group's ends
        return constrain(x, "act"), aux

    aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                     device=x.device), x)
    remat = torch.is_grad_enabled() and not decode and cache is None
    for g in range(n_groups):
        if remat:
            x, aux = checkpoint(group, g * n, (g + 1) * n, x, aux,
                                use_reentrant=False)
        else:
            x, aux = group(g * n, (g + 1) * n, x, aux)
    return run(n_groups * n, len(model.layers), x, aux)


# ------------------------------------------------------------------ forward


def _table(model: LM):
    """The embedding table as each of its uses takes it: on a ``DTensor``
    table, each use's gradient comes back in the table's own layout, so
    that the lookup's and the tied head's gradients add shard to shard
    (some torch versions cannot add them in the layouts they arrive in)."""
    if not is_dtensor(model.embed):
        return model.embed
    return relayout(model.embed, model.embed.placements)


def _embed(model: LM, tok):
    """The embedding rows of ``tok``: ``model.embed[tok]``; for a
    ``DTensor`` table, ``F.embedding``, whose vocabulary-parallel rule
    DTensor has forward and backward (its indexing backward fails in some
    torch versions), the shards' partial rows summed."""
    if not is_dtensor(model.embed):
        return model.embed[tok.long()]
    from torch.distributed.tensor import Replicate

    x = F.embedding(tok.long(), _table(model))
    return relayout(x, [Replicate() if p.is_partial() else p
                        for p in x.placements])


def _embed_inputs(model: LM, batch: dict):
    cfg, dt = model.cfg, model.dtype
    if cfg.enc_dec:
        tok = batch["tokens"]
        x = _embed(model, tok).to(dt)
        x = x + replicate_like(sincos_positions(tok.shape[1], cfg.d_model,
                                                device=x.device).to(dt),
                               x)[None]
        positions = replicate_like(torch.arange(
            tok.shape[1], dtype=torch.int32, device=x.device), x)
        return x, positions.expand(tok.shape)
    if cfg.frontend == "patches" and "patch_embeds" in batch:
        te = _embed(model, batch["tokens"]).to(dt)
        x = torch.cat([batch["patch_embeds"].to(dt), te], dim=1)
    else:
        x = _embed(model, batch["tokens"]).to(dt)
    B, S = x.shape[:2]
    if cfg.mrope_sections is not None and "positions" in batch:
        return x, batch["positions"]
    positions = replicate_like(torch.arange(S, dtype=torch.int32,
                                            device=x.device), x)
    if cfg.mrope_sections is not None:
        # no M-RoPE streams given: every stream counts 0..S-1 (the values
        # the reference reads when it indexes its [B, S] positions as
        # three streams)
        return x, positions.expand(3, B, S)
    return x, positions.expand(B, S)


def _encode(model: LM, frames):
    cfg, dt = model.cfg, model.dtype
    x = frames.to(dt) + replicate_like(
        sincos_positions(frames.shape[1], cfg.d_model,
                         device=frames.device).to(dt), frames)[None]
    positions = replicate_like(torch.arange(
        frames.shape[1], dtype=torch.int32, device=frames.device),
        frames).expand(frames.shape[:2])
    for layer in model.enc.layers:
        x, _ = _layer_apply(layer, x, cfg, "global", positions, None, None,
                            None, None, False, False)
    return rms_norm(x, model.enc.final_norm, cfg.norm_eps)


def _logits(model: LM, x):
    cfg = model.cfg
    head = getattr(model, "lm_head", None)
    if head is None:
        head = _table(model).T
    logits = (gather_rows(x) @ head).float()
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


# ------------------------------------------------------------------ steps


CE_CHUNK = 512


def _ce_chunk(head, xs, ls, softcap):
    """Summed cross entropy of one chunk: project onto the head, upcast to
    float32, softcap, ``logsumexp`` minus the label's logit."""
    lg = constrain((xs @ head).float(), "logits")
    if softcap:
        lg = torch.tanh(lg / softcap) * softcap
    lse = torch.logsumexp(lg, dim=-1)
    if is_dtensor(lg):
        # the label's logit as a masked sum over the vocabulary: DTensor's
        # gather from vocabulary shards fails to reduce (torch 2.13)
        v = replicate_like(torch.arange(lg.shape[-1], device=lg.device), lg)
        ll = torch.where(v == ls[..., None], lg, 0.0).sum(-1)
    else:
        ll = torch.gather(lg, -1, ls[..., None].long())[..., 0]
    return (lse - ll).sum()


def _chunked_ce(model: LM, x, labels, chunk: int = CE_CHUNK):
    """Cross entropy with per-chunk LM-head projection: the [B, S, vocab]
    logits never materialise, and each chunk runs under ``checkpoint``, so
    its [B, chunk, vocab] float32 slab is recomputed in the backward
    instead of kept.  One chunk of length S when ``S % chunk != 0``, as in
    the reference."""
    B, S, _ = x.shape
    x = gather_rows(x)
    if S % chunk:
        chunk = S
    head = getattr(model, "lm_head", None)
    if head is None:
        head = _table(model).T
    total = replicate_like(torch.zeros((), dtype=torch.float32,
                                       device=x.device), x)
    for s in range(0, S, chunk):
        total = total + checkpoint(
            _ce_chunk, head, x[:, s:s + chunk], labels[:, s:s + chunk],
            model.cfg.final_logit_softcap, use_reentrant=False)
    return total / (B * S)


def loss_fn(model: LM, batch: dict):
    """Mean cross entropy over the last ``min(hidden, labels)`` positions
    plus ``0.01 *`` the MoE load-balancing loss."""
    hidden, aux, _ = model(batch, return_hidden=True)
    labels = batch["labels"]
    S = min(hidden.shape[1], labels.shape[1])
    ce = _chunked_ce(model, hidden[:, -S:, :], labels[:, -S:])
    return ce + 0.01 * aux


def train_step_fn(optimizer):
    """``step(model, opt_state, batch) -> loss``: the loss, every
    parameter's gradient by autograd (zeros for a parameter the loss does
    not reach, as ``jax.grad`` gives), and ``optimizer.update``, which
    writes the parameters and ``opt_state`` in place."""

    def step(model: LM, opt_state: dict, batch: dict):
        names, params = zip(*model.named_parameters())
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        optimizer.update(dict(zip(names, params)), dict(zip(names, grads)),
                         opt_state)
        return loss.detach()

    return step


def prefill_fn(with_cache: bool = False):
    """Forward over the prompt, returning the last position's logits
    ``[B, vocab]``; ``with_cache``: also fill a decode cache.  Only the last
    position is projected to the vocabulary (the reference projects every
    position and keeps the last: the same values, row for row).  The
    returned steps take the model in place of the reference's
    ``(cfg, params)``."""

    if not with_cache:
        def prefill(model: LM, batch: dict):
            logits, _, _ = model(batch, last_only=True)
            return logits[:, -1, :]
        return prefill

    def prefill_cache(model: LM, cache: list, batch: dict):
        logits, _, cache = model(batch, cache=cache, last_only=True)
        return logits[:, -1, :], cache

    return prefill_cache


def decode_fn():
    """One token against the cache: ``(model, cache, batch) -> (logits
    [B, vocab], cache)``."""

    def decode(model: LM, cache: list, batch: dict):
        logits, _, cache = model(batch, cache=cache, decode=True)
        return logits[:, -1, :], cache

    return decode
