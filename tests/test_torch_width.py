"""The port's LM on two torch versions' ``DTensor`` and at serving width,
on the CPU.

Torch's ``DTensor`` gained strategies between versions: an older one has
no sharding strategy for ``index_put``, ``flip`` (cumsum's gradient) or
softplus's gradient, fails to pad where the pad needs a redistribution,
and cannot flatten a shard that is not the leading dim of the flattened
group (a ``view`` of the batch and the heads, both sharded, into one
dim).  The lowering proofs must trace without these, so the traces here
run under :class:`OlderDTensor`, a ``TorchDispatchMode`` (the proofs' own
``CollectiveCounter``, extended) that records every ``DTensor`` op
relying on one of them.

* every architecture's prefill, decode and train step at
  ``reduce_for_smoke`` size on a (2, 4) placeholder mesh (batch 4 x 128):
  ``ok``, and no op the older ``DTensor`` lacks;
* the detector itself: torch's einsum over a batch- and head-sharded
  operand and an ``index_put`` on a ``DTensor`` are recorded;
  ``shard_einsum`` and ``on_replicas`` on the same operands are not;
* the proofs' ``flops`` and ``flops_exact`` for olmoe-1b-7b and
  whisper-tiny equal the numbers the traces gave before the MoE dispatch
  and attention ran per shard (pinned);
* in a real 4-rank gloo world on a (2, 2) mesh, the batch and the heads
  sharded: olmoe-1b-7b's, zamba2-7b's and rwkv6-7b's prefill logits on
  ``DTensor``s
  (batch 4 x 16) against the same model's plain run, ``|got - want| <=
  RTOL_RANKS * (1 + |want|)`` with ``RTOL_RANKS = 1e-5`` (float32;
  DTensor's sharded projections add their partial sums in another order;
  measured at most 2.7e-6), and the gradients of a fixed weighted sum of
  them, each leaf's largest difference within ``RTOL_RANKS`` of ``1 +``
  its largest entry (zamba2 ``RTOL_ZAMBA2_GRAD = 1e-4``: its random
  Mamba2 stack is ill-conditioned, as ``test_torch_train.py`` finds;
  measured 3.6e-5, the others at most 1.2e-6);
* serving as ``chip_smoke.py``'s ``width`` phase drives it, at smoke size
  in float32 (batch 2 x 128-token prompts, 6 tokens): every logit
  ``generate`` chose a token from, held against the reference's forward
  over the prompt and the fed-back tokens (the JAX package, same
  weights) within ``RTOL_REF = 1e-4``, and against the port's own
  ``teacher_forced`` within ``RTOL_DECODE = 2e-3``; ``cut_depth`` and
  ``seq_multiple`` on every configuration.
"""

import math
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import lm as J
from repro.models.lm import init_params
from repro_torch import interop
from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.launch import dryrun
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.hlo_analysis import CollectiveCounter
from repro_torch.launch.mesh import placeholder_world
from repro_torch.models import moe
from repro_torch.models.partitioning import on_replicas, shard_einsum

CPU = torch.device("cpu")
RTOL_RANKS = 1e-5
RTOL_ZAMBA2_GRAD = 1e-4
RTOL_REF = 1e-4
RTOL_DECODE = 2e-3
STEPS = ("prefill", "decode", "train")
SEQ, BATCH = 128, 4

# the real-rank check: the MoE dispatch with KV-sharded attention, and the
# two chunked scans (whisper's attention and llama4's dispatch run the same
# code as olmoe's); and the eight architectures served at full width
RANK_ARCHS = ("olmoe-1b-7b", "zamba2-7b", "rwkv6-7b")
SERVED = ("whisper-tiny", "h2o-danube-1.8b", "gemma3-4b", "zamba2-7b",
          "olmoe-1b-7b", "rwkv6-7b", "qwen2-vl-7b", "starcoder2-15b")

# (flops, flops_exact) of the (2, 4) traces before the repair
PINNED = {
    "olmoe-1b-7b/prefill": (24395776, 193593344),
    "olmoe-1b-7b/decode": (231424, 1839104),
    "olmoe-1b-7b/train": (106168320, 840957952),
    "whisper-tiny/prefill": (33570816, 268566528),
    "whisper-tiny/decode": (163840, 1310720),
    "whisper-tiny/train": (127926272, 1023410176),
}

_aten = torch.ops.aten
_INDEX_PUT = {_aten.index_put.default, _aten.index_put_.default,
              _aten._index_put_impl_.default}
# ops the card's torch 2.11 failed on with DTensor operands in a dry run
# (flip: cumsum's gradient; a pad's redistribution), or has no sharding
# strategy registered for (softplus's gradient)
_NO_STRATEGY = {_aten.flip.default, _aten.constant_pad_nd.default,
                _aten.softplus_backward.default}
_VIEWS = {_aten.view.default, _aten._unsafe_view.default,
          _aten.view_copy.default}


def _view_groups(src, dst):
    """The input dims each output dim (or run of them) of a view is made
    of, size-1 dims left out: a list of (input dims, output dims)."""
    out, i, j = [], 0, 0
    while True:
        while i < len(src) and src[i] == 1:
            i += 1
        while j < len(dst) and dst[j] == 1:
            j += 1
        if i >= len(src) or j >= len(dst):
            return out
        gi, gj, pi, pj = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                gi.append(i)
                pi *= src[i]
                i += 1
            else:
                gj.append(j)
                pj *= dst[j]
                j += 1
        out.append(([d for d in gi if src[d] != 1], gj))


class OlderDTensor(CollectiveCounter):
    """The lowering proofs' counter, recording in ``refusals`` every
    ``DTensor`` op an older torch's ``DTensor`` refuses: ``index_put``,
    ``flip``, ``constant_pad_nd`` or ``softplus_backward`` with a
    ``DTensor`` operand, and a view that flattens a dim sharded on some
    mesh dim into a group it does not lead."""

    def __init__(self):
        super().__init__()
        self.refusals = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Shard

        if any(issubclass(t, DTensor) for t in types):
            flat = torch.utils._pytree.tree_flatten((args, kwargs or {}))[0]
            if (func in _INDEX_PUT | _NO_STRATEGY
                    and any(isinstance(a, DTensor) for a in flat)):
                self.refusals.append(str(func))
            elif func in _VIEWS and isinstance(args[0], DTensor):
                x, shape = args[0], list(args[1])
                if -1 in shape:
                    shape[shape.index(-1)] = x.numel() // -math.prod(shape)
                sharded = {p.dim for p in x.placements
                           if isinstance(p, Shard)}
                for gi, _ in _view_groups(list(x.shape), shape):
                    if sharded & set(gi[1:]):
                        self.refusals.append(
                            f"{func} {tuple(x.shape)} -> {tuple(shape)} "
                            f"{x.placements}")
        return super().__torch_dispatch__(func, types, args, kwargs)


def _mesh_2x4():
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))


@pytest.fixture(scope="module")
def strict_records():
    """Every architecture's three steps traced under ``OlderDTensor``:
    ``{arch/step: (record, refusals)}``."""
    saved = dryrun.CollectiveCounter
    counters = []

    def counter():
        counters.append(OlderDTensor())
        return counters[-1]

    dryrun.CollectiveCounter = counter
    recs = {}
    try:
        with placeholder_world(8):
            mesh = _mesh_2x4()
            for arch in ARCHS:
                cfg = reduce_for_smoke(get_config(arch))
                for step in STEPS:
                    n = len(counters)
                    rec = dryrun.lower_step(arch, cfg, SEQ, BATCH, step, mesh)
                    refusals = [r for c in counters[n:] for r in c.refusals]
                    recs[f"{arch}/{step}"] = (rec, refusals)
    finally:
        dryrun.CollectiveCounter = saved
    return recs


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_trace_needs_no_newer_dtensor_strategy(arch, step, strict_records):
    rec, refusals = strict_records[f"{arch}/{step}"]
    assert rec["status"] == "ok"
    assert refusals == [], refusals[:4]


@pytest.mark.parametrize("key", sorted(PINNED))
def test_proof_flops_unchanged(key, strict_records):
    rec, _ = strict_records[key]
    assert (rec["flops"], rec["flops_exact"]) == PINNED[key]


def test_detector_records_both_unrepaired_sites():
    """Torch's einsum over the batch and head groups both sharded, and an
    indexed write into a ``DTensor``, are recorded; their per-shard
    counterparts are not, and keep the operands' shards."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with placeholder_world(8):
        mesh = _mesh_2x4()

        def dt(shape, placements):
            return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                     placements, src_data_rank=None)

        q = dt((4, 16, 4, 2, 8), [Shard(0), Shard(2)])
        k = dt((4, 16, 4, 8), [Shard(0), Shard(2)])
        eq = "bsgrh,btgh->bgrst"
        with OlderDTensor() as c:
            torch.einsum(eq, q, k)
        assert any("view" in r for r in c.refusals)
        with OlderDTensor() as c:
            logits = shard_einsum(eq, q, k)
        assert c.refusals == []
        assert logits.placements == (Shard(0), Shard(1))
        assert tuple(logits.shape) == (4, 4, 2, 16, 16)

        rep = [Replicate(), Replicate()]
        x = dt((16, 8), rep)

        def ints(t):
            return distribute_tensor(t.to("meta"), mesh, rep,
                                     src_data_rank=None)

        slot = ints(torch.zeros(32, dtype=torch.int64))
        tok = ints(torch.arange(16).repeat_interleave(2))
        with OlderDTensor() as c:
            buf = dt((33, 8), rep)
            buf[slot] = x[tok]
        assert any("index_put" in r for r in c.refusals)
        with OlderDTensor() as c:
            buf = on_replicas(lambda a, s: moe._fill(a, s, k=2, E=4, cap=8),
                              x, slot)
        assert c.refusals == []
        assert tuple(buf.shape) == (4, 8, 8)


# ------------------------------------------------------------ real ranks


def _ranks_forward(rank, n, archs):
    """Each architecture's smoke model (float32, seed 0) on a (2, 2) mesh:
    the plain prefill logits and the gradients of ``sum(logits * w)``,
    then the same on ``DTensor``s placed by the production rules; returns
    the largest relative errors, and how often the per-shard paths ran."""
    import repro_torch.models.partitioning as P
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.comm import full_tensor
    from repro_torch.models.lm import LM, prefill_fn

    calls = {"shard_einsum": 0, "on_replicas": 0}
    plan, replicas = P._shard_plan, P.on_replicas

    def counted_plan(eq, ops):
        got = plan(eq, ops)
        calls["shard_einsum"] += got is not None
        return got

    def counted_replicas(fn, *ts):
        calls["on_replicas"] += any(P.is_dtensor(t) for t in ts)
        return replicas(fn, *ts)

    P._shard_plan = counted_plan
    moe.on_replicas = counted_replicas
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for arch in archs:
        cfg = replace(reduce_for_smoke(get_config(arch)), dtype="float32")
        # 16 positions: over a longer chunk zamba2's random decays
        # overflow the masked part of exp(l_t - l_j), whose gradient is
        # then NaN on the plain path too
        seq, batch = 16, 4
        step = dryrun.step_specs(cfg, seq, batch, "prefill")
        g = torch.Generator().manual_seed(1)
        data = {k: (torch.randint(0, cfg.vocab, v.shape, generator=g,
                                  dtype=torch.int32)
                    if v.dtype == torch.int32 else
                    torch.randn(v.shape, generator=g))
                for k, v in step.items()}
        w = torch.randn((batch, cfg.vocab), generator=g)

        def run(model, batch_in, wt):
            logits = prefill_fn()(model, batch_in)
            params = [p for _, p in model.named_parameters()]
            grads = torch.autograd.grad((logits * wt).sum(), params)
            return logits, grads

        plain = LM(cfg, device=CPU, seed=0)
        want, want_g = run(plain, data, w)
        names = [nm for nm, _ in plain.named_parameters()]
        model = LM(cfg, device=CPU, seed=0)
        n0 = dict(calls)
        with dryrun.activation_specs(**dryrun._act_specs(mesh, cfg, seq,
                                                         batch, "prefill")):
            dryrun._place_model(model, mesh, [])
            # the table as a replica: torch's vocabulary-parallel embedding
            # of batch-sharded tokens keeps a mask of the local tokens'
            # shape and fails to reduce real data with it (a trace of meta
            # tensors never reduces)
            model.embed = torch.nn.Parameter(dryrun._place(
                plain.embed.detach(), (mesh, [Replicate(), Replicate()])))
            placed = dryrun._place_tree(data, dryrun.shardings_for(
                dryrun.batch_pspecs(data, mesh, global_batch=batch), mesh))
            wt = P.replicate_like(w, placed["tokens"])
            got, got_g = run(model, placed, wt)
        err = (full_tensor(got) - want).abs() / (1 + want.abs())
        g_err = max(float(((full_tensor(a) if P.is_dtensor(a) else a) - b)
                          .abs().max() / (1 + b.abs().max()))
                    for a, b in zip(got_g, want_g))
        out[arch] = {"logits": float(err.max()), "grads": g_err,
                     "n_grads": len(names),
                     "per_shard": {k: calls[k] - n0[k] for k in calls}}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("width_ranks")
    return spawn_ranks(_ranks_forward, 4, store_dir=str(d), backend="gloo",
                       args=(RANK_ARCHS,), timeout=600)


@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_sharded_prefill_equals_plain(arch, ranks):
    for rank in ranks:
        r = rank[arch]
        assert r["logits"] <= RTOL_RANKS, r
        assert sum(r["per_shard"].values()) > 0, r
        if arch == "olmoe-1b-7b":
            assert r["per_shard"]["on_replicas"] > 0, r


@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_sharded_prefill_gradients_equal_plain(arch, ranks):
    bound = RTOL_ZAMBA2_GRAD if arch == "zamba2-7b" else RTOL_RANKS
    for rank in ranks:
        assert rank[arch]["grads"] <= bound, rank[arch]


# ------------------------------------------------------------ serving slice


def _pair(arch):
    """The reference's (cfg, params) and the port's model, same weights,
    float32, MoE dropless (as the width phase checks it)."""
    cfg = launch_serve.dropless(replace(reduce_for_smoke(get_config(arch)),
                                        dtype="float32"))
    jcfg = replace(jax_reduce(jax_config(arch)), dtype="float32",
                   capacity_factor=cfg.capacity_factor)
    params = init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return jcfg, params, interop.lm_params_from(cfg, tree, device=CPU)


@pytest.mark.parametrize("arch", SERVED)
def test_generate_logits_against_reference_forward(arch):
    """``generate`` with ``keep_logits`` at smoke size; each kept logit row
    against the reference's forward over the prompt and the fed-back
    greedy tokens, and against the port's ``teacher_forced``."""
    import jax.numpy as jnp

    jcfg, params, model = _pair(arch)
    L, G = 128, 6
    inputs = launch_serve.prompts(model.cfg, 2, L)
    res = launch_serve.generate(model, inputs, G, keep_logits=True)
    got = res["logits"].numpy()
    assert got.shape == (2, G, model.cfg.vocab) and res["finite"]
    assert np.array_equal(res["tokens"], got.argmax(-1))
    own = launch_serve.teacher_forced(model, inputs, res["tokens"]).numpy()
    assert np.max(np.abs(got - own) / (1 + np.abs(own))) < RTOL_DECODE
    toks = np.concatenate([inputs["tokens"], res["tokens"][:, :-1]], axis=1)
    m = launch_serve.seq_multiple(model.cfg)
    toks = np.pad(toks, ((0, 0), (0, -toks.shape[1] % m)))
    batch = {"tokens": jnp.asarray(toks.astype(np.int32))}
    if model.cfg.enc_dec:
        batch["frames"] = jnp.asarray(inputs["frames"])
    want, _, _ = J.forward(params, jcfg, batch)
    want = np.asarray(want, np.float32)[:, L - 1:L - 1 + G]
    assert np.max(np.abs(got - want) / (1 + np.abs(want))) < RTOL_REF


@pytest.mark.parametrize("arch", ARCHS)
def test_cut_depth_and_seq_multiple(arch):
    cfg = get_config(arch)
    cut = launch_serve.cut_depth(cfg)
    n = len(cfg.attn_pattern)
    assert cut.n_layers % n == 0 or cut.n_layers == cfg.n_layers
    assert cut.n_layers >= min(4, cfg.n_layers)
    assert cut.n_layers - n < 4 or cut.n_layers == cfg.n_layers
    assert replace(cut, n_layers=cfg.n_layers) == cfg
    if cfg.shared_block_period:
        assert cut.layer_kinds()[-1] == "mamba2+shared"
    kinds = set(cfg.layer_kinds())
    assert launch_serve.seq_multiple(cfg) == (
        128 if any(k.startswith("mamba2") for k in kinds) else
        64 if "rwkv6" in kinds else 1)
