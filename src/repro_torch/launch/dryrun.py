"""Multi-pod lowering proofs: every (architecture x shape cell x mesh) traced
as one rank of a placeholder world; the twin of ``repro.launch.dryrun``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch gemma2-2b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both      # all

The reference lowers and compiles each cell with XLA on 512 placeholder
host devices.  The port has no compiler to ask: it runs the step itself,
eagerly, as rank 0 of a world of 256 or 512 placeholder ranks
(:func:`~repro_torch.launch.mesh.placeholder_world`), with the model's
parameters, optimizer state, batch and cache as ``DTensor``s of ``meta``
tensors placed by the production sharding rules.  Nothing is allocated
and nothing is sent; each op runs on rank 0's shard shapes.  Per cell it
records the rank's matrix-product FLOPs, its HBM-traffic estimate, its
collective bytes by kind (``launch.hlo_analysis.CollectiveCounter``),
its argument, output and temporary bytes, the sharding rules' fallbacks
and where DTensor's layout departs from GSPMD's (see
``models.partitioning.split_dim``), and the global FLOPs and bytes of an
unsharded trace.  Records land in ``build/dryrun/dryrun_{single,multi}
.json`` (gitignored), never in ``benchmarks/artifacts/``, which belongs to
the reference.

The trace needs no GPU.  Importing this module initializes no process
group: :func:`main` opens the placeholder world for each mesh.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from functools import partial
from pathlib import Path

import torch
from torch import nn

from ..configs import ARCHS, get_config
from ..configs.base import SHAPE_CELLS, step_specs
from ..distributed.sharding import (batch_pspecs, cache_pspecs, mesh_axes,
                                    param_pspecs, shardings_for)
from ..kernels import ref
from ..models import lm
from ..models.partitioning import (activation_specs, is_dtensor,
                                   recorded_fallbacks, unrolled_scans)
from ..train.optimizer import AdamW
from .hlo_analysis import CollectiveCounter
from .mesh import describe_mesh, make_production_mesh, placeholder_world

__all__ = ["lower_cell", "lower_step", "exact_cost", "hamlet_pane_step",
           "pane_inputs", "pane_parts", "pane_step", "main", "ARTIFACT_DIR"]

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# the pane step's shape (the reference's): groups, burst, basis, queries, C
PANE_SHAPE = (4096, 256, 8, 64, 16)
PANE_DENSITY = 0.5      # masked bursts' edge density (the reference kernel
                        # benchmark's, benchmarks/kernel_bench.py:21)


def _act_specs_for(mesh, cfg, cell: str) -> dict:
    """The reference's activation specs for a cell, as port specs."""
    return _act_specs(mesh, cfg, *SHAPE_CELLS[cell])


def _act_specs(mesh, cfg, seq: int, batch: int, step: str) -> dict:
    axes = mesh_axes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    model = axes["model"]
    dp = math.prod(axes[a] for a in dp_axes)
    specs: dict = {}
    if step == "decode" or batch % dp:
        return specs
    if step == "train":
        # residual stream [B, S, D]: batch over dp, sequence over model (SP)
        specs["act"] = ((dp_axes, "model", None)
                        if seq % model == 0 else (dp_axes, None, None))
        specs["logits"] = ((dp_axes, None, "model")
                           if cfg.vocab % model == 0 else
                           (dp_axes, None, None))
    if step == "prefill" and cfg.n_heads % model != 0:
        # per-chunk sequence-parallel attention for head counts that don't
        # divide TP: q/k/v replicate over model, each query chunk's rows
        # shard over model, outputs re-concatenate (prefill only, as in
        # the reference)
        specs["attn_kv"] = (dp_axes, None, None, None)
        specs["attn_chunk"] = (dp_axes, "model", None, None)
        specs["attn_chunks"] = (None, dp_axes, "model", None, None)
    return specs


# ------------------------------------------------------------------ placing


def _place(t, sharding):
    """``t`` as a ``DTensor`` with ``sharding``'s placements, a shard over
    a mesh dim of size 1 written as a replica (the same layout, which no
    DTensor rule then has to treat as sharded)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh, placements = sharding
    placements = [Replicate() if mesh.size(i) == 1 else p
                  for i, p in enumerate(placements)]
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _place_tree(tree, shardings):
    """``tree`` (dicts, lists, tuples of tensors) with every tensor placed
    by the matching ``(mesh, placements)`` of ``shardings``."""
    if isinstance(tree, dict):
        return {k: _place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place_tree(v, s) for v, s in zip(tree, shardings))
    return _place(tree, shardings)


def _place_model(model: nn.Module, mesh, notes: list) -> None:
    """Every parameter of ``model`` replaced by its ``DTensor``, placed by
    the production rules (``param_pspecs``, fallbacks into ``notes``)."""
    params = dict(model.named_parameters())
    sh = shardings_for(param_pspecs(params, mesh, notes), mesh)
    for name, p in params.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        setattr(mod, leaf, nn.Parameter(_place(p.detach(), sh[name])))


def _leaves(tree):
    """The tensors of ``tree``: a module's parameters, dicts, lists and
    tuples of tensors."""
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local_bytes(tree) -> int:
    """Rank 0's bytes of every tensor in ``tree`` (a ``DTensor``'s shard)."""
    return sum(t.numel() * t.element_size() for t in
               (x.to_local() if is_dtensor(x) else x for x in _leaves(tree)))


def _fresh_sharding_cache() -> None:
    """Empty DTensor's sharding-propagation caches (the Python one and,
    where torch has it, the native one): torch 2.13 keys ``topk``'s entry
    without ``k``, so a trace after another architecture's could reuse
    that one's output shape."""
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    for clear in (getattr(getattr(prop, "propagate_op_sharding", None),
                          "cache_clear", None),
                  getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None)):
        if clear is not None:
            clear()


# ------------------------------------------------------------------ steps


def _train_step(model, opt: AdamW, state: dict, batch: dict):
    """One train step as the reference's compiled one runs it: the loss and
    every gradient, each gradient brought to its parameter's layout (the
    reduce-scatters and all-reduces GSPMD inserts), and AdamW on each
    rank's shards (elementwise: nothing to send).  Returns the loss."""
    from ..distributed.comm import redistribute

    names, params = zip(*model.named_parameters())
    loss = lm.loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params, materialize_grads=True)

    def local(t):
        return t.to_local() if is_dtensor(t) else t

    shards_p, shards_g = {}, {}
    for n, p, g in zip(names, params, grads):
        if is_dtensor(g) and g.placements != p.placements:
            g = redistribute(g, p.placements)
        shards_p[n], shards_g[n] = local(p.detach()), local(g)
    shards_s = {"step": local(state["step"]),
                "m": {n: local(t) for n, t in state["m"].items()},
                "v": {n: local(t) for n, t in state["v"].items()}}
    opt.update(shards_p, shards_g, shards_s)
    return loss


def _inputs(arch: str, cfg, seq: int, batch: int, step: str, mesh,
            notes: list) -> tuple:
    """The step's arguments and a function running the step once: the
    cell's model, optimizer state (train), batch and cache (decode), placed
    on ``mesh`` (``None``: plain ``meta`` tensors)."""
    _fresh_sharding_cache()
    model = lm.LM(cfg, device="meta")
    batch_in = step_specs(cfg, seq, batch, step)
    if mesh is not None:
        _place_model(model, mesh, notes)
        batch_in = _place_tree(batch_in, shardings_for(
            batch_pspecs(batch_in, mesh, global_batch=batch), mesh))
    if step == "train":
        opt = AdamW(lr=1e-4,
                    state_dtype="bfloat16" if "400b" in arch else None)
        state = opt.init(dict(model.named_parameters()))
        if mesh is not None:
            for key in ("m", "v"):
                sh = shardings_for(param_pspecs(
                    {f"{key}/{n}": t for n, t in state[key].items()}, mesh,
                    notes), mesh)
                state[key] = {n: _place(t, sh[f"{key}/{n}"])
                              for n, t in state[key].items()}
            state["step"] = _place(state["step"], shardings_for((), mesh))
        return ((model, state, batch_in),
                lambda: _train_step(model, opt, state, batch_in))
    if step == "prefill":
        @torch.no_grad()
        def prefill():
            return lm.prefill_fn()(model, batch_in)
        return (model, batch_in), prefill
    cache = lm.init_cache(cfg, batch, cap=seq, device="meta")
    if mesh is not None:
        cache = _place_tree(cache, shardings_for(
            cache_pspecs(cache, mesh, batch=batch), mesh))

    @torch.no_grad()
    def decode():
        return lm.decode_fn()(model, cache, batch_in)
    return (model, cache, batch_in), decode


def lower_step(arch: str, cfg, seq: int, batch: int, step: str, mesh, *,
               compile_: bool = True, cell: str | None = None) -> dict:
    """The lowering proof of one (config x batch x length x step) on
    ``mesh`` (rank 0 of the initialized placeholder world).  The record
    has the reference's keys:

    * ``flops``: rank 0's matrix-product FLOPs; ``bytes_accessed`` and
      ``traffic_bytes_per_device``: its traffic estimate (both the
      counter's ``traffic_bytes``);
    * ``argument_size_in_bytes`` / ``output_size_in_bytes``: rank 0's
      bytes of the step's arguments (parameters, optimizer state, batch,
      cache) and of what it returns (train: parameters, optimizer state
      and loss, updated in place; prefill: the logits; decode: the logits
      and the cache), exact;
    * ``temp_size_in_bytes``: the most live ``meta`` storage torch's
      ``MemTracker`` saw over the step beyond the arguments (outputs
      included, which XLA's figure leaves out);
    * ``collectives``, ``collective_counts``, ``whiles`` (always ``[]``),
      ``sharding_fallbacks`` (``param_pspecs``' notes, then DTensor's
      departures from GSPMD's layout);
    * ``lower_s``: seconds from placement to the end of the step (of the
      placement alone with ``compile_=False``, which places everything
      and runs nothing, as the reference stops after lowering); no
      ``compile_s``: nothing compiles;
    * ``flops_exact`` / ``bytes_lowered_exact``: :func:`exact_cost`."""
    from torch.distributed._tools.mem_tracker import MemTracker

    rec: dict = {"arch": arch, "cell": cell or f"{step}_{batch}x{seq}",
                 "mesh": describe_mesh(mesh), "status": "ok"}
    notes: list = []
    t0 = time.time()
    with recorded_fallbacks() as departures, \
            activation_specs(**_act_specs(mesh, cfg, seq, batch, step)):
        args, run = _inputs(arch, cfg, seq, batch, step, mesh, notes)
        rec["argument_size_in_bytes"] = _local_bytes(args)
        if not compile_:
            rec["lower_s"] = round(time.time() - t0, 2)
            return rec
        counter = CollectiveCounter()
        mem = MemTracker()
        mem.track_external(*_leaves(args))
        with mem, counter:
            out = run()
        rec["lower_s"] = round(time.time() - t0, 2)
    rep = counter.report()
    outputs = args[:2] + (out,) if step == "train" else out
    rec["flops"] = rep.flops
    rec["bytes_accessed"] = rep.traffic_bytes
    rec["output_size_in_bytes"] = _local_bytes(outputs)
    peak = sum(v.get("Total", 0)
               for v in mem.get_tracker_snapshot("peak").values())
    rec["temp_size_in_bytes"] = int(peak) - rec["argument_size_in_bytes"]
    rec["collectives"] = dict(rep.collective_bytes)
    rec["collective_counts"] = {k: v for k, v in
                                rep.collective_counts.items() if v}
    rec["traffic_bytes_per_device"] = rep.traffic_bytes
    rec["whiles"] = rep.whiles
    rec["sharding_fallbacks"] = ([f"{p}: {r}" for p, s, l, r in notes] +
                                 [f"act {d}" for d in sorted(departures)])
    rec.update(exact_cost(cfg, seq=seq, batch=batch, step=step, arch=arch))
    return rec


def lower_cell(arch: str, cell: str, mesh, *, compile_: bool = True) -> dict:
    """The lowering proof of one assigned cell (``SHAPE_CELLS``) of the
    production config ``arch`` on ``mesh``: :func:`lower_step`'s record,
    or ``status: skipped`` with the reason where the cell does not
    apply."""
    cfg = get_config(arch)
    skip = cfg.supports_cell(cell)
    if skip:
        return {"arch": arch, "cell": cell, "mesh": describe_mesh(mesh),
                "status": "skipped", "reason": skip}
    seq, batch, step = SHAPE_CELLS[cell]
    return lower_step(arch, cfg, seq, batch, step, mesh, compile_=compile_,
                      cell=cell)


def exact_cost(cfg, cell: str | None = None, *, seq: int | None = None,
               batch: int | None = None, step: str | None = None,
               arch: str = "") -> dict:
    """Global FLOPs and bytes of one cell from one unsharded trace (plain
    ``meta`` tensors, ``unrolled_scans(True)`` set as the reference sets
    it): ``flops_exact``, the matrix products' FLOPs, and
    ``bytes_lowered_exact``, the traffic estimate.  The reference
    extrapolates from 1- and 2-group lowerings because XLA counts a while
    body once; an eager trace runs every layer, so nothing needs
    correcting."""
    if cell is not None:
        seq, batch, step = SHAPE_CELLS[cell]
    counter = CollectiveCounter()
    with unrolled_scans(True):
        _, run = _inputs(arch or cfg.name, cfg, seq, batch, step, None, [])
        with counter:
            run()
    rep = counter.report()
    return {"flops_exact": rep.flops, "bytes_lowered_exact": rep.traffic_bytes}


# ------------------------------------------------------------------ pane step


def _per_shard(fn, *xs):
    """``fn(*xs)``; for ``DTensor``s split over their leading (burst) axis,
    ``fn`` over each rank's own shards, the result placed as ``xs[0]``:
    propagation is per burst, so no rank needs another's (as GSPMD
    partitions the reference's ``vmap``)."""
    if not is_dtensor(xs[0]):
        return fn(*xs)
    from torch.distributed.tensor import DTensor

    out = fn(*(x.to_local() for x in xs))
    return DTensor.from_local(out, xs[0].device_mesh, xs[0].placements,
                              run_check=False)


def pane_parts(base_d, base_m, masks):
    """The pane step's propagation: the dense closed form over the dense
    bursts and the blocked Neumann solve (tile 128) over the masked ones,
    both the twins of the reference's ``jnp`` oracles
    (``kernels.ref.prefix_propagate_dense_f32``,
    ``masked_prefix_propagate_blocked``).  Returns ``(coef_d, coef_m)``."""
    return (_per_shard(ref.prefix_propagate_dense_f32, base_d),
            _per_shard(partial(ref.masked_prefix_propagate_blocked,
                               tile=128), base_m, masks))


def _resolve(coef, W, u):
    return torch.einsum("gbB,gkBC,gkC->gbk", coef, W, u)


def pane_step(base_d, base_m, masks, W, u):
    """The reference's pane step (``dryrun.py:269-275``): both
    propagations, the coefficients concatenated, each query's snapshot
    resolution ``einsum("gbB,gkBC,gkC->gbk")``, and the two sums.  On
    ``DTensor``s the resolution runs on each rank's groups and queries
    (the coefficients first laid out as ``W``'s groups are), the way GSPMD
    partitions it, with no collective."""
    coef = torch.cat(pane_parts(base_d, base_m, masks), dim=0)
    if not is_dtensor(W):
        counts = _resolve(coef, W, u)
    else:
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from ..distributed.comm import redistribute

        groups = [Shard(0) if p == Shard(0) else Replicate()
                  for p in W.placements]
        coef = redistribute(coef, groups)
        counts = DTensor.from_local(
            _resolve(coef.to_local(), W.to_local(), u.to_local()),
            W.device_mesh, [Shard(2) if p == Shard(1) else p
                            for p in W.placements], run_check=False)
    return coef.sum(dim=1), counts.sum(dim=1)


def _pane_split(dp_size: int, dense_frac: float) -> tuple[int, int]:
    G = PANE_SHAPE[0]
    Gd = (int(G * dense_frac) // dp_size) * dp_size   # dp-divisible split
    return Gd, G - Gd


def pane_inputs(dp_size: int, dense_frac: float = 0.9, *, device="meta",
                seed: int = 0) -> tuple:
    """The pane step's five inputs, f32: ``base_d [Gd, b, B]``, ``base_m
    [Gm, b, B]``, ``masks [Gm, b, b]``, ``W [G, k, B, C]``, ``u [G, k,
    C]``, with the reference's dp-divisible split.  On ``meta``, shapes
    only; on a real device, drawn from ``seed``: integer-valued bases in
    [0, 3) (counts), strictly-lower 0/1 masks of density
    ``PANE_DENSITY``, and integer-valued ``W`` and ``u`` in [0, 2)."""
    G, b, B, k, C = PANE_SHAPE
    Gd, Gm = _pane_split(dp_size, dense_frac)
    shapes = ((Gd, b, B), (Gm, b, B), (Gm, b, b), (G, k, B, C), (G, k, C))
    dev = torch.device(device)
    if dev.type == "meta":
        return tuple(torch.empty(s, dtype=torch.float32, device=dev)
                     for s in shapes)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.float32)

    masks = torch.tril((torch.rand(shapes[2], generator=gen, device=dev)
                        < PANE_DENSITY).float(), diagonal=-1)
    return (ints(shapes[0], 3), ints(shapes[1], 3), masks,
            ints(shapes[3], 2), ints(shapes[4], 2))


def hamlet_pane_step(mesh, dense_frac: float = 0.9) -> dict:
    """The lowering proof of the HAMLET dataplane on a production mesh
    (beyond the 40 cells): the pane step on ``meta`` inputs placed as the
    reference places them (bursts over the data-parallel axes; ``W`` and
    ``u`` also their queries over model), traced as rank 0.  Mirrors the
    engine's production mix: ~90% of bursts dense (the O(b) closed form),
    the rest through the blocked solve (the Pallas kernel's algorithm).
    ``flops`` is rank 0's; ``flops_exact`` the global count of an
    unsharded trace."""
    axes = mesh_axes(mesh)
    shards = 512 if "pod" in axes else 256
    dp_size = shards // axes["model"]
    dp = tuple(a for a in ("pod", "data") if a in axes)
    specs = ((dp, None, None), (dp, None, None), (dp, None, None),
             (dp, "model", None, None), (dp, "model", None))
    G, b, B, k, C = PANE_SHAPE
    plain = pane_inputs(dp_size, dense_frac)
    t0 = time.time()
    args = [_place(t, shardings_for(s, mesh)) for t, s in zip(plain, specs)]
    counter = CollectiveCounter()
    with counter:
        pane_step(*args)
    lower_s = round(time.time() - t0, 2)
    rep = counter.report()
    exact = CollectiveCounter()
    with exact:
        pane_step(*plain)
    return {"arch": "hamlet-pane-step",
            "cell": f"G{G}xb{b}xB{B}xk{k}-dense{dense_frac}",
            "mesh": describe_mesh(mesh), "status": "ok", "lower_s": lower_s,
            "flops": rep.flops, "flops_exact": exact.report().flops,
            "traffic_bytes_per_device": rep.traffic_bytes,
            "collectives": dict(rep.collective_bytes),
            "collective_counts": {k: v for k, v in
                                  rep.collective_counts.items() if v}}


# ------------------------------------------------------------------ CLI


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [args.arch]
    cells = list(SHAPE_CELLS) if args.cell == "all" else [args.cell]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    records = []
    for multi in meshes:
        with placeholder_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            name = describe_mesh(mesh)
            try:
                rec = hamlet_pane_step(mesh)
            except Exception as e:
                rec = {"arch": "hamlet-pane-step", "cell": "pane",
                       "mesh": name, "status": "error", "error": repr(e),
                       "trace": traceback.format_exc()[-2000:]}
            records.append(rec)
            print(json.dumps({k: v for k, v in rec.items() if k != "trace"}),
                  flush=True)
            for arch in archs:
                for cell in cells:
                    try:
                        rec = lower_cell(arch, cell, mesh,
                                         compile_=not args.no_compile)
                    except Exception as e:
                        rec = {"arch": arch, "cell": cell, "mesh": name,
                               "status": "error", "error": repr(e),
                               "trace": traceback.format_exc()[-2000:]}
                    records.append(rec)
                    print(json.dumps({k: v for k, v in rec.items()
                                      if k != "trace"}), flush=True)
        out = args.out or os.path.join(
            ARTIFACT_DIR, f"dryrun_{'multi' if multi else 'single'}.json")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump([r for r in records if r["mesh"] == name], f, indent=1)

    n_err = sum(r["status"] == "error" for r in records)
    print(f"\n{len(records)} cells, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
