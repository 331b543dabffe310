"""Error-feedback int8 gradient compression for the cross-pod all-reduce:
the port of ``repro.distributed.compression``.

Pods replicate parameters (DP across pods), so the per-step gradient sync
crosses the slow inter-pod links once per parameter.  Each gradient leaf is
quantized to int8 against a per-leaf scale, the int8 payload is summed as
int32, dequantized, and the quantization residual is kept as *error
feedback*, added to the next step's gradient (EF-SGD; the 1-bit Adam /
EF21 lineage), which preserves convergence.  1 byte a parameter crosses the
pod links instead of 4.

The arithmetic is the reference's, one float32 operation at a time:
``scale = max|x| / 127 + 1e-12``, ``q = clip(round(x / scale), -127, 127)``
(``torch.round`` rounds half to even, as ``jnp.round`` does), ``new_e = x
- q * scale``.  Each operation rounds once, on the CPU and on the card
alike, so the port equals the reference run op by op (``jax.disable_jit``)
bit for bit.  Compiled, XLA folds ``/ 127`` into a product with a rounded
reciprocal and fuses ``x - q * scale`` into one multiply-add: the jitted
reference differs from its own source there in the last bit of a scale
and of most errors.

Trees are dicts of tensors (parameter name -> tensor).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.lm import loss_fn
from .comm import all_reduce

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_tree",
           "compressed_psum_tree", "dp_compressed_step_fn",
           "accumulate_pod_grads_", "stacked_leaves", "int8_scale",
           "sync_pods_"]


def _absmax(x: torch.Tensor) -> torch.Tensor:
    lo, hi = torch.aminmax(x)       # no |x| temporary
    return torch.maximum(-lo, hi)


def int8_scale(*xs: torch.Tensor) -> torch.Tensor:
    """``max|x| / 127 + 1e-12`` over all of ``xs``, a float32 tensor on
    their device: one leaf's scale, or the pod-shared scale of a leaf's
    ``[n_pods, *shape]`` stacks.  The divisor is a tensor on the same
    device: CUDA multiplies by the reciprocal of a host scalar divisor
    instead of dividing."""
    m = _absmax(xs[0])
    for x in xs[1:]:
        m = torch.maximum(m, _absmax(x))
    return m / m.new_tensor(127.0) + 1e-12


def _quantize(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.div(x, s).round_().clamp_(-127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor):
    """``(q, scale)``: ``x`` (float32) as int8 against its own scale."""
    s = int8_scale(x)
    return _quantize(x, s), s


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_tree(grads: dict, errors: dict):
    """Quantize (grad + carried error) per leaf; returns ``(q, scales,
    new_err)``, where ``new_err = (g + e) - dequant(q)`` is the residual fed
    back next step."""
    qs, scales, new_err = {}, {}, {}
    for n, g in grads.items():
        x = g.float() + errors[n]
        qs[n], scales[n] = quantize_int8(x)
        new_err[n] = x - dequantize_int8(qs[n], scales[n])
    return qs, scales, new_err


def compressed_psum_tree(grads: dict, errors: dict, group, n_pods: int):
    """Error-feedback compressed mean over the ranks of ``group`` (a
    ``torch.distributed`` process group, one rank a pod; the reference's
    ``axis_name``).  Returns ``(synced_grads, new_errors)``.

    Each leaf quantizes against a *pod-shared* scale (``all_reduce(MAX)``
    of the local scales: the reference's ``pmax``), so the int8 payloads
    sum exactly: one int32 ``all_reduce(SUM)`` a leaf (``psum``) is the
    whole sync, 1 byte a parameter plus a scalar on the wire.  The residual
    against the shared-scale dequantization is carried as error feedback.
    The collectives go through :func:`~repro_torch.distributed.comm.
    all_reduce`, which stages a CUDA tensor through host memory on a gloo
    group."""
    synced, new_err = {}, {}
    for n, g in grads.items():
        x = g.float() + errors[n]
        s = all_reduce(int8_scale(x), dist.ReduceOp.MAX, group)
        q = _quantize(x, s)
        new_err[n] = x - q.float() * s
        summed = all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
        synced[n] = summed.float() * s / s.new_tensor(float(n_pods))
    return synced, new_err


def accumulate_pod_grads_(model, errors: dict, batch: dict,
                          n_pods: int) -> torch.Tensor:
    """The first half of a compressed step: the batch's leading axis split
    into ``n_pods`` micro-batches, one a pod, and each pod's gradients (by
    autograd through ``loss_fn``) added in float32 into its row of
    ``errors`` (``{name: [n_pods, *shape]}``), which then holds ``g + e``.
    Each pod's gradients are freed before the next pod's backward, so two
    pods never hold gradients at once.  Returns the pods' losses
    ``[n_pods]``."""
    names, params = zip(*model.named_parameters())
    losses = []
    for p in range(n_pods):
        mb = {k: v.reshape(n_pods, v.shape[0] // n_pods, *v.shape[1:])[p]
              for k, v in batch.items()}
        loss = loss_fn(model, mb)
        grads = list(torch.autograd.grad(loss, params,
                                         materialize_grads=True))
        losses.append(loss.detach())
        with torch.no_grad():
            for i, n in enumerate(names):
                errors[n][p].add_(grads[i])
                grads[i] = None
    return torch.stack(losses)


def stacked_leaves(model) -> list[tuple[str, ...]]:
    """The model's parameter names grouped into the reference's leaves.
    The reference stacks a scanned layer's parameter over its cycle groups
    (``scan/<ci>/attn/wq`` is ``[G, ...]``: layers ``ci``, ``ci + len(
    cycle)``, ...) and the encoder's over its layers; the compressed step
    quantizes each such leaf against one scale.  Every other parameter is
    a leaf of its own."""
    cyc, n_groups, _ = model.cfg.layer_plan()
    leaves: dict[tuple, list[str]] = {}
    for n, _ in model.named_parameters():
        parts = n.split(".")
        if parts[0] == "layers" and int(parts[1]) < n_groups * len(cyc):
            key = ("scan", int(parts[1]) % len(cyc), *parts[2:])
        elif parts[:2] == ["enc", "layers"]:
            key = ("enc", *parts[3:])
        else:
            key = (n,)
        leaves.setdefault(key, []).append(n)
    return [tuple(v) for v in leaves.values()]


@torch.no_grad()
def sync_pods_(x: torch.Tensor, s: torch.Tensor, n_pods: int):
    """The sync of one parameter: ``x`` (``[n_pods, *shape]`` float32,
    ``g + e`` per pod) quantized against its leaf's pod-shared scale ``s``
    (:func:`int8_scale`), the int8 payload summed over pods as int32, and
    ``x`` overwritten with the new errors ``x - q * s``.  Returns
    ``(synced, q, summed)``, ``synced = summed * s / n_pods``."""
    q = _quantize(x, s)
    x.sub_(q.float().mul_(s))
    summed = q.sum(0, dtype=torch.int32)
    synced = summed.float().mul_(s).div_(s.new_tensor(float(n_pods)))
    return synced, q, summed


def dp_compressed_step_fn(optimizer, n_pods: int):
    """A multi-pod train step whose *cross-pod* gradient sync is
    error-feedback int8 compressed.  Returns ``(step, init_errors)``:
    ``step(model, opt_state, errors, batch) -> loss`` updates the model's
    parameters, ``opt_state`` and ``errors`` in place; ``init_errors(model)``
    gives zero errors, ``[n_pods, *shape]`` float32 a parameter.

    The pod axis is a stacked leading dimension, as in the reference: the
    global batch splits into ``[n_pods, B / n_pods, ...]`` and each pod's
    gradients land in its row of ``errors`` (:func:`accumulate_pod_grads_`;
    the reference's ``vmap``).  Each of the reference's leaves
    (:func:`stacked_leaves`) is quantized against one pod-shared scale,
    the max over its whole stack (:func:`int8_scale`), and its int8 stack
    is summed over pods as int32 (:func:`sync_pods_`); the optimizer takes
    the mean.  The loss is the mean of the pods' losses.  The model takes
    the place of the reference's ``(cfg, params)``.

    On one device nothing is sharded: the reference pins the stacked axis
    of the micro-batches, the int8 stack and the errors to the ``pod`` mesh
    axis, so that the int32 sum is the only collective on the pod links.
    Across pods the same sync is :func:`compressed_psum_tree`, one rank a
    pod."""

    def step(model, opt_state: dict, errors: dict, batch: dict):
        losses = accumulate_pod_grads_(model, errors, batch, n_pods)
        grads = {}
        for leaf in stacked_leaves(model):
            s = int8_scale(*(errors[n] for n in leaf))
            for n in leaf:
                grads[n] = sync_pods_(errors[n], s, n_pods)[0]
        optimizer.update(dict(model.named_parameters()), grads, opt_state)
        return losses.mean()

    def init_errors(model) -> dict:
        return {n: torch.zeros((n_pods, *p.shape), dtype=torch.float32,
                               device=p.device)
                for n, p in model.named_parameters()}

    return step, init_errors
