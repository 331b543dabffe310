"""Activation-partitioning hooks: the port of ``repro.models.partitioning``.

Launchers set a spec for the residual stream, the logits and the attention
operands; the model applies them through :func:`constrain` at the
reference's call sites (layer-group boundaries, attention, the cross
entropy's logits).  A spec is a tuple with one entry per tensor dim:
``None``, a mesh axis name, or a tuple of axis names (a ``PartitionSpec``
as a tuple).  ``constrain`` is the counterpart of
``with_sharding_constraint``: it redistributes a ``DTensor`` to the spec's
placements on its own mesh, and returns a plain tensor, or any tensor when
the spec is unset, as it is (so on one card every call is a no-op).

With ``("pod", "data"), "model", None`` on the residual stream the
activations shard their sequence axis over the model axis: Megatron-style
sequence parallelism.  The port has no ``lax.scan``; :func:`scan_unroll`
carries the reference's flag for the lowering proofs, which read it.
"""

from __future__ import annotations

from contextlib import contextmanager

__all__ = ["set_specs", "activation_specs", "unrolled_scans", "scan_unroll",
           "constrain"]

_KEYS = ("act", "logits", "attn_q", "attn_kv", "attn_out", "attn_chunk",
         "attn_chunks")
_SPECS: dict[str, object] = {k: None for k in _KEYS}
_SPECS["unroll"] = False


def set_specs(**kw) -> None:
    """Set every key's spec (a key not given is unset)."""
    for k in _KEYS:
        _SPECS[k] = kw.get(k)


@contextmanager
def activation_specs(**kw):
    """The specs of ``kw`` inside the block; the previous ones after it."""
    old = dict(_SPECS)
    set_specs(**kw)
    try:
        yield
    finally:
        _SPECS.update(old)


@contextmanager
def unrolled_scans(on: bool = True):
    """The reference unrolls every ``lax.scan`` inside this block for its
    roofline cost pass; the port only carries the flag."""
    old = _SPECS["unroll"]
    _SPECS["unroll"] = on
    try:
        yield
    finally:
        _SPECS["unroll"] = old


def scan_unroll() -> bool:
    return bool(_SPECS["unroll"])


def constrain(x, which: str):
    """``x`` laid out as the spec of ``which`` says: a ``DTensor`` is
    redistributed to the spec's placements on its mesh; a plain tensor, or
    any tensor while the spec is unset, comes back as it is."""
    spec = _SPECS.get(which)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from ..distributed.comm import redistribute
    from ..distributed.sharding import placements_for

    return redistribute(x, placements_for(spec, x.device_mesh))
