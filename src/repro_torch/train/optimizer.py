"""Hand-rolled AdamW with optional low-precision moment states.

The port of ``repro.train.optimizer``: the same update, computed in
float32 from the upcast parameter and gradient and cast back to the
parameter's type once (``torch.optim.AdamW`` computes in the parameter's
type and would not match on bfloat16 weights).  The state is a plain dict
``{"step": int32 tensor, "m": {name: tensor}, "v": {name: tensor}}``, so a
checkpoint can hold it.  Parameters and moments are updated in place, a
block of at most ``BLOCK`` elements at a time, which bounds the float32
temporaries whatever the largest parameter.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["AdamW"]

BLOCK = 1 << 24


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: str | None = None     # None: float32; "bfloat16" to halve
    grad_transform: object = None      # grad_transform.apply(grads, state)
                                       # -> (grads, state), before the update

    def _sdt(self) -> torch.dtype:
        if self.state_dtype == "bfloat16":
            return torch.bfloat16
        return torch.float32

    def init(self, params: dict) -> dict:
        """Zero moments of each parameter's shape on its device; ``params``
        maps names to tensors (``dict(model.named_parameters())``)."""
        def zeros():
            return {n: torch.zeros(p.shape, dtype=self._sdt(),
                                   device=p.device)
                    for n, p in params.items()}

        dev = next(iter(params.values())).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": zeros(), "v": zeros()}

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict):
        """One step: writes each parameter of ``params`` and the moments of
        ``state`` in place and sets ``state["step"]``; returns ``(params,
        state)``.  ``grads`` maps the same names to gradients."""
        if self.grad_transform is not None:
            grads, state = self.grad_transform.apply(grads, state)
        step = state["step"] + 1
        c1 = 1.0 - self.b1 ** step.float()
        c2 = 1.0 - self.b2 ** step.float()
        for name, p in params.items():
            flat = (p.view(-1), grads[name].reshape(-1),
                    state["m"][name].view(-1), state["v"][name].view(-1))
            for s in range(0, p.numel(), BLOCK):
                self._update(*(t[s:s + BLOCK] for t in flat), c1, c2)
        state["step"] = step
        return params, state

    def _update(self, p, g, m, v, c1, c2):
        """The reference's ``upd`` on one block, in float32, in place:
        m = m b1 + (1 - b1) g; v = v b2 + (1 - b2) g g; d = (m / c1) /
        (sqrt(v / c2) + eps) (+ weight_decay p); p = p - lr d."""
        g32 = g.float()
        m32, v32 = m.float(), v.float()     # the moments themselves if f32
        m32.mul_(self.b1).add_(g32 * (1 - self.b1))
        v32.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
        d = m32 / c1
        d.div_((v32 / c2).sqrt_().add_(self.eps))
        p32 = p.float()                     # the parameter itself if f32
        if self.weight_decay:
            d.add_(self.weight_decay * p32)
        p32.sub_(self.lr * d)
        if p32 is not p:
            p.copy_(p32)
