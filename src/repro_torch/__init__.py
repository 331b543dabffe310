"""PyTorch/CUDA port of the HAMLET reproduction.

The package mirrors ``repro``'s module layout (``repro_torch.core.engine``
for ``repro.core.engine`` and so on) and imports neither JAX nor ``repro``.
Host planning stays numpy; device work runs as torch tensors on an explicit
``torch.device``, through hand-written CUDA kernels for Hopper
(``kernels/csrc``) on the default ``backend="cuda"``.
"""
