"""Hand-written CUDA kernels for HAMLET hot paths (masked prefix propagation,
dense-burst propagation), with numpy/torch oracles and dispatch wrappers.
See ops.py."""

from .ops import propagate, propagate_batched  # noqa: F401
