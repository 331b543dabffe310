"""Production mesh construction: the port of ``repro.launch.mesh``.

Importing this module touches no device and no process group; call
:func:`make_production_mesh` once ``torch.distributed`` is initialized with
the mesh's world (one rank a device), or inside :func:`placeholder_world`,
the world of placeholder ranks the lowering proofs trace on.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

__all__ = ["make_production_mesh", "describe_mesh", "placeholder_world"]


@contextmanager
def placeholder_world(n: int):
    """A world of ``n`` placeholder ranks in this one process, this process
    being rank 0: torch's fake process group (backend ``"fake"`` on a
    ``FakeStore``), whose collectives move no data, destroyed on exit.
    The twin of the reference's ``--xla_force_host_platform_device_count
    =512``: ``make_production_mesh(device_type="cpu")`` works inside it
    (with ``n`` 256 or 512), and ``DTensor``s on ``meta`` tensors trace a
    rank's share of a program without memory.  Refuses to start while a
    process group is initialized."""
    import torch.distributed as dist
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "placeholder world needs this process to itself")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (16, 16) = 256 devices, axes (data, model).  Multi-pod:
    (2, 16, 16) = 512 devices, axes (pod, data, model).

    A ``DeviceMesh`` over the initialized world, whose size must be the
    mesh's (raises, naming both, otherwise).  ``device_type`` defaults to
    ``"cuda"`` and raises without a GPU; pass ``"cpu"`` for gloo ranks on
    the host."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the production mesh; pass "
                           "device_type='cpu' for ranks on the host")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(
            f"the production mesh {'x'.join(map(str, shape))} {axes} needs "
            f"a world of {need} ranks; the initialized world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def describe_mesh(mesh) -> str:
    """``"data=16xmodel=16"``: each axis and its size, in mesh order."""
    from ..distributed.sharding import mesh_axes

    return "x".join(f"{a}={n}" for a, n in mesh_axes(mesh).items())
