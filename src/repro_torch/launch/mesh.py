"""Production mesh construction: the port of ``repro.launch.mesh``.

Importing this module touches no device and no process group; call
:func:`make_production_mesh` once ``torch.distributed`` is initialized with
the mesh's world (one rank a device).
"""

from __future__ import annotations

import math

__all__ = ["make_production_mesh", "describe_mesh"]


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
