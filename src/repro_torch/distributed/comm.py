"""The collectives of the distributed substrate, over a ``torch.distributed``
process group chosen by the caller.

The backend is the group's, never switched here.  NCCL takes CUDA tensors,
one card a rank (it refuses two ranks on one device).  gloo runs several
ranks on one card, or on the CPU, and works on host memory: its CUDA
``all_reduce`` copies through the host itself, its point-to-point ops
take host tensors, and ``DTensor``'s collectives on a CUDA tensor over
gloo crash the process (seen with torch 2.11 on an H100: ``full_tensor()``
of a CUDA ``DTensor`` on a gloo mesh, while the plain ``all_reduce`` and
``all_gather`` of the same tensors ran).  So on a gloo group every op here
copies a CUDA tensor to the host, reduces, sends or regathers it there,
and copies it back; a staged ``DTensor`` is redistributed as the same
shards on a host twin of its mesh, built on the mesh's own groups.  Those
copies are this module's: counted and timed in :data:`STAGING` (device
synced), never a silent change of backend.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "ring_shift", "redistribute", "full_tensor",
           "STAGING", "HostStaging"]


class HostStaging:
    """Copies of CUDA tensors through host memory for a gloo group: how
    many, their bytes each way, and their seconds on the host clock."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.copies = 0
        self.bytes = 0
        self.seconds = 0.0

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        h = t.cpu()
        self._count(h, t0)
        return h

    def back(self, h: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        out.copy_(h)
        torch.cuda.synchronize(out.device)
        self._count(h, t0)
        return out

    def _count(self, h: torch.Tensor, t0: float) -> None:
        self.copies += 1
        self.bytes += h.numel() * h.element_size()
        self.seconds += time.perf_counter() - t0


STAGING = HostStaging()


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, op, group=None) -> torch.Tensor:
    """``t`` reduced in place over ``group`` with ``op``; returns ``t``."""
    if not _staged(t, group):
        dist.all_reduce(t, op=op, group=group)
        return t
    h = STAGING.to_host(t)
    dist.all_reduce(h, op=op, group=group)
    return STAGING.back(h, t)


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """The tensor that the previous rank of ``group`` holds (rank 0
    receives the last rank's); ``t`` goes to the next rank.  Every rank
    passes a tensor of the same shape and type."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.clone()
    me = dist.get_rank(group)

    def peer(r):            # P2POp takes global ranks
        return r if group is None else dist.get_global_rank(group, r)

    nxt, prv = peer((me + 1) % n), peer((me - 1) % n)
    staged = _staged(t, group)
    src = STAGING.to_host(t) if staged else t.contiguous()
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, nxt, group),
           dist.P2POp(dist.irecv, buf, prv, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return STAGING.back(buf, torch.empty_like(t)) if staged else buf


def _host_twin(mesh):
    """A host ``DeviceMesh`` over the same ranks, names and process groups
    as ``mesh`` (making it creates no group)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh.from_group(
        [mesh.get_group(i) for i in range(mesh.ndim)], "cpu",
        mesh=mesh.mesh, mesh_dim_names=mesh.mesh_dim_names)


def redistribute(dt, placements):
    """``dt.redistribute(dt.device_mesh, placements)``; a CUDA ``DTensor``
    on a gloo mesh is redistributed on the host twin of its mesh and its
    new shard copied back."""
    from torch.distributed.tensor import DTensor

    mesh = dt.device_mesh
    if not (dt.device.type == "cuda"
            and dist.get_backend(mesh.get_group(0)) == "gloo"):
        return dt.redistribute(mesh, placements)
    twin = _host_twin(mesh)
    h = DTensor.from_local(STAGING.to_host(dt.to_local()), twin,
                           dt.placements, shape=dt.shape, stride=dt.stride(),
                           run_check=False)
    r = h.redistribute(twin, placements).to_local()
    out = STAGING.back(r, torch.empty(r.shape, dtype=r.dtype,
                                      device=dt.device))
    return DTensor.from_local(out, mesh, placements, shape=dt.shape,
                              stride=dt.stride(), run_check=False)


def full_tensor(dt) -> torch.Tensor:
    """The whole tensor of ``dt`` on every rank, on ``dt``'s device."""
    from torch.distributed.tensor import Replicate

    return redistribute(dt, [Replicate()] * dt.device_mesh.ndim).to_local()
