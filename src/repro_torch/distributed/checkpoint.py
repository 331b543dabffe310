"""Checkpointing without orbax or tensorstore: the port of
``repro.distributed.checkpoint``, on the same on-disk protocol.

Layout: one directory per step (``step_%010d``) containing ``leaf_<i>.npy``
files plus ``index.json`` (tree structure, dtypes, shapes, step) and a final
``COMMITTED`` marker, written under ``<dir>.tmp`` and renamed — a crash
mid-write never yields a readable-but-corrupt checkpoint.  Leaves are
numbered as ``jax.tree_util`` flattens the tree (dict keys sorted, tuples
and lists in order, ``None`` holding no leaf), so a tree of dicts of arrays
written by either package reads in the other.  bfloat16 leaves are stored
as raw bytes with the dtype's name in ``index.json``, as the reference
stores them, and read back through torch views (no ``ml_dtypes``).

Restore places every leaf on a ``device`` with the type of the matching
leaf of ``like_tree``, or, given ``shardings`` (the tree
``sharding.shardings_for`` gives), as a ``DTensor`` on a mesh: elastic
resharding onto whatever mesh is live.  A ``DTensor`` leaf is saved as its
full tensor, so the files are those of a tree of plain tensors; every rank
of its mesh takes part in the gather, and only global rank 0 writes.

Writes can be asynchronous (a non-daemon ``ckpt-write`` thread) so the
train loop overlaps checkpoint I/O with compute; ``wait()`` joins before
the next save or exit.  Every leaf is copied to the host before the thread
starts: the optimizer updates parameters and moments in place, so a leaf
read later by the thread could hold a later step's values.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]


def _flatten(tree, is_leaf=None):
    """(leaves, rebuild, treedef string) of a tree of dicts, tuples, lists
    and leaves, in ``jax.tree_util``'s order; ``rebuild(leaves)`` makes the
    same structure around new leaves.  ``is_leaf(t)`` true: ``t`` is a
    leaf, whatever its type."""
    leaves = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return (lambda it: next(it)), "*"
        if isinstance(t, dict):
            keys = sorted(t)
            subs = [walk(t[k]) for k in keys]
            return (lambda it: {k: s[0](it) for k, s in zip(keys, subs)},
                    "{" + ", ".join(f"{k!r}: {s[1]}" for k, s in
                                    zip(keys, subs)) + "}")
        if isinstance(t, (tuple, list)):
            subs = [walk(x) for x in t]
            kind = type(t)
            return (lambda it: kind(s[0](it) for s in subs),
                    ("({})" if kind is tuple else "[{}]").format(
                        ", ".join(s[1] for s in subs)))
        if t is None:
            return (lambda it: None), "None"
        leaves.append(t)
        return (lambda it: next(it)), "*"

    make, desc = walk(tree)
    return leaves, (lambda new: make(iter(new))), f"PyTreeDef({desc})"


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` on the host as numpy (a ``DTensor``'s full tensor);
    bfloat16 as its raw bytes (uint8, flat), since numpy has no
    bfloat16."""
    if _is_dtensor(t):
        from .comm import full_tensor

        t = full_tensor(t)
    h = t.detach().to("cpu", copy=True).contiguous()
    if h.dtype == torch.bfloat16:
        return h.reshape(-1).view(torch.uint8).numpy()
    return h.numpy()


def _to_torch(arr: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    """The tensor a stored leaf holds: raw bytes viewed as the dtype named
    in ``index.json`` where the file's own dtype differs."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    want = getattr(torch, dtype_name)
    if t.dtype != want:
        t = t.reshape(-1).view(want)
    return t.reshape(shape)


def _is_dtensor(t) -> bool:
    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def save_checkpoint(directory: str, step: int, tree, *, blocking=True,
                    on_commit=None):
    """Write ``tree``'s leaves (tensors) as step ``step`` under
    ``directory``; returns the writer thread when ``blocking`` is false,
    else None.  With ``DTensor`` leaves every rank of their meshes calls
    this (the gather is collective), and only global rank 0 writes (the
    others return None)."""
    leaves, _, treedef = _flatten(tree)
    meta = {"step": step, "n_leaves": len(leaves), "treedef": treedef,
            "dtypes": [str(l.dtype).removeprefix("torch.") for l in leaves],
            "shapes": [list(l.shape) for l in leaves]}
    host = [_to_host(l) for l in leaves]
    if (any(_is_dtensor(l) for l in leaves) and dist.is_initialized()
            and dist.get_rank() != 0):
        return None
    path = os.path.join(directory, f"step_{step:010d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    def write():
        for i, h in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), h)
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        if on_commit is not None:
            on_commit()

    if blocking:
        write()
        return None
    # non-daemon: an async save must be joined (CheckpointManager.wait /
    # close), never abandoned to interpreter teardown mid-write
    t = threading.Thread(target=write, name="ckpt-write")
    t.start()
    return t


def latest_step(directory: str) -> int | None:
    """The highest step under ``directory`` with a ``COMMITTED`` marker."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "COMMITTED")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _is_sharding(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and hasattr(x[0], "mesh_dim_names"))


def restore_checkpoint(directory: str, step: int, like_tree, device=None,
                       shardings=None):
    """Restore into the structure of ``like_tree``: each leaf a tensor of
    the type of ``like_tree``'s leaf, on ``device`` (default: that leaf's
    device).  ``shardings``: a tree of the same structure whose leaves are
    ``(DeviceMesh, placements)`` pairs (``sharding.shardings_for``); each
    leaf is then a ``DTensor`` on that mesh, every rank keeping its own
    shard of the file's tensor (nothing is sent)."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "index.json")) as f:
        meta = json.load(f)
    leaves, rebuild, _ = _flatten(like_tree)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, the "
                         f"tree {len(leaves)}")
    placed = ([None] * len(leaves) if shardings is None
              else _flatten(shardings, is_leaf=_is_sharding)[0])
    if len(placed) != len(leaves):
        raise ValueError(f"{len(placed)} shardings for {len(leaves)} leaves")
    if shardings is not None:
        from torch.distributed.tensor import distribute_tensor
    out = []
    for i, (ref, sh) in enumerate(zip(leaves, placed)):
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
        t = _to_torch(arr, meta["dtypes"][i], meta["shapes"][i])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        if sh is None:
            out.append(t.to(device=ref.device if device is None else device,
                            dtype=ref.dtype))
            continue
        mesh, placements = sh
        t = t.to(device=mesh.device_type, dtype=ref.dtype)
        out.append(distribute_tensor(t, mesh, placements,
                                     src_data_rank=None))
    return rebuild(out)


class CheckpointManager:
    """Periodic async checkpointing with retention of the last ``keep``."""

    def __init__(self, directory: str, interval: int = 100, keep: int = 3):
        self.directory = directory
        self.interval = interval
        self.keep = keep
        self._pending: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.interval != 0:
            return False
        self.wait()
        self._pending = save_checkpoint(self.directory, step, tree,
                                        blocking=False, on_commit=self._gc)
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def close(self):
        """Join any in-flight async save (idempotent); use at run end or
        via the context-manager form."""
        self.wait()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    def restore_latest(self, like_tree, device=None, shardings=None):
        """``(step, tree)`` of the latest committed step, or ``(None,
        None)``."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like_tree,
                                        device, shardings)
