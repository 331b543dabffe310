"""The port's mesh rules (``repro_torch.distributed.sharding``) against the
JAX package's, on the CPU.

* ``param_pspecs`` and ``explain`` for all ten architectures at full width
  (the port's model on the ``meta`` device, the reference's
  ``jax.eval_shape`` of ``init_params``) on fake meshes of (16, 16), (2,
  16, 16) and an odd (6, 10), parameter by parameter through
  ``interop.lm_state_from``'s names: a port spec is the reference's with
  the leading group ``None`` dropped where the reference stacks the
  parameter, the same spec elsewhere, and the same fallbacks;
* ``batch_pspecs``, ``cache_pspecs`` and ``pane_batch_pspecs`` on the same
  meshes;
* on four spawned gloo ranks, a (2, 2) ``data`` x ``model`` mesh and a (2,
  2) ``pod`` x ``data`` one: each rank's shard of a ``DTensor`` placed by
  ``placements_for`` covers the index ranges that the reference's
  ``NamedSharding(...).devices_indices_map(shape)`` gives its device on a
  row-major (2, 2) host mesh (four forced host devices, one subprocess for
  the module); and gemma2-2b's smoke parameters distributed by
  ``shardings_for(param_pspecs(...))`` hold the local shapes the rule says
  and gather back to the parameter.
"""

import math
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.distributed import sharding as J
from repro.models.lm import init_cache as jax_init_cache
from repro.models.lm import init_params as jax_init_params
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as S
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.models.lm import LM, init_cache

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "6x10": {"data": 6, "model": 10}}


def fake_mesh(name):
    shape = MESHES[name]

    class FakeMesh:
        axis_names = tuple(shape)

    FakeMesh.shape = shape
    return FakeMesh()


def jtuple(spec) -> tuple:
    return tuple(spec)


class RefLeaf:
    """A reference leaf carried through ``lm_state_from``: its path, spec
    and shape; indexing it (``a[g]``) marks it as one group's slice."""

    def __init__(self, path, spec, shape, stacked=False):
        self.path, self.spec, self.shape = path, spec, shape
        self.stacked = stacked

    def __getitem__(self, g):
        return RefLeaf(self.path, self.spec, self.shape, True)


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


@pytest.fixture(scope="module")
def shapes():
    """arch -> (the reference's abstract params, the port's meta params)."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_config(arch)
        ref = jax.eval_shape(lambda c=jcfg: jax_init_params(
            c, jax.random.PRNGKey(0)))
        out[arch] = (ref, dict(LM(get_config(arch),
                                  device="meta").named_parameters()))
    return out


def _ref_by_port_name(arch, ref_params, mesh, notes=None):
    specs = J.param_pspecs(ref_params, mesh, notes)
    flat_specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    leaves = [RefLeaf(_path(p), s, tuple(l.shape))
              for (p, l), s in zip(flat, flat_specs)]
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(ref_params), leaves)
    return interop.lm_state_from(get_config(arch), tree)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, mesh, shapes):
    ref_params, params = shapes[arch]
    fm = fake_mesh(mesh)
    want = _ref_by_port_name(arch, ref_params, fm)
    got = S.param_pspecs(params, fm)
    assert got.keys() == want.keys()
    for n, spec in got.items():
        w = want[n]
        ref = jtuple(w.spec)
        if w.stacked:
            assert ref[0] is None and tuple(params[n].shape) == w.shape[1:]
            ref = ref[1:]
        assert spec == ref, (n, spec, ref)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_explain_matches_reference(arch, mesh, shapes):
    """The same fallbacks to replication, each named by the port's
    parameter and shape (a stacked reference leaf's note is each of its
    layers' note)."""
    ref_params, params = shapes[arch]
    fm = fake_mesh(mesh)
    ref_notes: list = []
    by_name = _ref_by_port_name(arch, ref_params, fm, ref_notes)
    by_path: dict = {}
    for n, w in by_name.items():
        by_path.setdefault(w.path, []).append((n, w.stacked))
    want = sorted((n, shape[1:] if stacked else shape, logical, reason)
                  for path, shape, logical, reason in ref_notes
                  for n, stacked in by_path[path])
    got = sorted(S.explain(params, fm))
    assert got == want
    if mesh == "6x10":
        assert got                  # the odd mesh does fall back


def _batch_shapes(cfg, B, S_):
    d = {"tokens": (B, S_), "labels": (B, S_), "pos": (B,)}
    if cfg.mrope_sections is not None:
        d["positions"] = (3, B, S_)
    if cfg.enc_dec:
        d["frames"] = (B, S_, cfg.d_model)
    return d


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("B", [64, 1, 6])
def test_batch_pspecs_match_reference(B, mesh):
    fm = fake_mesh(mesh)
    for arch in ("qwen2-vl-7b", "whisper-tiny"):
        shapes = _batch_shapes(get_config(arch), B, 4096)
        want = J.batch_pspecs({k: jax.ShapeDtypeStruct(s, np.int32)
                               for k, s in shapes.items()}, fm,
                              global_batch=B)
        got = S.batch_pspecs({k: torch.empty(s, device="meta")
                              for k, s in shapes.items()}, fm,
                             global_batch=B)
        assert got == {k: jtuple(v) for k, v in want.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", [64, 1])
@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-7b", "rwkv6-7b",
                                  "whisper-tiny", "llama4-maverick-400b-a17b"])
def test_cache_pspecs_match_reference(arch, batch, mesh):
    """The port's cache is a list of per-layer dicts of unstacked leaves;
    the reference's stacks the cycle groups.  Each port spec is the
    reference's for the same layer with the group axis dropped where that
    axis is replicated; where the reference's rule lands on the group axis
    itself (a recurrent state whose layer count divides the data axis when
    the batch does not), the port's is the reference's rule for the
    unstacked leaf."""
    fm = fake_mesh(mesh)
    jcfg = jax_config(arch)
    cap = 8192
    ref_cache = jax.eval_shape(lambda: jax_init_cache(jcfg, batch, cap))
    ref_specs = J.cache_pspecs(ref_cache, fm, batch=batch)
    cache = init_cache(get_config(arch), batch, cap, device="meta")
    got = S.cache_pspecs(cache, fm, batch=batch)
    assert len(got) == len(cache)
    cyc, n_groups, _ = get_config(arch).layer_plan()
    for i, layer in enumerate(got):
        g, ci = divmod(i, len(cyc))
        stacked = g < n_groups
        ref_layer = (ref_specs["scan"][ci] if stacked
                     else ref_specs["tail"][i - n_groups * len(cyc)])
        ref_shapes = (ref_cache["scan"][ci] if stacked
                      else ref_cache["tail"][i - n_groups * len(cyc)])
        assert layer.keys() == ref_layer.keys()
        for key in layer:
            g_specs = layer[key] if key.endswith("_state") else [layer[key]]
            r_specs = (list(ref_layer[key]) if key.endswith("_state")
                       else [ref_layer[key]])
            r_shapes = (list(ref_shapes[key]) if key.endswith("_state")
                        else [ref_shapes[key]])
            for gs, rs, rshape in zip(g_specs, r_specs, r_shapes):
                rs = jtuple(rs)
                if stacked and rs[0] is None:
                    rs = rs[1:]
                elif stacked:           # the group axis itself is sharded
                    unstacked = {key: jax.ShapeDtypeStruct(
                        rshape.shape[1:], rshape.dtype)}
                    rs = jtuple(J.cache_pspecs({"tail": [unstacked]}, fm,
                                               batch=batch)["tail"][0][key])
                assert tuple(gs) == rs, (arch, i, key, gs, rs)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("ndim", [2, 3])
def test_pane_batch_pspecs_match_reference(mesh, ndim):
    fm = fake_mesh(mesh)
    assert S.pane_batch_pspecs(fm, ndim) == jtuple(J.pane_batch_pspecs(
        fm, ndim))


def test_placements_refuse_a_tuple_out_of_mesh_order():
    class Mesh:
        mesh_dim_names = ("data", "model")

    with pytest.raises(ValueError, match="mesh's order"):
        S.placements_for((("model", "data"), None), Mesh())


# ------------------------------------------------------- shards on 4 ranks

# (mesh axes, shape, spec) on a (2, 2) mesh
PLACED = [
    (("data", "model"), (8, 12), ("data", "model")),
    (("data", "model"), (8, 12), ("model", "data")),
    (("data", "model"), (8, 12, 4), (None, "model", None)),
    (("data", "model"), (8, 12), (("data", "model"), None)),
    (("pod", "data"), (8, 12), (("pod", "data"), None)),
    (("pod", "data"), (8, 12), ("pod", "data")),
    (("pod", "data"), (4, 8, 6), (None, ("pod", "data"), None)),
]

REF_CODE = r'''
import pickle, sys
import jax, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
placed = pickle.loads(bytes.fromhex(sys.argv[2]))
devs = jax.devices()[:4]
out = []
for axes, shape, spec in placed:
    mesh = jax.make_mesh((2, 2), axes, axis_types=(AxisType.Auto,) * 2,
                         devices=devs)
    rank = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
    ranges = [None] * 4
    for d, sl in idx.items():
        ranges[rank[d]] = [sl_.indices(n)[:2] for sl_, n in zip(sl, shape)]
    out.append(ranges)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


@pytest.fixture(scope="module")
def ref_ranges(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ranges.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_CODE),
                        str(path), pickle.dumps(PLACED).hex()],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _ranks_main(rank, n):
    """One rank: the index ranges of its shard of each ``PLACED`` case,
    and gemma2-2b's smoke parameters distributed by their rules."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import reduce_for_smoke
    from repro_torch.distributed.comm import full_tensor

    meshes = {}
    ranges = []
    for axes, shape, spec in PLACED:
        if axes not in meshes:
            meshes[axes] = init_device_mesh("cpu", (2, 2),
                                            mesh_dim_names=axes)
        mesh = meshes[axes]
        full = torch.arange(int(np.prod(shape))).reshape(shape)
        local = distribute_tensor(full, mesh, S.placements_for(spec, mesh),
                                  src_data_rank=None).to_local()
        start = np.unravel_index(int(local.reshape(-1)[0]), shape)
        r = [(int(a), int(a) + m) for a, m in zip(start, local.shape)]
        sl = tuple(slice(a, b) for a, b in r)
        assert torch.equal(local, full[sl])
        ranges.append(r)
    mesh = meshes[("data", "model")]
    model = LM(reduce_for_smoke(get_config("gemma2-2b")), device="cpu")
    params = dict(model.named_parameters())
    specs = S.param_pspecs(params, mesh)
    placed = S.shardings_for(specs, mesh)
    sizes = S.mesh_axes(mesh)
    params_ok = []
    for name, p in params.items():
        dt = distribute_tensor(p.detach(), *placed[name], src_data_rank=None)
        want = tuple(
            d // math.prod(sizes[a] for a in (
                () if e is None else (e,) if isinstance(e, str) else e))
            for d, e in zip(p.shape, specs[name]))
        params_ok.append((name, tuple(dt.to_local().shape) == want,
                          torch.equal(full_tensor(dt), p.detach())))
    return {"ranges": ranges, "params": params_ok}


@pytest.fixture(scope="module")
def rank_ranges(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    return spawn_ranks(_ranks_main, 4, store_dir=str(d), backend="gloo",
                       timeout=300)


@pytest.mark.parametrize("case", range(len(PLACED)))
def test_shards_cover_the_reference_index_ranges(case, ref_ranges,
                                                 rank_ranges):
    want = [[tuple(r) for r in ranges] for ranges in ref_ranges[case]]
    got = [[tuple(r) for r in out["ranges"][case]] for out in rank_ranges]
    assert got == want, PLACED[case]


def test_param_shardings_distribute_smoke_params(rank_ranges):
    for out in rank_ranges:
        bad = [n for n, shape_ok, full_ok in out["params"]
               if not (shape_ok and full_ok)]
        assert not bad and len(out["params"]) == 24, bad
