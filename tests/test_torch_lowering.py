"""The port's lowering proofs (``repro_torch.configs.input_specs``,
``launch.hlo_analysis``, ``launch.dryrun``, the ``jnp`` oracle twins of
``kernels.ref`` and their ``propagate_batched`` backends) against the JAX
package's, on the CPU.

Bounds:

* ``input_specs``: the same keys, shapes and dtypes for every
  architecture and cell, and the same ``supports_cell`` skips;
* ``prefix_propagate_dense_f32``: bitwise at b = 256 float32, the NaN and
  inf pattern included, on counts, on floats of either sign and on values
  near the subnormal range;
* the masked twins (row scan, triangular solve, blocked Neumann solve) and
  the ``"torch_ref"`` / ``"torch_solve"`` / ``"torch_blocked"`` backends:
  exact on integer-valued counts below 2^24 (sparse masks keep them
  there), and within ``RTOL_F32 = 1e-5`` relative (``|got - want| <=
  RTOL_F32 * (1 + |want|)``) on float32 inputs, where the two frameworks
  add in other orders;
* the collective counter on hand-counted programs: ten all-reduces of a
  ``[32, 256]`` float32 shard exactly, and a 12-step tanh-matmul chain's
  traffic inside the reference test's 0.5-4x band;
* ``lower_cell`` on ``reduce_for_smoke`` gemma2-2b and olmoe-1b-7b, in
  prefill and train, on a (2, 4) mesh, at cells cut to batch 4 x 1,024
  tokens (both packages' ``SHAPE_CELLS`` patched alike): rank 0's argument
  bytes equal to the reference's compiled ``argument_size_in_bytes`` (the
  reference run in a subprocess with 8 forced host devices and Auto mesh
  axes; the production rules shard only dims the axis divides, so no
  shard is padded and the bytes are equal, not bounded), and
  ``flops_exact`` equal to a hand count of the matrix products;
* ``_act_specs_for`` equal to the reference's for every architecture and
  cell on both production meshes' axes (the reference's computed in the
  same subprocess);
* the proof's FLOPs on a 1-rank world equal ``FlopCounterMode`` over the
  same step run for real on the CPU;
* every architecture's forward traces as ``DTensor``s on a (2, 4)
  placeholder mesh without ``implicit_replication()``.
"""

import json
import math
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.configs import input_specs as jax_input_specs
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.configs import get_config, input_specs, reduce_for_smoke
from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import CollectiveCounter
from repro_torch.launch.mesh import placeholder_world
from repro_torch.models.lm import LM

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
RTOL_F32 = 1e-5
TIMEOUT = 600

# the cut cells: batch 4 x 1,024 tokens (two 512-row query chunks, so the
# banded local path runs), the same keys and steps as the assigned ones
CUT_CELLS = {"prefill_32k": (1024, 4, "prefill"),
             "train_4k": (1024, 4, "train")}
PROOF_ARCHS = ("gemma2-2b", "olmoe-1b-7b")


# ------------------------------------------------------------ input_specs


_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32,
       "int32": torch.int32}


@pytest.mark.parametrize("cell", list(SHAPE_CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, cell):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert cfg.supports_cell(cell) == jcfg.supports_cell(cell)
    got, want = input_specs(cfg, cell), jax_input_specs(jcfg, cell)
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == _DT[jnp.dtype(w.dtype).name], k
        assert got[k].device.type == "meta"


# ------------------------------------------------------------ oracle twins


def _dense_base(kind: str, rng, shape):
    if kind == "counts":
        return rng.integers(0, 3, shape).astype(np.float32)
    if kind == "float":
        return rng.standard_normal(shape).astype(np.float32)
    return (rng.standard_normal(shape) * 1e-36).astype(np.float32)


@pytest.mark.parametrize("kind", ["counts", "float", "subnormal"])
def test_dense_f32_twin_is_bitwise(kind):
    base = _dense_base(kind, np.random.default_rng(1), (3, 256, 8))
    want = np.asarray(jax.vmap(JR.prefix_propagate_dense)(jnp.asarray(base)))
    got = TR.prefix_propagate_dense_f32(torch.from_numpy(base)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # past row 127 the float32 weights overflow: no row there is finite,
    # while the float64 oracle keeps the counts finite to float32's range
    if kind == "counts":
        assert not np.isfinite(want[:, 129:]).any()
        np_oracle = TR.prefix_propagate_dense_np_batched(base)
        assert np.isfinite(np_oracle[:, 129]).any()


def _masked_case(kind: str, b: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "counts":
        # sparse enough that every count stays below 2^24
        mask = np.tril(rng.random((3, b, b)) < 2.0 / b, -1)
        base = rng.integers(0, 3, (3, b, 4))
    else:
        mask = np.tril(rng.random((3, b, b)) < 0.3, -1)
        base = rng.standard_normal((3, b, 4))
    return base.astype(np.float32), mask.astype(np.float32)


def _held(got, want, exact: bool):
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    if exact:
        assert np.abs(want[fin]).max() < 2 ** 24
        assert np.array_equal(got, want)
    else:
        np.testing.assert_array_less(
            np.abs(got[fin] - want[fin]), RTOL_F32 * (1 + np.abs(want[fin])))


_TWINS = [("masked_prefix_propagate_ref", None),
          ("masked_prefix_propagate_solve", None),
          ("masked_prefix_propagate_blocked", 128)]


@pytest.mark.parametrize("kind", ["counts", "float"])
@pytest.mark.parametrize("name,tile", _TWINS)
def test_masked_twins_match_reference(name, tile, kind):
    base, mask = _masked_case(kind, 256, 2)
    kw = {} if tile is None else {"tile": tile}
    jf, tf = getattr(JR, name), getattr(TR, name)
    want = np.asarray(jax.vmap(lambda b, m: jf(b, m, **kw))(
        jnp.asarray(base), jnp.asarray(mask)))
    got = tf(torch.from_numpy(base), torch.from_numpy(mask), **kw).numpy()
    _held(got, want, exact=kind == "counts")


@pytest.mark.parametrize("b", [37, 128, 256])
@pytest.mark.parametrize("kind", ["counts", "float"])
@pytest.mark.parametrize("jb,tb", [("jax", "torch_ref"),
                                   ("jax_blocked", "torch_blocked"),
                                   ("jax_solve", "torch_solve")])
def test_new_backends_match_reference_backends(jb, tb, kind, b):
    base, mask = _masked_case(kind, b, b)
    want = np.asarray(JO.propagate_batched(base, mask, backend=jb))
    got = TO.propagate_batched(base, mask, backend=tb, device="cpu").numpy()
    _held(got, want, exact=kind == "counts")


def test_blocked_twin_refuses_a_ragged_tile():
    base, mask = _masked_case("counts", 100, 0)
    with pytest.raises(ValueError, match="multiple of tile"):
        TR.masked_prefix_propagate_blocked(torch.from_numpy(base),
                                           torch.from_numpy(mask), tile=64)


# ------------------------------------------------------------ the counter


def test_counter_traffic_of_a_tanh_matmul_chain():
    x = torch.empty(64, 64, device="meta")
    w = torch.empty(64, 64, device="meta")
    with CollectiveCounter() as c:
        for _ in range(12):
            x = torch.tanh(x @ w)
        x.sum()
    rep = c.report()
    per_iter = 3 * 64 * 64 * 4           # the reference test's count
    assert 12 * per_iter * 0.5 < rep.traffic_bytes < 12 * per_iter * 4
    assert rep.flops == 12 * 2 * 64 ** 3
    assert rep.whiles == [] and rep.collective_bytes["total"] == 0


def test_counter_collectives_on_a_placeholder_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)

    with placeholder_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty(64, 256, device="meta"), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(256, 256, device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with CollectiveCounter() as c:
            for _ in range(10):
                h = torch.tanh(x @ w)
                # the loop carry back in its own layout, as XLA keeps a
                # while's carry: one all-reduce of the [32, 256] shard
                x = (h @ w.T).redistribute(mesh, [Shard(0), Replicate()])
        rep = c.report()
    assert rep.collective_bytes["all-reduce"] == 10 * 32 * 256 * 4
    assert rep.collective_counts["all-reduce"] == 10
    assert rep.collective_bytes["total"] == 10 * 32 * 256 * 4
    # per rank: [32, 256] @ [256, 64] and [32, 64] @ [64, 256] a step
    assert rep.flops == 10 * 2 * (2 * 32 * 256 * 64)


# ------------------------------------------------------------ lower_cell


REF_CODE = r'''
import json, sys
from types import SimpleNamespace
import jax
jax.devices()          # 8 host devices, before dryrun's 512-device poke
from jax.sharding import AxisType
from repro.configs import ARCHS, get_config, reduce_for_smoke
from repro.configs.base import SHAPE_CELLS
from repro.launch import dryrun as D
act = {}
for name, axes in (("single", {"data": 16, "model": 16}),
                   ("multi", {"pod": 2, "data": 16, "model": 16})):
    mesh = SimpleNamespace(axis_names=tuple(axes), shape=axes)
    for arch in ARCHS:
        for cell in SHAPE_CELLS:
            specs = D._act_specs_for(mesh, get_config(arch), cell)
            act[f"{name}/{arch}/{cell}"] = {k: list(v)
                                            for k, v in specs.items()}
print("ACT" + json.dumps(act))
cells = json.loads(sys.argv[1])
SHAPE_CELLS.update({k: tuple(v) for k, v in cells.items()})
D.get_config = lambda arch: reduce_for_smoke(get_config(arch))
D.exact_cost = lambda cfg, cell: {}
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch in json.loads(sys.argv[2]):
    for cell in cells:
        rec = D.lower_cell(arch, cell, mesh)
        assert rec["status"] == "ok", rec
        out[f"{arch}/{cell}"] = rec["argument_size_in_bytes"]
print("REF" + json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", REF_CODE, json.dumps(CUT_CELLS),
         json.dumps(PROOF_ARCHS)],
        capture_output=True, text=True, env=env, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = {ln[:3]: json.loads(ln[3:]) for ln in out.stdout.splitlines()
             if ln[:3] in ("REF", "ACT")}
    return lines


def _spec(entry):
    """A spec entry as the reference's ``PartitionSpec`` prints it: a
    one-axis tuple is that axis."""
    if isinstance(entry, (list, tuple)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


@pytest.mark.parametrize("multi", [False, True])
def test_act_specs_match_reference(multi, reference):
    """``_act_specs_for`` against the reference's for every architecture
    and cell on each production mesh's axes (both read only the axis
    names and sizes)."""
    from types import SimpleNamespace

    name = "multi" if multi else "single"
    axes = ({"pod": 2, "data": 16, "model": 16} if multi else
            {"data": 16, "model": 16})
    mesh = SimpleNamespace(axis_names=tuple(axes), shape=axes)
    for arch in ARCHS:
        for cell in SHAPE_CELLS:
            want = reference["ACT"][f"{name}/{arch}/{cell}"]
            got = dryrun._act_specs_for(mesh, get_config(arch), cell)
            assert ({k: tuple(map(_spec, v)) for k, v in got.items()} ==
                    {k: tuple(map(_spec, v)) for k, v in want.items()}), (
                        arch, cell)


@pytest.fixture(scope="module")
def port_records():
    from torch.distributed.device_mesh import init_device_mesh

    saved = dict(SHAPE_CELLS)
    SHAPE_CELLS.update(CUT_CELLS)
    try:
        recs = {}
        with placeholder_world(8):
            mesh = init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model"))
            for arch in PROOF_ARCHS:
                cfg = reduce_for_smoke(get_config(arch))
                for cell, (seq, batch, step) in CUT_CELLS.items():
                    recs[f"{arch}/{cell}"] = dryrun.lower_step(
                        arch, cfg, seq, batch, step, mesh, cell=cell)
        return recs
    finally:
        SHAPE_CELLS.clear()
        SHAPE_CELLS.update(saved)


def _key_cases():
    return [f"{a}/{c}" for a in PROOF_ARCHS for c in CUT_CELLS]


@pytest.mark.parametrize("key", _key_cases())
def test_argument_bytes_equal_reference(key, reference, port_records):
    rec = port_records[key]
    assert rec["status"] == "ok"
    assert rec["argument_size_in_bytes"] == reference["REF"][key]


def _hand_flops(cfg, seq: int, batch: int, step: str) -> int:
    """The matrix products of one step, from the config: per layer the
    attention projections, attention's QK and PV over its [chunk, T]
    slabs (T the whole sequence for global layers, window + 512 for local
    ones once that is shorter), the MLP or the MoE (router, and the
    experts over their capacity buffers, one dispatch group a sequence);
    the LM head on the last position (prefill) or every position (train).
    A train step is four forwards: the forward, its recompute under
    checkpoint, and a backward of two products for each one."""
    d, hd, H = cfg.d_model, cfg.head_dim, cfg.n_heads
    n_tok = batch * seq
    flops = 0
    for kind in cfg.layer_kinds():
        flops += 2 * n_tok * (2 * d * cfg.q_dim + 2 * d * cfg.kv_dim)
        chunk = min(512, seq)
        band = cfg.window + 512
        T = band if kind.startswith("local") and band < seq else seq
        flops += 2 * 2 * batch * H * seq * T * hd
        if kind.endswith("+moe"):
            E, k = cfg.n_experts, cfg.top_k
            cap = max(1, math.ceil(seq * k * cfg.capacity_factor / E))
            flops += batch * (2 * seq * d * E + 3 * 2 * E * cap * d * cfg.d_ff)
        else:
            ff = cfg.moe_dense_ff or cfg.d_ff
            flops += 2 * n_tok * (3 if cfg.mlp_gated else 2) * d * ff
        assert chunk == 512 and seq % chunk == 0
    head = 2 * d * cfg.vocab * (batch if step == "prefill" else n_tok)
    flops += head
    return flops * (4 if step == "train" else 1)


@pytest.mark.parametrize("key", _key_cases())
def test_flops_exact_equals_hand_count(key, port_records):
    arch, cell = key.split("/")
    cfg = reduce_for_smoke(get_config(arch))
    assert port_records[key]["flops_exact"] == _hand_flops(
        cfg, *CUT_CELLS[cell])


def test_one_rank_proof_equals_flop_counter_on_a_real_step():
    """The proof on a 1-rank world against ``FlopCounterMode`` over the
    same train step run for real (``train_step_fn``, CPU, f32)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.lm import train_step_fn
    from repro_torch.train.optimizer import AdamW

    cfg = replace(reduce_for_smoke(get_config("gemma2-2b")), dtype="float32")
    seq, batch = 512, 2
    with placeholder_world(1):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        rec = dryrun.lower_step("gemma2-2b", cfg, seq, batch, "train", mesh)
    model = LM(cfg, device=CPU, seed=0)
    opt = AdamW(lr=1e-4)
    state = opt.init(dict(model.named_parameters()))
    g = torch.Generator().manual_seed(0)
    data = {k: torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                             dtype=torch.int32) for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        train_step_fn(opt)(model, state, data)
    assert rec["flops"] == fc.get_total_flops() == rec["flops_exact"]
    assert rec["flops"] == _hand_flops(cfg, seq, batch, "train")


# ------------------------------------------------------------ tracing


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_traces_on_dtensors(arch):
    """The forward of every architecture on ``DTensor`` parameters and
    inputs, without ``implicit_replication()`` (which would let plain and
    distributed tensors mix): logits of the global shape, distributed."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    cfg = reduce_for_smoke(get_config(arch))
    with placeholder_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        (model, batch), run = dryrun._inputs(arch, cfg, 32, 4, "prefill",
                                             mesh, [])
        assert all(isinstance(p, DTensor) for p in model.parameters())
        logits = run()
    assert isinstance(logits, DTensor)
    assert tuple(logits.shape) == (4, cfg.vocab)


def test_split_dim_notes_a_replicated_shard():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.partitioning import (merge_dims,
                                                 recorded_fallbacks,
                                                 split_dim)

    t = torch.arange(2 * 32, dtype=torch.float32).reshape(2, 32)
    assert torch.equal(split_dim(t, -1, (2, 16)), t.reshape(2, 2, 16))
    assert torch.equal(merge_dims(t.reshape(2, 2, 16), 1, 2), t)
    with placeholder_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        d = distribute_tensor(torch.empty(2, 32, device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with recorded_fallbacks() as notes:
            even = split_dim(d, -1, (4, 8))
            odd = split_dim(d, -1, (2, 16))
        assert even.placements == (Replicate(), Shard(1))
        assert odd.placements == (Replicate(), Replicate())
        assert tuple(odd.shape) == (2, 2, 16)
        assert notes == {"(2, 32) dim 1 -> (2, 16): 2 % 4 (model) != 0, "
                         "replicated"}


def test_placeholder_world_refuses_a_second_world():
    import torch.distributed as dist

    with placeholder_world(4):
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
        with pytest.raises(RuntimeError, match="already initialized"):
            with placeholder_world(4):
                pass
    assert not dist.is_initialized()


def test_pane_step_proof_on_the_production_mesh():
    from repro_torch.launch.mesh import make_production_mesh

    with placeholder_world(256):
        mesh = make_production_mesh(device_type="cpu")
        rec = dryrun.hamlet_pane_step(mesh)
    assert rec["status"] == "ok" and rec["mesh"] == "data=16xmodel=16"
    assert rec["cell"] == "G4096xb256xB8xk64-dense0.9"
    # rank 0 holds 1/16 of the bursts (and 1/16 of their queries): no
    # more than a data shard's share of the work, no less than the world's
    assert rec["flops_exact"] / 256 <= rec["flops"] <= rec["flops_exact"] / 16


def test_dryrun_cli_places_a_cell(tmp_path):
    out_path = tmp_path / "out.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
         "single", "--arch", "whisper-tiny", "--cell", "decode_32k",
         "--no-compile", "--out", str(out_path)],
        capture_output=True, text=True, env=env, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "2 cells, 0 errors" in out.stdout
    recs = json.loads(out_path.read_text())
    cell = [r for r in recs if r["arch"] == "whisper-tiny"]
    assert cell and cell[0]["status"] == "ok", cell
    assert cell[0]["argument_size_in_bytes"] > 0

