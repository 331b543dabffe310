"""The port's distributed substrate (``repro_torch.distributed``: the int8
error-feedback codec, ``compressed_psum_tree``, ``dp_compressed_step_fn``,
the GPipe pipeline, elastic checkpoint resharding; ``models.partitioning``;
``launch.mesh``) against the JAX package's, on the CPU.

The reference runs once for the module, in a subprocess with 16 forced
host devices, its meshes built with Auto axes (``jax.make_mesh`` makes
Explicit ones in jax 0.9, which ``with_sharding_constraint`` refuses: the
reason ``tests/test_distributed.py::test_dp_compressed_train_step`` fails).
The port's ranks run once for the module: four spawned gloo processes on a
``file://`` store under the module's temporary directory.

Bounds:
* the codec, ``compressed_psum_tree`` and the step's sync are elementwise
  float32 operations and a max: bitwise against the reference run op by op
  (``jax.disable_jit()``).  Compiled, XLA folds ``/ 127`` into a product
  with a rounded reciprocal and fuses ``x - q * s`` into one multiply-add;
  against the jitted psum the new errors stay within ``2**-14`` of the
  shared scale (a few ulps of the scale: seen 2.0e-8 of a 0.09 scale);
* the whole step on ``reduce_for_smoke(h2o-danube-1.8b)``, batch 8 x 16,
  two pods, in float32 and in the config's bf16: the loss within ``1e-5``
  relative in float32 and ``5e-4`` in bf16 (``tests/test_torch_train.py``'s
  bf16 bound; the reference's own jitted and op-by-op losses differ by
  2.2e-5 there), the parameters within ``5e-3`` (the reference test's
  bound: lr times the quantization's O(1) effect on AdamW's first steps)
  of the reference's after one and two steps, and of the port's own
  uncompressed step;
* ``pipelined_apply`` at the reference test's L 8, B 16, D 32, 4 stages,
  4 micro-batches: within ``1e-5`` of the reference's and of
  ``sequential_apply``.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import dequantize_int8 as j_dequantize
from repro.distributed.compression import ef_compress_tree as j_ef_compress
from repro.distributed.compression import quantize_int8 as j_quantize
from repro.launch.mesh import describe_mesh as j_describe_mesh
from repro_torch import interop
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.distributed import compression as C
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.launch.mesh import describe_mesh, make_production_mesh
from repro_torch.models import partitioning
from repro_torch.models.lm import LM, train_step_fn
from repro_torch.train.optimizer import AdamW

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LR = 1e-3
RTOL_LOSS = 1e-5
RTOL_LOSS_BF16 = 5e-4
PARAM_BOUND = 5e-3
PIPE_BOUND = 1e-5
JIT_ERR_BOUND = 2.0 ** -14      # of the shared scale
TIMEOUT = 600

REF_CODE = r'''
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.configs import get_config, reduce_for_smoke
from repro.models import lm
from repro.train.optimizer import AdamW
from repro.distributed import compression as C
from repro.distributed.compat import shard_map
from repro.distributed.pipeline import pipelined_apply, sequential_apply

def auto(n):
    return (AxisType.Auto,) * n

def np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)

out = {}

# compressed psum over 4 pods: an f32 leaf with carried errors, a bf16
# leaf, an all-zero leaf
rng = np.random.default_rng(11)
g = {"w": (rng.standard_normal((4, 33, 7)) * 3).astype(np.float32),
     "b": np.asarray(jnp.asarray(rng.standard_normal((4, 50)), jnp.bfloat16),
                     np.float32),
     "z": np.zeros((4, 5), np.float32)}
e = {"w": (rng.standard_normal((4, 33, 7)) * 1e-2).astype(np.float32),
     "b": np.zeros((4, 50), np.float32), "z": np.zeros((4, 5), np.float32)}
gj = {"w": jnp.asarray(g["w"]), "b": jnp.asarray(g["b"], jnp.bfloat16),
      "z": jnp.asarray(g["z"])}
mesh4 = jax.make_mesh((4,), ("pod",), axis_types=auto(1),
                      devices=jax.devices()[:4])
spec = {k: P("pod") for k in g}
psum = shard_map(lambda g, e: C.compressed_psum_tree(g, e, "pod", 4),
                 mesh=mesh4, in_specs=(spec, spec), out_specs=(spec, spec),
                 check_vma=False)
with jax.disable_jit():
    out["psum"] = np32(psum(gj, e))
out["psum_jit"] = np32(jax.jit(psum)(gj, e))
out["psum_in"] = (g, e)

# the multi-pod compressed step, two steps, in the config's bf16 and in f32
mesh = jax.make_mesh((2, 2, 4), ("pod", "data", "model"), axis_types=auto(3))
opt = AdamW(lr=1e-3)
rng = np.random.default_rng(0)
batches = [{k: rng.integers(0, 256, (8, 16)).astype(np.int32)
            for k in ("tokens", "labels")} for _ in range(2)]
jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
out["batches"] = batches
out["step"] = {}
for dtype in ("bfloat16", "float32"):
    cfg = reduce_for_smoke(get_config("h2o-danube-1.8b"))
    cfg = dataclasses.replace(cfg, dtype=dtype)
    assert cfg.vocab == 256
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    opt_state = opt.init(params)
    step, init_errors = C.dp_compressed_step_fn(cfg, opt, mesh, n_pods=2)
    errors = init_errors(params)
    with mesh:
        p1, o1, e1, l1 = step(params, opt_state, errors, jb[0])
        p2, o2, e2, l2 = step(p1, o1, e1, jb[1])
    out["step"][dtype] = {"params0": np32(params),
                          "step1": (float(l1), np32(p1), np32(o1), np32(e1)),
                          "step2": (float(l2), np32(p2))}
cfg = reduce_for_smoke(get_config("h2o-danube-1.8b"))
params = lm.init_params(cfg, jax.random.PRNGKey(0))
opt_state = opt.init(params)
errors = init_errors(params)

# the step's sync, op by op, on given per-pod gradients and carried errors
mbs = {k: v.reshape(2, 4, 16) for k, v in jb[0].items()}
pg = jax.jit(jax.vmap(lambda mb: jax.value_and_grad(
    lambda p: lm.loss_fn(p, cfg, mb))(params)))(mbs)
rng = np.random.default_rng(5)
e0 = jax.tree.map(lambda x: jnp.asarray(
    rng.standard_normal(x.shape) * 1e-3, jnp.float32), errors)

class Capture:
    def update(self, params, grads, state):
        return grads, state

cstep, _ = C.dp_compressed_step_fn(cfg, Capture(), mesh, n_pods=2)
vmap = jax.vmap
jax.vmap = lambda f, *a, **k: (lambda *args: pg)
try:
    with mesh, jax.disable_jit():
        synced, _, new_e, _ = cstep(params, opt_state, e0, jb[0])
finally:
    jax.vmap = vmap
out["sync"] = (np32(pg[1]), np32(e0), np32(synced), np32(new_e))

# GPipe over 4 stages
mesh_s = jax.make_mesh((4,), ("stage",), axis_types=auto(1),
                       devices=jax.devices()[:4])
L, B, D = 8, 16, 32
Ws = jax.random.normal(jax.random.PRNGKey(0), (L, D, D)) * 0.1
x = jax.random.normal(jax.random.PRNGKey(1), (B, D))
layer = lambda W, h: jnp.tanh(h @ W)
out["pipe"] = np32((Ws, x, sequential_apply(layer, Ws, x),
                    pipelined_apply(layer, Ws, x, mesh=mesh_s, n_micro=4)))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=16")
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_CODE),
                        str(path)], capture_output=True, text=True, env=env,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _ranks_main(rank, n, ref_path, ckpt_dir):
    """One rank of the module's four: the port's psum, pipeline, elastic
    restore, ``constrain`` on a ``DTensor`` and the production mesh's
    refusal, each on the reference's inputs where there are some."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
    from repro_torch.distributed.comm import full_tensor
    from repro_torch.distributed.compression import compressed_psum_tree
    from repro_torch.distributed.pipeline import (pipelined_apply,
                                                  sequential_apply)
    from repro_torch.distributed.sharding import (placements_for,
                                                  shardings_for)
    from repro_torch.launch.mesh import describe_mesh, make_production_mesh
    from repro_torch.models.partitioning import activation_specs, constrain

    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    g, e = ref["psum_in"]
    out = {}
    grads = {k: torch.tensor(v[rank]) for k, v in g.items()}
    grads["b"] = grads["b"].bfloat16()
    errs = {k: torch.tensor(v[rank]) for k, v in e.items()}
    synced, new_e = compressed_psum_tree(grads, errs, None, n)
    out["psum"] = ({k: v.numpy() for k, v in synced.items()},
                   {k: v.numpy() for k, v in new_e.items()})

    Ws, x = (torch.tensor(a) for a in ref["pipe"][:2])

    def layer(W, h):
        return torch.tanh(h @ W)

    out["pipe"] = (pipelined_apply(layer, Ws, x, n_micro=4).numpy(),
                   sequential_apply(layer, Ws, x).numpy())

    # elastic: save from a 1-D mesh of 4, restore onto a (2, 2) mesh
    full = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mesh1 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    xs = distribute_tensor(full, mesh1, placements_for(("data", None), mesh1),
                           src_data_rank=None)
    save_checkpoint(ckpt_dir, 1, {"x": xs})
    dist.barrier()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    got = restore_checkpoint(ckpt_dir, 1, {"x": full},
                             shardings=shardings_for({"x": ("model", "data")},
                                                     mesh))["x"]
    out["coord"] = mesh.get_coordinate()
    out["elastic"] = (full_tensor(got).numpy(), got.to_local().numpy(),
                      list(got.placements) == [Shard(1), Shard(0)])

    # constrain redistributes a DTensor, and only while a spec is set
    dt = distribute_tensor(full, mesh, [Replicate(), Replicate()],
                           src_data_rank=None)
    with activation_specs(act=("data", "model")):
        c = constrain(dt, "act")
        plain_same = constrain(full, "act") is full
    out["constrain"] = (list(c.placements) == [Shard(0), Shard(1)],
                        c.to_local().numpy(), plain_same,
                        constrain(dt, "act") is dt, describe_mesh(mesh))
    try:
        make_production_mesh(device_type="cpu")
        out["refusal"] = None
    except RuntimeError as err:
        out["refusal"] = str(err)
    return out


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    ref_path = d / "ref.pkl"
    with open(ref_path, "wb") as f:
        pickle.dump({"psum_in": ref["psum_in"], "pipe": ref["pipe"]}, f)
    return spawn_ranks(_ranks_main, 4, store_dir=str(d), backend="gloo",
                       args=(str(ref_path), str(d / "ckpt")), timeout=300)


# ------------------------------------------------------------------ codec


def _codec_cases():
    rng = np.random.default_rng(3)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                    np.float32)
    return {"f32": (rng.standard_normal((64, 9)) * 7).astype(np.float32),
            "small": (rng.standard_normal(300) * 1e-5).astype(np.float32),
            "zero": np.zeros((4, 4), np.float32),
            "ties": ties}


@pytest.mark.parametrize("case", ["f32", "small", "zero", "ties"])
def test_quantize_int8_bitwise(case):
    x = _codec_cases()[case]
    jq, js = j_quantize(jnp.asarray(x))
    q, s = C.quantize_int8(torch.tensor(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    deq = C.dequantize_int8(q, s).numpy()
    assert deq.tobytes() == np.asarray(j_dequantize(jq, js)).tobytes()
    if case == "ties":       # the scale is 1: half to even
        assert q.tolist() == [127, 0, 2, 2, 0, -2, 4, -126]


def test_ef_compress_tree_bitwise_with_bf16_leaves():
    rng = np.random.default_rng(4)
    g32 = {k: v for k, v in _codec_cases().items()}
    gb = (rng.standard_normal((16, 8)) * 2).astype(np.float32)
    jg = {**{k: jnp.asarray(v) for k, v in g32.items()},
          "bf16": jnp.asarray(gb, jnp.bfloat16)}
    tg = {**{k: torch.tensor(v) for k, v in g32.items()},
          "bf16": torch.tensor(gb).bfloat16()}
    assert np.array_equal(np.asarray(jg["bf16"], np.float32),
                          tg["bf16"].float().numpy())
    err = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
           for k, v in tg.items()}
    want = j_ef_compress(jg, {k: jnp.asarray(v) for k, v in err.items()})
    got = C.ef_compress_tree(tg, {k: torch.tensor(v) for k, v in err.items()})
    for w, h in zip(want, got):
        for k in tg:
            assert h[k].numpy().tobytes() == np.asarray(w[k]).tobytes(), k


# ------------------------------------------------------------- collectives


def test_compressed_psum_tree_bitwise_on_four_ranks(ref, ranks):
    (want_s, want_e), (jit_s, jit_e) = ref["psum"], ref["psum_jit"]
    for r, out in enumerate(ranks):
        synced, new_e = out["psum"]
        for k in synced:
            assert synced[k].tobytes() == want_s[k][r].tobytes(), (r, k)
            assert new_e[k].tobytes() == want_e[k][r].tobytes(), (r, k)
            # the compiled reference: a few ulps of the shared scale
            scale = np.abs(ref["psum_in"][0][k] + ref["psum_in"][1][k]
                           ).max() / 127.0 + 1e-12
            assert np.abs(new_e[k] - jit_e[k][r]).max() <= \
                JIT_ERR_BOUND * scale, (r, k)
            assert np.abs(synced[k] - jit_s[k][r]).max() <= \
                JIT_ERR_BOUND * scale, (r, k)


def test_pipelined_apply_matches_reference_and_sequential(ref, ranks):
    _, _, want_seq, want_pipe = ref["pipe"]
    for out in ranks:
        pipe, seq = out["pipe"]
        assert np.abs(pipe - want_pipe).max() <= PIPE_BOUND
        assert np.abs(pipe - seq).max() <= PIPE_BOUND
        assert np.abs(seq - want_seq).max() <= PIPE_BOUND


def test_checkpoint_elastic_reshard(ranks):
    """Saved from a 1-D mesh of 4 ranks, restored onto a (2, 2) mesh with
    dim 0 over "model" and dim 1 over "data": the reference's
    ``test_checkpoint_elastic_reshard``."""
    full = np.arange(64, dtype=np.float32).reshape(8, 8)
    for out in ranks:
        got, local, placed = out["elastic"]
        di, mi = out["coord"]
        assert placed and np.array_equal(got, full)
        assert np.array_equal(local, full[mi * 4:(mi + 1) * 4,
                                          di * 4:(di + 1) * 4])


def test_constrain_redistributes_a_dtensor(ranks):
    full = np.arange(64, dtype=np.float32).reshape(8, 8)
    for out in ranks:
        placed, local, plain_same, unset_same, desc = out["constrain"]
        di, mi = out["coord"]
        assert placed and plain_same and unset_same
        assert np.array_equal(local, full[di * 4:(di + 1) * 4,
                                          mi * 4:(mi + 1) * 4])
        assert desc == "data=2xmodel=2"


def test_production_mesh_refuses_a_world_of_the_wrong_size(ranks):
    for out in ranks:
        assert out["refusal"] is not None
        assert "256" in out["refusal"] and "has 4" in out["refusal"]


def _failing_rank(rank, n):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank one fails")
    dist.barrier()          # the others wait on rank 1 until they time out


def test_spawn_ranks_reports_a_failing_rank(tmp_path):
    """A rank that raises ends the run with its traceback, and no rank
    outlives it (the others, blocked in a collective, are killed)."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed:.*rank one "
                                           "fails"):
        spawn_ranks(_failing_rank, 3, store_dir=str(tmp_path),
                    backend="gloo", timeout=60)


def test_make_production_mesh_outside_a_world():
    import inspect

    sig = inspect.signature(make_production_mesh)
    assert sig.parameters["device_type"].default == "cuda"
    with pytest.raises(RuntimeError, match="512 ranks; the initialized "
                                           "world has 1"):
        make_production_mesh(multi_pod=True, device_type="cpu")


@pytest.mark.parametrize("axes,shape", [
    (("data", "model"), {"data": 16, "model": 16}),
    (("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}),
])
def test_describe_mesh_matches_reference(axes, shape):
    class FakeMesh:
        axis_names = axes

    FakeMesh.shape = shape
    assert describe_mesh(FakeMesh()) == j_describe_mesh(FakeMesh())


# ------------------------------------------------------------------ step


def _cfg(dtype="bfloat16"):
    return replace(reduce_for_smoke(get_config("h2o-danube-1.8b")),
                   dtype=dtype)


def _batch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def _max_diff(model, want: dict) -> float:
    return max(float(np.abs(p.detach().float().numpy() - want[n]).max())
               for n, p in model.named_parameters())


def test_dp_compressed_sync_bitwise_on_reference_grads(ref):
    """The sync of ``dp_compressed_step_fn`` (the pod-shared scale, the
    int8 stack summed as int32, the new errors) on the reference's own
    per-pod gradients and carried errors, against the reference's sync run
    op by op."""
    cfg = _cfg()
    pg, e0, synced, new_e = ref["sync"]
    grads = interop.ef_errors_from(cfg, pg, device=CPU)
    errors = interop.ef_errors_from(cfg, e0, device=CPU)
    want_s = interop.lm_state_from(cfg, synced)
    want_e = interop.ef_errors_from(cfg, new_e, device=CPU)
    assert grads.keys() == want_s.keys() == want_e.keys()
    for n, g in grads.items():
        errors[n].add_(g.bfloat16())         # bf16 gradients, as the step's
    leaves = C.stacked_leaves(LM(cfg, device="meta"))
    assert sorted(n for leaf in leaves for n in leaf) == sorted(grads)
    assert len(leaves) == len(jax.tree.leaves(synced))
    for leaf in leaves:
        s = C.int8_scale(*(errors[n] for n in leaf))
        for n in leaf:
            got, q, summed = C.sync_pods_(errors[n], s, 2)
            assert q.dtype == torch.int8 and summed.dtype == torch.int32
            assert got.numpy().tobytes() == want_s[n].tobytes(), n
            assert errors[n].numpy().tobytes() == \
                want_e[n].numpy().tobytes(), n


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def port_steps(ref, request):
    """The port's compressed step twice from the reference's start, and
    its uncompressed step once, on the CPU."""
    dtype = request.param
    cfg = _cfg(dtype)
    opt = AdamW(lr=LR)
    start = ref["step"][dtype]["params0"]
    model = interop.lm_params_from(cfg, start, device=CPU)
    state = opt.init(dict(model.named_parameters()))
    step, init_errors = C.dp_compressed_step_fn(opt, n_pods=2)
    errors = init_errors(model)
    b1, b2 = (_batch(b) for b in ref["batches"])
    l1 = float(step(model, state, errors, b1))
    p1 = {n: p.detach().clone() for n, p in model.named_parameters()}
    e1 = {n: e.clone() for n, e in errors.items()}
    l2 = float(step(model, state, errors, b2))
    plain = interop.lm_params_from(cfg, start, device=CPU)
    pstate = opt.init(dict(plain.named_parameters()))
    train_step_fn(opt)(plain, pstate, b1)
    return {"dtype": dtype, "l1": l1, "p1": p1, "e1": e1, "l2": l2,
            "model": model, "plain": plain, "step": step}


def test_dp_compressed_step_matches_reference(ref, port_steps):
    dtype = port_steps["dtype"]
    cfg = _cfg(dtype)
    l1, p1, o1, e1 = ref["step"][dtype]["step1"]
    l2, p2 = ref["step"][dtype]["step2"]
    rtol = RTOL_LOSS if dtype == "float32" else RTOL_LOSS_BF16
    assert abs(port_steps["l1"] - l1) <= rtol * abs(l1)
    assert abs(port_steps["l2"] - l2) <= rtol * abs(l2)
    want1 = interop.lm_state_from(cfg, p1)
    d1 = max(float(np.abs(p.float().numpy() - want1[n]).max())
             for n, p in port_steps["p1"].items())
    assert d1 <= PARAM_BOUND, d1
    d2 = _max_diff(port_steps["model"], interop.lm_state_from(cfg, p2))
    assert d2 <= PARAM_BOUND, d2
    # the errors carried into step 2 (and so the step-2 gradients' state)
    want_e = interop.ef_errors_from(cfg, e1, device=CPU)
    assert want_e.keys() == port_steps["e1"].keys()
    for n, e in port_steps["e1"].items():
        assert e.shape == want_e[n].shape


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dp_compressed_second_step_from_reference_state(ref, dtype):
    """Step 2 from the reference's parameters, AdamW state and error
    feedback after step 1 (``lm_params_from``, ``adamw_state_from``,
    ``ef_errors_from``)."""
    cfg = _cfg(dtype)
    _, p1, o1, e1 = ref["step"][dtype]["step1"]
    l2, p2 = ref["step"][dtype]["step2"]
    rtol = RTOL_LOSS if dtype == "float32" else RTOL_LOSS_BF16
    opt = AdamW(lr=LR)
    model = interop.lm_params_from(cfg, p1, device=CPU)
    state = interop.adamw_state_from(cfg, o1, device=CPU)
    errors = interop.ef_errors_from(cfg, e1, device=CPU)
    step, _ = C.dp_compressed_step_fn(opt, n_pods=2)
    loss = float(step(model, state, errors, _batch(ref["batches"][1])))
    assert abs(loss - l2) <= rtol * abs(l2)
    d = _max_diff(model, interop.lm_state_from(cfg, p2))
    assert d <= PARAM_BOUND, d
    assert int(state["step"]) == 2


def test_dp_compressed_step_within_envelope_of_plain_step(port_steps):
    want = {n: p.detach().float().numpy()
            for n, p in port_steps["plain"].named_parameters()}
    d = max(float(np.abs(p.float().numpy() - want[n]).max())
            for n, p in port_steps["p1"].items())
    assert 0 < d <= PARAM_BOUND, d


def test_init_errors_are_float32_per_pod():
    model = LM(_cfg(), device=CPU)
    _, init_errors = C.dp_compressed_step_fn(AdamW(), n_pods=3)
    errors = init_errors(model)
    for n, p in model.named_parameters():
        assert errors[n].shape == (3, *p.shape)
        assert errors[n].dtype == torch.float32 and not errors[n].any()


# -------------------------------------------------------------- constrain


def test_constrain_returns_a_plain_tensor_itself():
    x = torch.ones(4, 4)
    assert partitioning.constrain(x, "act") is x
    with partitioning.activation_specs(act=("data", None)):
        assert partitioning.constrain(x, "act") is x
        assert partitioning.constrain(x, "logits") is x


def test_activation_specs_and_unrolled_scans_restore_on_exit():
    partitioning.set_specs(act=("data",))
    try:
        with partitioning.activation_specs(logits=(None, "model")):
            assert partitioning._SPECS["act"] is None
            assert partitioning._SPECS["logits"] == (None, "model")
        assert partitioning._SPECS["act"] == ("data",)
        assert partitioning._SPECS["logits"] is None
    finally:
        partitioning.set_specs()
    assert not partitioning.scan_unroll()
    with partitioning.unrolled_scans():
        assert partitioning.scan_unroll()
    assert not partitioning.scan_unroll()


def test_lm_logits_bitwise_unchanged_with_specs_set():
    """Every call site's ``constrain`` is a no-op on plain tensors: the
    logits and the loss, chunked attention included (1,024 positions, two
    stacked query chunks), are bitwise those without specs."""
    from repro_torch.models.lm import loss_fn

    cfg = _cfg("float32")
    model = LM(cfg, device=CPU, seed=1)
    rng = np.random.default_rng(2)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab, (1, 1024)))
             for k in ("tokens", "labels")}
    specs = dict(act=(("pod", "data"), "model", None), logits=(None, "model"),
                 attn_q=(None, "model"), attn_kv=(None,), attn_out=(None,),
                 attn_chunk=(None, "model"), attn_chunks=(None, None, "model"))
    with torch.no_grad():
        want, _, _ = model(batch)
        want_loss = loss_fn(model, batch)
        with partitioning.activation_specs(**specs):
            got, _, _ = model(batch)
            got_loss = loss_fn(model, batch)
    assert torch.equal(got, want) and torch.equal(got_loss, want_loss)
