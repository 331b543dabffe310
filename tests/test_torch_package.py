"""Package boundary of the PyTorch/CUDA port.

* every ``repro_torch`` module imports without JAX and without the JAX
  package (checked in a fresh interpreter, where nothing else has imported
  them), the LM substrate (configs, models, token engine, serve launcher)
  included;
* without a CUDA device the default entry points raise instead of
  running on the CPU, and ``chip_smoke.py`` exits non-zero, printing no
  result — in the checkout and alone in a directory;
* the service CLI's default, ``--overload``, ``--shards`` and ``--serve``
  modes run on a backend the caller asks for (the last two with the
  reference CLI's windows), and ``--trace`` writes a Chrome-trace JSONL
  beside its report.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _run(args, cwd=ROOT, env_extra=None, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_imports_neither_jax_nor_repro():
    code = """
import pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    __import__(n)
import repro_torch.launch.hamlet_service
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
assert "repro_torch.core.engine" in names and "repro_torch.interop" in names
for n in ("repro_torch.core.baselines.greta", "repro_torch.core.minmax",
          "repro_torch.obs.facade", "repro_torch.obs.audit",
          "repro_torch.streams.partition", "repro_torch.launch.fig9",
          "repro_torch.core.service", "repro_torch.overload.runtime",
          "repro_torch.eventtime.revision"):
    assert n in names, n
for pkg, mods in (("overload", ("config", "controller", "ingress", "shedding",
                                "accountant", "runtime")),
                  ("eventtime", ("config", "watermark", "reorder",
                                 "frontier", "revision")),
                  ("shardsvc", ("placement", "coordinator", "admission",
                                "service", "procdrive")),
                  ("serve", ("session", "scheduler", "frontend",
                             "transport")),
                  ("distributed", ("sharding",)),
                  ("launch", ("fig_shard_scale", "serve")),
                  ("configs", ("base", "gemma2_2b", "gemma3_4b",
                               "h2o_danube_1p8b", "starcoder2_15b",
                               "olmoe_1b_7b", "llama4_maverick",
                               "qwen2_vl_7b", "whisper_tiny", "zamba2_7b",
                               "rwkv6_7b")),
                  ("models", ("layers", "moe", "mamba2", "rwkv6", "lm")),
                  ("serve", ("engine",)),
                  ("train", ("data", "optimizer", "trainer")),
                  ("distributed", ("checkpoint",)),
                  ("launch", ("train",)),
                  ("distributed", ("compression", "pipeline", "comm",
                                   "ranks")),
                  ("models", ("partitioning",)),
                  ("launch", ("mesh",)),
                  ("launch", ("dryrun", "hlo_analysis"))):
    for m in mods:
        assert f"repro_torch.{pkg}.{m}" in names, (pkg, m)
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    n = int(r.stdout.split()[0])
    assert n >= 94, r.stdout


def test_streaming_layers_import_without_jax_or_repro():
    """The service, overload, event-time, sharded-service and serving
    layers import in an interpreter where ``jax`` and ``repro`` cannot be
    imported at all."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "repro", "benchmarks"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import repro_torch.core.service, repro_torch.overload, repro_torch.eventtime
import repro_torch.shardsvc, repro_torch.serve
from repro_torch.core.service import HamletService
from repro_torch.overload import OverloadRuntime
from repro_torch.eventtime import EventTimeRuntime
from repro_torch.shardsvc import ShardedHamletService, ProcShardWorker
from repro_torch.serve import ServingFrontend, ServingServer, ServingClient
from repro_torch.launch import fig_shard_scale
print("ok")
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_lowering_proofs_import_without_jax_or_repro():
    """The lowering proofs (``launch.dryrun``, ``launch.hlo_analysis``,
    ``configs.input_specs``) import in an interpreter where ``jax`` and
    ``repro`` cannot be imported, and importing them initializes no process
    group (the dry run opens its placeholder world itself)."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import torch.distributed as dist
from repro_torch.configs import input_specs, get_config
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.hlo_analysis import CollectiveCounter, HloReport
assert not dist.is_initialized()
specs = input_specs(get_config("gemma2-2b"), "train_4k")
assert {k: tuple(v.shape) for k, v in specs.items()} == {
    "tokens": (256, 4096), "labels": (256, 4096)}
print("ok", dryrun.ARTIFACT_DIR.name)
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok dryrun"


def test_lm_substrate_imports_without_jax_or_repro():
    """The configs, models, token serving engine and serve launcher import
    in an interpreter where ``jax`` and ``repro`` cannot be imported, and
    the launcher runs a smoke model there on the CPU."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
from repro_torch.models import LM, init_cache, prefill_fn, decode_fn
from repro_torch.serve import ServeEngine, Request
from repro_torch.interop import lm_params_from
from repro_torch.launch import serve
assert len(ARCHS) == 10 and all(get_config(a).name for a in ARCHS)
res = serve.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
                  "--batch", "1", "--prompt-len", "8", "--gen", "2"])
assert res["finite"]
print("ok")
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"


def test_training_imports_without_jax_repro_or_ml_dtypes():
    """The training path (``models.lm``'s loss and step, ``train``,
    ``distributed.checkpoint``, ``launch.train``) imports in an interpreter
    where ``jax``, ``repro`` and ``ml_dtypes`` cannot be imported, and
    trains, checkpoints (a bfloat16 model) and resumes there on the CPU."""
    code = """
import sys, tempfile
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks",
                                  "ml_dtypes"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
from repro_torch.models.lm import loss_fn, train_step_fn
from repro_torch.train import AdamW
from repro_torch.train.trainer import run_training, TrainLoopConfig
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.interop import adamw_state_from
from repro_torch.launch import train
d = tempfile.mkdtemp()
argv = ["--smoke", "--device", "cpu", "--batch", "1", "--seq", "8",
        "--ckpt", d, "--ckpt-interval", "1"]
first = train.main(argv + ["--steps", "2"])
again = train.main(argv + ["--steps", "3"])
assert first["resumed_from"] == 0 and again["resumed_from"] == 2
print("ok")
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"


def test_distributed_substrate_imports_without_jax_or_repro():
    """The compression, pipeline, mesh rules, partitioning hooks and mesh
    import in an interpreter where ``jax`` and ``repro`` cannot be
    imported; ``make_production_mesh`` builds on ``"cuda"`` unless asked
    for the CPU, and without a GPU it raises instead."""
    code = """
import inspect, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import torch
from repro_torch.distributed import (compressed_psum_tree,
    dp_compressed_step_fn, ef_compress_tree, param_pspecs, pipelined_apply,
    shard_pane_bucket, shardings_for)
from repro_torch.distributed.ranks import spawn_ranks
from repro_torch.models.partitioning import activation_specs, constrain
from repro_torch.interop import ef_errors_from
from repro_torch.launch.mesh import describe_mesh, make_production_mesh
assert inspect.signature(make_production_mesh).parameters[
    "device_type"].default == "cuda"
if not torch.cuda.is_available():
    try:
        make_production_mesh()
        raise SystemExit("no refusal")
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
print("ok")
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.parametrize("entry", ["HamletService", "OverloadRuntime",
                                   "EventTimeRuntime"])
def test_streaming_entry_points_default_to_the_card(entry):
    """Each new entry point runs the hand-written kernels on ``cuda:0``
    unless told otherwise: without a GPU it raises instead of falling back
    to the CPU, and it runs on the host only when asked."""
    _no_cuda()
    import inspect

    from repro_torch.core.pattern import EventType, Kleene, Seq
    from repro_torch.core.query import Query, Workload
    from repro_torch.core.service import HamletService
    from repro_torch.eventtime import EventTimeConfig, EventTimeRuntime
    from repro_torch.overload import OverloadConfig, OverloadRuntime
    from repro_torch.streams.generator import RIDESHARING_SCHEMA

    q = Query("q", Seq(EventType("Request"), Kleene(EventType("Travel"))))
    wl = Workload(RIDESHARING_SCHEMA, [q])
    cls, make = {
        "HamletService": (HamletService, lambda **kw: HamletService(
            RIDESHARING_SCHEMA, [q], **kw)),
        "OverloadRuntime": (OverloadRuntime, lambda **kw: OverloadRuntime(
            wl, OverloadConfig(), **kw)),
        "EventTimeRuntime": (EventTimeRuntime, lambda **kw: EventTimeRuntime(
            wl, EventTimeConfig(), **kw)),
    }[entry]
    assert inspect.signature(cls).parameters["backend"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(backend="torch")
    with pytest.raises(ValueError):
        make(backend="cuda", device="cpu")
    on_host = make(backend="torch", device="cpu")
    rt = on_host._runtime() if entry == "HamletService" else on_host.rt
    assert rt.device.type == "cpu" and rt.backend == "torch"
    on_np = make(backend="np")
    assert (on_np if entry == "HamletService" else on_np.rt).device is None


@pytest.mark.parametrize("entry", ["ShardedHamletService", "ShardWorker",
                                   "ServingFrontend"])
def test_sharded_and_serving_entry_points_default_to_the_card(entry):
    """The sharded service, its workers and the serving front-end run the
    hand-written kernels on ``cuda:0`` unless told otherwise: without a GPU
    they raise, and they run on the host only when asked."""
    _no_cuda()
    import inspect

    from repro_torch.core.pattern import EventType, Kleene, Seq
    from repro_torch.core.query import Query, Workload
    from repro_torch.overload import OverloadConfig
    from repro_torch.serve import ServingFrontend
    from repro_torch.shardsvc import (ShardedHamletService,
                                      ShardServiceConfig, ShardWorker)
    from repro_torch.streams.generator import RIDESHARING_SCHEMA

    q = Query("q", Seq(EventType("Request"), Kleene(EventType("Travel"))))
    wl = Workload(RIDESHARING_SCHEMA, [q])
    key = "np_backend" if entry == "ServingFrontend" else "backend"
    cls, make, runtime = {
        "ShardedHamletService": (
            ShardedHamletService,
            lambda **kw: ShardedHamletService(wl, ShardServiceConfig(), **kw),
            lambda o: o.workers[-1].rt.rt),
        "ShardWorker": (
            ShardWorker,
            lambda **kw: ShardWorker(0, wl, OverloadConfig(), **kw),
            lambda o: o.rt.rt),
        "ServingFrontend": (
            ServingFrontend,
            lambda **kw: ServingFrontend(wl, **{
                ("np_backend" if k == "backend" else k): v
                for k, v in kw.items()}),
            lambda o: o._backend.rt.rt),
    }[entry]
    assert inspect.signature(cls).parameters[key].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(backend="torch")
    with pytest.raises(ValueError):
        make(backend="cuda", device="cpu")
    rt = runtime(make(backend="torch", device="cpu"))
    assert rt.device.type == "cpu" and rt.backend == "torch"
    assert runtime(make(backend="np")).device is None


def test_default_runtime_needs_a_gpu():
    _no_cuda()
    from repro_torch.core.engine import HamletRuntime
    from repro_torch.core.pattern import EventType, Kleene, Seq
    from repro_torch.core.query import Query, Workload
    from repro_torch.streams.generator import RIDESHARING_SCHEMA

    wl = Workload(RIDESHARING_SCHEMA, [
        Query("q", Seq(EventType("Request"), Kleene(EventType("Travel"))))])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HamletRuntime(wl)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HamletRuntime(wl, backend="torch")
    with pytest.raises(ValueError):
        HamletRuntime(wl, backend="cuda", device="cpu")
    assert HamletRuntime(wl, backend="torch", device="cpu").device.type == \
        "cpu"
    assert HamletRuntime(wl, backend="np").device is None


@pytest.mark.parametrize("entry", ["PaneBatchExecutor", "FoldExecutor",
                                   "PaneProcessor"])
def test_default_executors_need_a_gpu(entry):
    _no_cuda()
    from repro_torch.core.batch_exec import PaneBatchExecutor
    from repro_torch.core.engine import ComponentContext, PaneProcessor
    from repro_torch.core.fold_exec import FoldExecutor
    from repro_torch.core.optimizer import DynamicPolicy
    from repro_torch.core.pattern import EventType, Kleene, Seq
    from repro_torch.core.query import Query, Workload
    from repro_torch.streams.generator import RIDESHARING_SCHEMA

    if entry == "PaneProcessor":
        wl = Workload(RIDESHARING_SCHEMA, [
            Query("q", Seq(EventType("Request"),
                           Kleene(EventType("Travel"))))])
        ctx = ComponentContext(wl.schema, list(wl.atomic))
        make = lambda **kw: PaneProcessor(ctx, DynamicPolicy(), **kw)
    else:
        make = {"PaneBatchExecutor": PaneBatchExecutor,
                "FoldExecutor": FoldExecutor}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    made = make(backend="torch", device="cpu")
    assert getattr(made, "executor", made).device.type == "cpu"
    assert make(backend="np").backend == "np"


def _assert_refused(r):
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert not any(ln.startswith("{") for ln in r.stdout.splitlines())


def test_chip_smoke_fails_without_gpu():
    _no_cuda()
    r = _run([str(ROOT / "chip_smoke.py")])
    _assert_refused(r)
    assert "no CUDA device" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    _assert_refused(r)


def test_cli_default_mode_on_the_host():
    r = _run(["-m", "repro_torch.launch.hamlet_service", "--backend", "np",
              "--minutes", "1", "--events-per-minute", "200"])
    assert r.returncode == 0, r.stderr
    assert "backend=np" in r.stdout and "windows=" in r.stdout


def test_cli_refuses_unported_modes_and_missing_gpu():
    """Every mode of the JAX package's launcher is ported now (none is
    refused as unported), and each mode that runs an engine refuses to
    start on the default ``cuda`` backend without a GPU."""
    from repro_torch.launch import hamlet_service

    assert not hasattr(hamlet_service, "UNPORTED")
    args = hamlet_service.parse_args(
        ["--serve", "--shards", "2", "--listen", "127.0.0.1:0", "--connect",
         "127.0.0.1:1", "--session-index", "3", "--credit-window", "64"])
    assert (args.serve, args.shards, args.listen, args.connect,
            args.session_index, args.credit_window) == (
        True, 2, "127.0.0.1:0", "127.0.0.1:1", 3, 64)
    if not torch.cuda.is_available():
        for flags in ([], ["--overload"], ["--shards", "2"], ["--serve"],
                      ["--listen", "127.0.0.1:0"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                hamlet_service.main(flags + ["--minutes", "1"])


def _reference_cli_windows(mode, args, monkeypatch):
    """The windows the JAX package's launcher computes in ``--shards`` or
    ``--serve`` mode for the same parsed arguments (its functions print and
    return nothing, so the service or front-end they build is captured)."""
    import repro.serve as ref_serve
    import repro.shardsvc as ref_shardsvc
    from repro.launch import hamlet_service as ref_cli

    made = []
    mod, name, run = {
        "shards": (ref_shardsvc, "ShardedHamletService", ref_cli.run_sharded),
        "serve": (ref_serve, "ServingFrontend", ref_cli.run_serving)}[mode]
    base = getattr(mod, name)

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(mod, name, Recorded)
    run(args)
    assert len(made) == 1
    return made[0].results()


@pytest.mark.parametrize("mode,flags", [
    ("shards", ["--shards", "2", "--tenants", "2"]),
    ("serve", ["--serve", "--sessions", "4", "--tenants", "2",
               "--shed-policy", "none"]),
])
def test_cli_shards_and_serve_on_the_host(mode, flags, capsys, monkeypatch):
    """``--shards 2`` and ``--serve --sessions 4`` on ``--backend np``: the
    port's windows equal the reference CLI's bitwise, and the report names
    the backend.  (``--serve`` runs unshed here: its default shedding
    follows a PID controller on the host's clock.)"""
    from repro_torch.core.engine import vals_equal
    from repro_torch.launch import hamlet_service

    argv = flags + ["--backend", "np", "--minutes", "1"]
    got = hamlet_service.main(argv)
    out = capsys.readouterr().out
    assert "backend=np" in out and f"windows={len(got)}" in out
    want = _reference_cli_windows(mode, hamlet_service.parse_args(argv),
                                  monkeypatch)
    assert got and got.keys() == want.keys()
    assert all(vals_equal(got[k], want[k]) for k in want)


def test_cli_listen_and_connect_on_the_host():
    """``--listen`` and two ``--connect`` clients in three processes over
    loopback on ``--backend np``: every session closes, the server drains,
    and each client's END frame holds its tenant's windows."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    common = ["-m", "repro_torch.launch.hamlet_service", "--sessions", "2",
              "--tenants", "2", "--minutes", "1"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    clients = []
    srv = subprocess.Popen(
        [sys.executable, *common, "--listen", f"127.0.0.1:{port}",
         "--backend", "np"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        assert "listening on" in srv.stdout.readline()
        clients = [subprocess.Popen(
            [sys.executable, *common, "--connect", f"127.0.0.1:{port}",
             "--session-index", str(i)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(2)]
        outs = [c.communicate(timeout=120) for c in clients]
        out, err = srv.communicate(timeout=120)
    finally:
        for proc in (srv, *clients):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert srv.returncode == 0, err
    assert "serve: sessions=2 backend=np" in out and "windows=" in out
    for c, (c_out, c_err) in zip(clients, outs):
        assert c.returncode == 0, c_err
        assert c_out.startswith("session ") and "windows=" in c_out
        assert "windows=0 " not in c_out


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_cli_overload_on_the_host(backend, capsys):
    """``--overload`` at a tiny size: calibration, the shed run and the
    recall all on the backend asked for; the report's lines and the
    returned summary."""
    from repro_torch.launch import hamlet_service

    flags = ["--overload", "--backend", backend, "--minutes", "1",
             "--events-per-minute", "200", "--groups", "2", "--recall",
             "--shed-policy", "drop_tail", "--offered-x", "3"]
    if backend == "torch":
        flags += ["--device", "cpu"]
    s = hamlet_service.main(flags)
    out = capsys.readouterr().out
    assert f"backend={backend}" in out and "policy=drop_tail" in out
    assert "pane proc p50=" in out and "detection recall=" in out
    assert s["panes"] == 12 and s["offered"] == s["admitted"] + s["shed"]
    assert 0.0 <= s["recall"] <= 1.0 and s["capacity"] > 0


def test_cli_trace_on_the_host(tmp_path):
    """``--trace`` exports the pane spans as Chrome-trace JSONL and prints
    the span-sum check per phase and the audit summary."""
    path = tmp_path / "trace.jsonl"
    r = _run(["-m", "repro_torch.launch.hamlet_service", "--backend", "np",
              "--minutes", "1", "--events-per-minute", "200", "--trace",
              str(path), "--trace-sample", "2"])
    assert r.returncode == 0, r.stderr
    evs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert evs and all({"ph", "name", "cat", "ts"} <= e.keys() for e in evs)
    assert {e["name"] for e in evs if e.get("cat") == "phase"} >= {
        "plan", "execute", "finalize", "fold"}
    out = r.stdout
    assert f"trace: {len(evs)} events -> {path}" in out
    assert "sample=2" in out and "python -m repro_torch.obs.trace" in out
    for ph in ("plan", "execute", "finalize", "fold"):
        assert f"  {ph}" in out
    assert "audit: " in out and "decisions" in out
    assert "backend=np" in out


def test_build_needs_nvcc(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("the toolkit is installed at its default location")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_interop_round_trip():
    from repro_torch import interop
    from repro_torch.launch.hamlet_service import ridesharing_workload
    from repro_torch.streams.generator import ridesharing_stream

    wl = ridesharing_workload(5)
    spec = interop.workload_spec(wl)
    assert json.loads(json.dumps(spec)) is not None     # plain values only
    again = interop.workload_from(spec)
    assert [q.name for q in again.atomic] == [q.name for q in wl.atomic]
    assert again.atomic == wl.atomic
    s = ridesharing_stream(events_per_minute=100, minutes=1)
    c = interop.stream_columns(s)
    t = interop.batch_from(interop.schema_from(c["types"], c["attr_names"]),
                           c["type_id"], c["time"], c["attrs"], c["group"])
    assert t.schema == s.schema and (t.attrs == s.attrs).all()
    assert t.attrs is not s.attrs


def test_bound_takes_the_larger_time():
    from repro_torch.kernels.hamlet_propagate import masked_propagate_work
    from repro_torch.kernels.timing import bound

    assert bound(3.35e9, 1.0, "float64") == (1.0, "bytes")
    assert bound(1.0, 67e9, "int32") == (1.0, "operations")
    ms, by = bound(*masked_propagate_work(78, 313, 2), "float64")
    assert by == "bytes" and abs(ms - 31249920 / 3.35e12 * 1e3) < 1e-15


def test_masked_ab_parses_shapes_and_needs_a_gpu():
    _no_cuda()
    from repro_torch.kernels import masked_ab

    args = masked_ab.parse_args(["--other", "x.cu", "--shape", "78,313,2",
                                 "--shape", "1,1100,2"])
    assert args.shape == [(78, 313, 2), (1, 1100, 2)]
    assert args.other == Path("x.cu")
    assert masked_ab.main(["--other", "x.cu", "--shape", "2,3,1"]) == 1


def test_build_from_needs_nvcc(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("the toolkit is installed at its default location")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_from(_build.CSRC, tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_masked_ab_parses_the_dense_kernel():
    """``--kernel dense`` picks the dense kernel's source, inputs, plain
    version and work; ``--kernel`` defaults to the masked kernel and takes
    no other name."""
    _no_cuda()
    from repro_torch.kernels import masked_ab
    from repro_torch.kernels.hamlet_dense import dense_propagate_work

    args = masked_ab.parse_args(["--kernel", "dense", "--other", "x.cu",
                                 "--shape", "485,512,2", "--shape",
                                 "2,64,1"])
    assert args.kernel == "dense"
    assert args.shape == [(485, 512, 2), (2, 64, 1)]
    kern = masked_ab.KERNELS[args.kernel]
    assert kern.source == "hamlet_dense.cu"
    assert kern.work is dense_propagate_work
    assert masked_ab.parse_args(["--other", "x.cu", "--shape",
                                 "1,2,3"]).kernel == "masked"
    with pytest.raises(SystemExit):
        masked_ab.parse_args(["--kernel", "fold", "--other", "x.cu",
                              "--shape", "1,2,3"])
    # the inputs the tool checks and times at a shape, on the CPU here
    import numpy as np

    rng = np.random.default_rng(0)
    (base,) = kern.inputs(rng, 2, 64, 1, torch.device("cpu"))
    assert base.shape == (2, 64, 1) and base.dtype == torch.float64
    assert kern.plain(base).shape == base.shape
    assert masked_ab.main(["--kernel", "dense", "--other", "x.cu",
                           "--shape", "2,3,1"]) == 1
    log = ("== hamlet_propagate.cu\nptxas info : Used 200 registers\n"
           "== hamlet_dense.cu\nptxas info : Compiling entry function "
           "'k' for 'sm_90a'\nptxas info : Used 40 registers\n"
           "    0 bytes stack frame, 0 bytes spill stores\n")
    assert masked_ab._ptxas_lines(log, "hamlet_dense.cu") == [
        "ptxas info : Compiling entry function 'k' for 'sm_90a'",
        "ptxas info : Used 40 registers",
        "0 bytes stack frame, 0 bytes spill stores"]
