"""One cell of the port's benchmark, run once.

    python3 hbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; it names a
configuration (``hbench/configs/<config>.json``) and a traffic mix
(``hbench/traffic/<traffic>.json``), and every metric of the cell has a
reader ``hbench/metrics/<metric>.py``.  The run builds its stream from the
seed, warms up (counted in ``setup_s``), measures for ``--seconds``, checks
every window result the timed path emitted against the plain NumPy
reference of the configuration's pattern, and prints one JSON line last on
standard output: the ``end_to_end`` metrics with ``--trace 0``, the
``per_layer`` ones with ``--trace 1`` (under ``torch.profiler``).  The
numbers compared, each beside its limit, close standard error and the
JSON line.  It runs the port (``src/repro_torch``) on ``cuda:0`` and
exits non-zero, printing no result, without a card.

The process is one load generator and one system under test with one
thread of numerical work: OpenBLAS, OpenMP and MKL are held to a single
thread before NumPy and PyTorch load, as a deployment that runs one such
process a core would, and so that runs spread less.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from hbench import check, drivers  # noqa: E402

# top-level module names the benchmark must never load: JAX and the JAX
# package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Context:
    """What a driver is given: the cell's configuration and mix, the run's
    arguments, the device, and the call that marks the window's start."""

    def __init__(self, cfg, mix, seed, seconds, trace, backend, device,
                 t_start):
        self.cfg, self.mix = cfg, mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.backend, self.device = backend, device
        self._t_start = t_start
        self.setup_s = None

    def window_opens(self) -> None:
        self.setup_s = time.perf_counter() - self._t_start


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, mix and metric specs, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{sorted(cells)}")
    cell = cells[name]
    here = root / "hbench"
    cfg = json.loads((here / "configs" / f"{cell['config']}.json")
                     .read_text())
    mix = json.loads((here / "traffic" / f"{cell['traffic']}.json")
                     .read_text())

    def mine(specs):
        return [m for m in specs if name in m.get("workloads", [name])]

    return {"cell": cell, "cfg": cfg, "mix": mix,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def reader(metric: str, root: Path = ROOT):
    """The ``read(record)`` function of ``hbench/metrics/<metric>.py``."""
    path = root / "hbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"hbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def verify(cfg: dict, limits: dict, run) -> tuple[dict, int, int]:
    """Every window the timed path owes against the reference, computed in
    the configuration's precision: the numbers compared (each with its
    limit), the windows attempted and failed."""
    ref = importlib.import_module(f"hbench.references.{cfg['pattern']}")
    by_tag: dict = {}
    for (q, g, w0, tag), v in run.got.items():
        by_tag.setdefault(tag, {})[(q, g, w0)] = v
    worst = {"max_rel_gap": 0.0, "missing_windows": 0, "extra_windows": 0}
    attempted = failed = 0
    for e in run.expected:
        s = e.stream
        want = ref.evaluate(cfg, s.type_id, s.time, s.attrs, s.group,
                            e.starts, e.groups,
                            dtype=np.dtype(cfg["precision"]))
        if e.keep is not None:
            want = {k: v for k, v in want.items() if k in e.keep}
        c = check.compare(by_tag.get(e.tag, {}), want,
                          limits["max_rel_gap"])
        worst["max_rel_gap"] = max(worst["max_rel_gap"], c["max_rel_gap"])
        worst["missing_windows"] += c["missing_windows"]
        worst["extra_windows"] += c["extra_windows"]
        attempted += len(want)
        failed += c["missing_windows"] + c["extra_windows"] + c["over_limit"]
    if "lost_events" in run.record:
        worst["lost_events"] = run.record["lost_events"]
        failed += run.record["lost_events"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}
    return checks, attempted, failed


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             backend: str = "cuda", device: str = "cuda:0",
             root: Path = ROOT, t_start: float = T_START) -> dict:
    """One run of cell ``name``; returns the result line's object."""
    spec = load_cell(name, root)
    cfg, mix = spec["cfg"], spec["mix"]
    ctx = Context(cfg, mix, seed, seconds, trace, backend, device, t_start)
    run = drivers.DRIVERS[mix["driver"]](ctx)
    rec = run.record
    rec["setup_s"] = ctx.setup_s
    if "segment_s" in rec:
        # the window's steadiness: each segment's rate, generation included
        print("hbench: events/s by segment " + " ".join(
            f"{e / s:.1f}" for e, s in zip(rec["segment_events"],
                                           rec["segment_s"])),
              file=sys.stderr)
    on_card = str(device).startswith("cuda")
    if on_card:
        import torch

        peak = torch.cuda.max_memory_allocated(device)
    # the program's state, unreferenced since the driver returned, goes
    # before the reference runs
    gc.collect()
    checks, attempted, failed = verify(cfg, mix["limits"], run)
    correct = attempted > 0 and all(c["value"] <= c["limit"]
                                    for c in checks.values())
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        v = reader(m["name"], root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics}
    if on_card:
        import torch

        out["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": spec["cell"]["chips"], "memory_peak_bytes": peak,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "power_limit": _power_limit()}
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                         "memory_peak_bytes": 0}
    dev = rec.get("device")
    if trace and dev:
        out["device"]["busy_s"] = dev["busy_s"]
        out["device"]["window_s"] = dev["window_s"]
        out["breakdown"] = {
            "device_ops": _top(dev["device_ops"]),
            "idle_gaps": _top(dev["idle_gaps"])}
    out["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _num(v):
    """A number for the JSON line: a non-finite one as its name."""
    return v if isinstance(v, int) or math.isfinite(v) else str(v)


def _power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=20)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("hbench: the system under test (src/repro_torch) is not in "
              "this checkout", file=sys.stderr)
        return 2
    chips = load_cell(args.workload)["cell"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"hbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    d = out["device"]
    print(f"hbench: {args.workload} seed {args.seed} on {d['kind']} "
          f"({d['power_limit']}), torch {d['torch']}, CUDA {d['cuda']}; "
          f"attempted {out['attempted']}, failed {out['failed']}",
          file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
