"""Shared set-up of the benchmark's CPU tests: the repository's ``src`` and
root on ``sys.path``, and a copy of the benchmark whose mixes are cut to a
size the CPU runs in seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY = {"replay": {"districts": 2, "micro_batch": 8},
        "open": {"districts": 2, "offered_events_per_s": 600}}
# events a district-minute in the tiny copy
TINY_DENSITY = 200


def tiny_copy(dst: Path) -> Path:
    """``dst`` holding ``BENCHMARK.json`` and ``hbench/`` with every mix cut
    to two districts, each at a few hundred events a minute."""
    shutil.copytree(ROOT / "hbench", dst / "hbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for f in (dst / "hbench" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix.update(TINY[mix["driver"]])
        f.write_text(json.dumps(mix))
    for f in (dst / "hbench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["events_per_group_minute"] = TINY_DENSITY
        f.write_text(json.dumps(cfg))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("hbench"))


def cells() -> list:
    return [w["name"] for w in
            json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
