"""The harness is driven by data: configurations, mixes and metric readers
are found by the names ``BENCHMARK.json`` gives, so a cell is added with
files and entries alone; and ``BENCHMARK.json`` keeps to its schema:
names, units, bounds, and a file for every name."""

import json
import re
import shutil

import pytest
from conftest import ROOT, cells, tiny_copy

from hbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tiny_copy(tmp_path)
    here = root / "hbench"
    cfg = json.loads((here / "configs" / "smarthome-w1.json").read_text())
    cfg["name"] = "smarthome-few"
    cfg["queries"] = cfg["queries"][:3]
    (here / "configs" / "smarthome-few.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "smarthome-w1.replay.json")
                     .read_text())
    mix["districts"] = 3
    (here / "traffic" / "smarthome-few.replay.json").write_text(
        json.dumps(mix))
    (here / "metrics" / "segments_done.py").write_text(
        "def read(rec):\n    return float(rec['segments'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "smarthome-few.replay",
                               "config": "smarthome-few",
                               "traffic": "smarthome-few.replay",
                               "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append({"name": "segments_done", "unit": "1",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["smarthome-few.replay"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.load_cell("smarthome-few.replay", root)
    assert spec["cfg"]["name"] == "smarthome-few"
    assert spec["mix"]["districts"] == 3
    # a metric that lists its cells is read only there
    assert [m["name"] for m in spec["end_to_end"]] == \
        ["setup_s", "segments_done"]
    out = run.run_cell("smarthome-few.replay", 4, 1.0, False,
                       backend="torch", device="cpu", root=root)
    assert out["correct"] and out["attempted"] > 0
    assert out["metrics"]["segments_done"]["value"] >= 1
    assert set(out["metrics"]) == {"setup_s", "segments_done"}


def test_missing_cell_is_refused(tmp_path):
    root = tiny_copy(tmp_path)
    with pytest.raises(SystemExit):
        run.load_cell("no-such-cell", root)


def test_without_the_program_the_run_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "hbench", tmp_path / "hbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    import subprocess
    import sys

    r = subprocess.run([sys.executable, "hbench/run.py", "--workload",
                        cells()[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_json_shapes():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    cfgs = {c["name"] for c in bench["configs"]}
    names = set()
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in cfgs
        assert (ROOT / "hbench" / "traffic" / f"{w['traffic']}.json") \
            .is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert (ROOT / "hbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for w in bench["workloads"]:
        mine = [m for m in bench["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in bench["per_layer"])
