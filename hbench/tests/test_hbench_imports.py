"""No module that ``hbench/run.py`` loads, through a whole run, has the
top-level name of JAX or of the JAX package the port was made from, taken
whole: the port's ``repro_torch`` begins with ``repro`` and is allowed."""

import json
import subprocess
import sys
import textwrap

import pytest
from conftest import ROOT, cells


@pytest.mark.parametrize("cell", cells())
def test_a_run_loads_no_jax_and_no_jax_package(tiny_root, cell):
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT / 'hbench')!r})
        import run
        run.run_cell({cell!r}, 3, 0.5, False, backend="torch",
                     device="cpu", root=__import__("pathlib").Path(
                         {str(tiny_root)!r}))
        tops = sorted({{m.split(".", 1)[0] for m in sys.modules}})
        print(json.dumps({{"tops": tops,
                          "forbidden": run.forbidden_modules()}}))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tiny_root)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["tops"])
    assert "repro_torch" in out["tops"]


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from hbench import run

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert run.forbidden_modules() == ["repro"]
