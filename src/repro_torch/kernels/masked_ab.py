"""Time the masked propagation kernel against another version of its source,
in turns, on one card.

    python -m repro_torch.kernels.masked_ab --other DIR/hamlet_propagate.cu \\
        --shape 78,313,2 --shape 1,1100,2

Builds the package's kernels (``_build.load``) and a second library from a
copy of ``csrc/`` whose ``hamlet_propagate.cu`` is ``--other`` (into
``build/masked_ab/``), checks both against the plain version on random 0/1
f64 inputs at every shape, and times them in turns (other, this, this,
other; CUDA events over 30 launches queued behind a spin kernel, the median
of 5 batches each).  Prints the card's ``name, power.limit``, one line per
shape, and a JSON record as the last line.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import _build, ref
from .hamlet_propagate import masked_propagate_work
from .timing import bound, device_ms

RTOL = 1e-12                # f64, another order of addition than the oracle


def _shape(text: str) -> tuple[int, int, int]:
    nb, b, d = (int(x) for x in text.split(","))
    return nb, b, d


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", type=Path, required=True,
                   help="the other hamlet_propagate.cu")
    p.add_argument("--shape", type=_shape, action="append", required=True,
                   help="nb,b,d (repeatable)")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("masked_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    this = _build.load()
    csrc = _build.BUILD_DIR.parent / "masked_ab" / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for name in _build.SOURCES + _build.HEADERS:
        shutil.copy(_build.CSRC / name, csrc / name)
    shutil.copy(args.other, csrc / "hamlet_propagate.cu")
    other = _build.build_from(csrc, csrc.parent)
    for name, lib in (("this", this), ("other", other)):
        for ln in lib.ptxas_log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln.strip()}", flush=True)

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(args.seed)
    rows = []
    for nb, b, d in args.shape:
        mask = torch.as_tensor(np.tril(rng.random((nb, b, b)) < 0.5, -1),
                               dtype=torch.float64, device=dev)
        base = torch.as_tensor(rng.integers(0, 2, (nb, b, d)),
                               dtype=torch.float64, device=dev)
        want = ref.torch_prefix_propagate_batched(base, mask)
        outs = {}
        for name, lib in (("this", this), ("other", other)):
            out = torch.empty_like(base)
            lib.masked_propagate(base, mask, out)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            same = torch.equal(torch.isfinite(out), fin)
            err = ((out[fin] - want[fin]).abs() / (1 + want[fin].abs())).max()
            if not same or float(err) > RTOL:
                print(f"masked_ab: {name} disagrees with the plain version "
                      f"at {(nb, b, d)}: rel {float(err)}", file=sys.stderr)
                return 1
            outs[name] = out
        t = {"this": [], "other": []}
        for name in ("other", "this", "this", "other"):
            lib, out = (this if name == "this" else other), outs[name]
            t[name].append(device_ms(
                lambda: lib.masked_propagate(base, mask, out)))
        bound_ms, bound_by = bound(*masked_propagate_work(nb, b, d),
                                   "float64")
        row = {"shape": [nb, b, d], "this_ms": t["this"],
               "other_ms": t["other"], "bound_ms": bound_ms,
               "bound_by": bound_by,
               "speedup": min(t["other"]) / min(t["this"])}
        rows.append(row)
        print(f"{(nb, b, d)}: this {t['this']} ms, other {t['other']} ms, "
              f"bound {bound_ms:.7f} ms ({bound_by}), other/this "
              f"{row['speedup']:.3f}", flush=True)
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
