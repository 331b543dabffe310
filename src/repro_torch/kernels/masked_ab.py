"""Time one of the propagation kernels against another version of its
source, in turns, on one card.

    python -m repro_torch.kernels.masked_ab --other DIR/hamlet_propagate.cu \\
        --shape 78,313,2 --shape 1,1100,2
    python -m repro_torch.kernels.masked_ab --kernel dense \\
        --other DIR/hamlet_dense.cu --shape 485,512,2

Builds the package's kernels (``_build.load``) and a second library from a
copy of ``csrc/`` whose source of the chosen kernel (``hamlet_propagate.cu``
for ``--kernel masked``, the default, ``hamlet_dense.cu`` for ``--kernel
dense``) is ``--other`` (into ``build/masked_ab/``), checks both against the
plain version at every shape (f64; random 0/1 masks and injections for the
masked kernel, random non-integer injections in [0, 3) for the dense one),
and times them in turns (other, this, this, other; CUDA events over 30
launches queued behind a spin kernel, the median of 5 batches each).
Prints the card's ``name, power.limit``, the ptxas register report of both
builds, one line per shape, and a JSON record as the last line.  Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from . import _build, ref
from .hamlet_dense import dense_propagate_work
from .hamlet_propagate import masked_propagate_work
from .timing import bound, device_ms

RTOL = 1e-12                # f64, another order of addition than the oracle


@dataclass(frozen=True)
class Kernel:
    """What the tool needs of one kernel: its source's file name, inputs at
    a shape, a launch on a library into ``out``, its plain version and its
    work for the bound."""

    source: str
    inputs: Callable        # (rng, nb, b, d, device) -> tuple of tensors
    launch: Callable        # (lib, inputs, out) -> None
    plain: Callable         # (*inputs) -> tensor
    work: Callable          # (nb, b, d) -> (bytes, operations)


def _masked_inputs(rng, nb, b, d, dev):
    mask = np.tril(rng.random((nb, b, b)) < 0.5, -1)
    base = rng.integers(0, 2, (nb, b, d))
    return tuple(torch.as_tensor(x, dtype=torch.float64, device=dev)
                 for x in (base, mask))


def _dense_inputs(rng, nb, b, d, dev):
    return (torch.as_tensor(rng.random((nb, b, d)) * 3.0,
                            dtype=torch.float64, device=dev),)


KERNELS = {
    "masked": Kernel("hamlet_propagate.cu", _masked_inputs,
                     lambda lib, x, out: lib.masked_propagate(*x, out),
                     ref.torch_prefix_propagate_batched,
                     masked_propagate_work),
    "dense": Kernel("hamlet_dense.cu", _dense_inputs,
                    lambda lib, x, out: lib.dense_propagate(*x, out),
                    ref.prefix_propagate_dense_torch_batched,
                    dense_propagate_work),
}


def _shape(text: str) -> tuple[int, int, int]:
    nb, b, d = (int(x) for x in text.split(","))
    return nb, b, d


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kernel", choices=sorted(KERNELS), default="masked",
                   help="which kernel to time (default: masked)")
    p.add_argument("--other", type=Path, required=True,
                   help="the other version of the kernel's .cu source")
    p.add_argument("--shape", type=_shape, action="append", required=True,
                   help="nb,b,d (repeatable)")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def _ptxas_lines(log: str, source: str) -> list[str]:
    """The entry-function, register and spill lines of one source's section
    of a build log (``_build._compile`` heads each section with
    ``== name``)."""
    lines, inside = [], False
    for ln in log.splitlines():
        if ln.startswith("== "):
            inside = ln[3:].strip() == source
        elif inside and any(k in ln for k in ("entry function", "registers",
                                              "spill")):
            lines.append(ln.strip())
    return lines


def main(argv=None) -> int:
    args = parse_args(argv)
    kern = KERNELS[args.kernel]
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
    shutil.copy(args.other, csrc / kern.source)
    other = _build.build_from(csrc, csrc.parent)
    for name, lib in (("this", this), ("other", other)):
        for ln in _ptxas_lines(lib.ptxas_log, kern.source):
            print(f"ptxas {name}: {ln}", flush=True)

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(args.seed)
    rows = []
    for nb, b, d in args.shape:
        x = kern.inputs(rng, nb, b, d, dev)
        want = kern.plain(*x)
        outs = {}
        for name, lib in (("this", this), ("other", other)):
            out = torch.empty_like(x[0])
            kern.launch(lib, x, out)
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
            t[name].append(device_ms(lambda: kern.launch(lib, x, out)))
        bound_ms, bound_by = bound(*kern.work(nb, b, d), "float64")
        row = {"shape": [nb, b, d], "this_ms": t["this"],
               "other_ms": t["other"], "bound_ms": bound_ms,
               "bound_by": bound_by,
               "speedup": min(t["other"]) / min(t["this"])}
        rows.append(row)
        print(f"{(nb, b, d)}: this {t['this']} ms, other {t['other']} ms, "
              f"bound {bound_ms:.7f} ms ({bound_by}), other/this "
              f"{row['speedup']:.3f}", flush=True)
    print(json.dumps({"card": card, "kernel": args.kernel, "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
