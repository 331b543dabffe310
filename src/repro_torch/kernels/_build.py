"""Build and load the hand-written CUDA kernels at first use.

The sources in ``csrc/`` are compiled by ``nvcc`` for Hopper
(``-gencode=arch=compute_90a,code=sm_90a``) into one shared library with a
plain C interface (``csrc/hamlet_bindings.cpp``), which is loaded with
``ctypes``.  No source includes PyTorch's headers, so a cold build takes
seconds, not minutes; every source compiles in its own ``nvcc`` process,
all started together, and one more ``nvcc`` links them.

The library lands in ``build/torch_ext/`` at the repository root, under a
name derived from the sources' and flags' digest, so an edited source never
loads a stale build; a finished build is installed by an atomic rename, so
processes building at once never load a half-written file.  Nothing here
runs at import: the first kernel launch calls :func:`load`.

Threads may launch the kernels at once (the sharded service's thread drive,
the serving tier's pump): one lock, :data:`LOCK`, makes a process build and
load the library once, and guards the wrappers' launch counters
(:func:`count_launch`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

__all__ = ["DTYPE_CODES", "KernelLibrary", "LOCK", "build_from",
           "count_launch", "load", "nvcc_path"]

CSRC = Path(__file__).with_name("csrc")
SOURCES = ("hamlet_propagate.cu", "hamlet_dense.cu", "hamlet_bindings.cpp")
HEADERS = ("hamlet_kernels.h",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# shared with csrc/hamlet_kernels.h::HamletDtype
DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.int32: 2}

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's default
    location, or ``nvcc`` on ``PATH``."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


@dataclass
class KernelLibrary:
    """The loaded kernels: typed ctypes entry points plus build facts."""

    lib: ctypes.CDLL
    path: Path
    build_s: float          # 0.0 when an existing build was loaded
    ptxas_log: str          # ``-Xptxas -v`` report of the build ("" if reused)

    def __post_init__(self) -> None:
        self.lib.hamlet_masked_propagate.argtypes = [
            ctypes.c_int, _VP, _VP, _VP, _I64, _I64, _I64, _VP]
        self.lib.hamlet_masked_propagate.restype = ctypes.c_int
        self.lib.hamlet_dense_propagate.argtypes = [
            ctypes.c_int, _VP, _VP, _I64, _I64, _I64, _VP]
        self.lib.hamlet_dense_propagate.restype = ctypes.c_int
        self.lib.hamlet_error_string.argtypes = [ctypes.c_int]
        self.lib.hamlet_error_string.restype = ctypes.c_char_p

    def check(self, code: int, what: str) -> None:
        if code:
            msg = self.lib.hamlet_error_string(code).decode()
            raise RuntimeError(f"{what} launch failed: {msg} (cuda error "
                               f"{code})")

    def masked_propagate(self, base: torch.Tensor, mask: torch.Tensor,
                         out: torch.Tensor) -> None:
        nb, b, d = base.shape
        stream = torch.cuda.current_stream(base.device).cuda_stream
        self.check(self.lib.hamlet_masked_propagate(
            DTYPE_CODES[base.dtype], base.data_ptr(), mask.data_ptr(),
            out.data_ptr(), nb, b, d, stream), "hamlet_propagate")

    def dense_propagate(self, base: torch.Tensor, out: torch.Tensor) -> None:
        nb, b, d = base.shape
        stream = torch.cuda.current_stream(base.device).cuda_stream
        self.check(self.lib.hamlet_dense_propagate(
            DTYPE_CODES[base.dtype], base.data_ptr(), out.data_ptr(),
            nb, b, d, stream), "hamlet_dense")


_LOADED: KernelLibrary | None = None

# guards _LOADED and the wrappers' launch counters
LOCK = threading.Lock()


def count_launch(fn, key) -> None:
    """Count one launch of the kernel behind wrapper ``fn``, of shape key
    ``key``, in ``fn.launches`` and ``fn.shapes`` (under :data:`LOCK`, so
    no increment is lost between threads)."""
    with LOCK:
        fn.launches += 1
        fn.shapes[key] += 1


def _digest(nvcc: str, csrc: Path = CSRC) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def _compile(nvcc: str, build_dir: Path,
             csrc: Path = CSRC) -> tuple[Path, str]:
    """One ``nvcc -c`` per source, all in parallel, then one link."""
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(csrc / name), "-o", str(obj)]
            if name.endswith(".cu"):
                cmd[1:1] = ["-Xptxas", "-v"]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, _obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode:
                failed.append(name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib_tmp = Path(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib_tmp),
             *(str(obj) for _n, obj, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        final = build_dir / f"libhamlet_kernels_{_digest(nvcc, csrc)}.so"
        os.replace(lib_tmp, final)
    return final, log


def load() -> KernelLibrary:
    """Build the kernels if this source state has no build yet, load the
    library once per process, and return it.  Threads that call it at once
    wait on :data:`LOCK` for the one that builds."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    with LOCK:
        if _LOADED is None:
            nvcc = nvcc_path()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            path = BUILD_DIR / f"libhamlet_kernels_{_digest(nvcc)}.so"
            build_s, log = 0.0, ""
            if not path.is_file():
                t0 = time.perf_counter()
                path, log = _compile(nvcc, BUILD_DIR)
                build_s = time.perf_counter() - t0
            _LOADED = KernelLibrary(ctypes.CDLL(str(path)), path, build_s,
                                    log)
    return _LOADED


def build_from(csrc: Path, build_dir: Path) -> KernelLibrary:
    """Build the library from another copy of ``csrc/`` (the same file
    names) into ``build_dir`` and load it beside the package's own; for
    timing two versions of a kernel in one process."""
    nvcc = nvcc_path()
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    path, log = _compile(nvcc, build_dir, csrc)
    return KernelLibrary(ctypes.CDLL(str(path)), path,
                         time.perf_counter() - t0, log)
