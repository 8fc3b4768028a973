"""Builds the hand-written CUDA kernels from `tensorrtx_tpu_torch/csrc/`.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded through ``ctypes``. Libraries go to
``tensorrtx_tpu_torch/_build/`` (git-ignored) under a name keyed by the
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header rebuilds. Nothing is
built at import: the first launch builds its library, or `build` builds
them all at once, one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["KERNELS", "build", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# kernel name → (source file under csrc/, extra nvcc flags)
KERNELS: Dict[str, tuple] = {
    # -fmad=false: the IoU must round like the plain version's separate
    # multiply and add, or a pair within an ulp of the threshold can flip
    "nms_mask": ("nms_mask.cu", ["-fmad=false"]),
    # -fmad=false: acc·scale + bias must not contract into an FMA, or the
    # requant can land on the other side of a rounding edge
    "qconv": ("qconv.cu", ["-fmad=false"]),
    # -fmad=false: x·(1/s) and the stochastic form's products must round
    # alone, as the plain versions' do (and quant_math.cuh's, in both
    # libraries)
    "quantize": ("quantize.cu", ["-fmad=false"]),
    "conv_planar": ("conv_planar.cu", []),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> Optional[str]:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else shutil.which("nvcc")


def _lib_path(name: str) -> Path:
    src, extra = KERNELS[name]
    h = hashlib.sha256((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # what the sources include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, in parallel. Returns name → {"seconds", "log"}
    (the log holds ptxas's register and shared-memory report). Raises if a
    compile fails."""
    names = list(KERNELS if names is None else names)
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        if nvcc is None:
            raise RuntimeError(f"nvcc not found; cannot build kernel {name!r}")
        src, extra = KERNELS[name]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {name: {"seconds": 0.0, "log": "already built"} for name in names}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib
