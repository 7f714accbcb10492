"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles at first use into
``zs_aac_tpu_torch/build/lib<name>_<hash>.so`` (the hash is of the source
and the shared ``csrc/*.cuh`` headers, so an edited source rebuilds). The
sources expose plain C functions: the wrappers pass tensor pointers as
``c_void_p`` and PyTorch's current stream, and each C function returns
``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}  # name -> loaded library, one per process


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only where the CUDA toolkit is installed")
    return found


def _target(name: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}_{digest}.so"


def build(names) -> dict:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns {name: (seconds, nvcc output)}
    for the sources it compiled; raises with nvcc's output on failure."""
    todo = [n for n in names if not _target(n).exists()]
    report = {}
    if not todo:
        return report
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    errors = []
    for n, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        report[n] = (time.perf_counter() - t0, out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            continue
        os.replace(tmp, _target(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
