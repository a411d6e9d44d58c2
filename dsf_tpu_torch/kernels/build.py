"""Build the CUDA kernels of ``dsf_tpu_torch/csrc`` at first use and load
them with ctypes.

Each ``.cu`` source has a plain C interface (no PyTorch headers), so one
``nvcc -shared`` per source takes seconds; all sources compile at once,
one ``nvcc`` process each.  Libraries land in ``dsf_tpu_torch/_build``
(git-ignored) under a name that carries a hash of the source and flags,
so an unchanged source is compiled once per checkout and a changed one
is never loaded stale.  Every exported C function launches on the stream
it is given and returns ``cudaGetLastError()`` as an int, which the
Python wrapper turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("raster_skip", "moments", "codec", "point_mesh", "tail_conv")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def _compile(name: str, ptxas_verbose: bool) -> str:
    out = _lib_path(name)
    if os.path.exists(out) and not ptxas_verbose:
        return ""
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    if ptxas_verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return res.stdout + res.stderr


def build_all(ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every source that has no current library, in parallel.
    Returns the compiler's messages per source (ptxas register and shared
    memory use with ``ptxas_verbose``)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        futs = {n: ex.submit(_compile, n, ptxas_verbose) for n in SOURCES}
        return {n: f.result() for n, f in futs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not os.path.exists(_lib_path(name)):
                build_all()
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
