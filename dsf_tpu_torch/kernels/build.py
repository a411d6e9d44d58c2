"""Build the CUDA kernels of ``dsf_tpu_torch/csrc`` at first use and load
them with ctypes.

Each ``.cu`` source has a plain C interface (no PyTorch headers), so one
``nvcc -shared`` per source takes seconds; all sources compile at once,
one ``nvcc`` process each.  Libraries land in ``dsf_tpu_torch/_build``
(git-ignored) under a name that carries a hash of the source and flags,
so an unchanged source is compiled once per checkout and a changed one
is never loaded stale; the hash covers the shared ``.cuh`` headers of
``csrc`` too.  Every exported C function launches on the stream it is
given and returns ``cudaGetLastError()`` as an int, which the Python
wrapper turns into an exception.

``host_library`` builds the loader's host library, ``csrc/host_data.cpp``
(C++ for the CPU, not a kernel), the same way with the host C++ compiler
(``$CXX`` or ``c++``), which a machine with the CUDA toolkit also has.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("raster_skip", "moments", "codec", "point_mesh", "tail_conv",
           "point_mesh_v2", "point_mesh_culled", "raster_dense",
           "raster_binned")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
HOST_SOURCE = "host_data"
# no -march=native (one build serves any x86-64 or arm64 host) and no
# contraction into fused multiply-adds: the library reproduces numpy's and
# OpenCV's roundings operation by operation
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread",
              "-ffp-contract=off")

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
    h = hashlib.sha256()
    if name == HOST_SOURCE:
        files, flags = [name + ".cpp"], HOST_FLAGS
    else:
        # the source, then every shared header it may include
        files = [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                        if f.endswith(".cuh"))
        flags = NVCC_FLAGS
    for fn in files:
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
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


def host_library() -> ctypes.CDLL:
    """The loaded host library ``csrc/host_data.cpp``, compiled with the
    host C++ compiler on first use; raises if it does not build."""
    with _lock:
        lib = _libs.get(HOST_SOURCE)
        if lib is None:
            out = _lib_path(HOST_SOURCE)
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                cxx = os.environ.get("CXX") or shutil.which("c++") or "g++"
                tmp = f"{out}.{os.getpid()}.tmp"
                res = subprocess.run(
                    [cxx, *HOST_FLAGS, "-o", tmp,
                     os.path.join(CSRC, HOST_SOURCE + ".cpp")],
                    capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"{cxx} failed for {HOST_SOURCE}.cpp:"
                                       f"\n{res.stdout}{res.stderr}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(out)
            _libs[HOST_SOURCE] = lib
        return lib


_fns: Dict[str, object] = {}


def function(lib: str, name: str, n_ptr: int, n_int: int):
    """The exported C function ``name`` of ``csrc/<lib>.cu``, taking
    ``n_ptr`` pointers, ``n_int`` ints and the stream and returning a CUDA
    error code; loaded and typed once."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(lib), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check_tensors(specs) -> None:
    """Raise unless each (name, tensor, shape, dtype, alignment in bytes)
    is a contiguous tensor of that shape and type on the first one's CUDA
    device, its start aligned for the kernel's vector reads."""
    dev = specs[0][1].device
    for name, t, shape, dtype, align in specs:
        if t.device.type != "cuda" or t.dtype != dtype:
            raise ValueError(f"{name}: need a {dtype} CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: need a {align}-byte aligned start")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, the others on {dev}")


@contextlib.contextmanager
def on_device(*tensors):
    """Launch on the tensors' own card: enter their CUDA device (not the
    caller's current one) and yield its current stream's handle.  Raises
    ValueError when they are not all on one CUDA device (None entries,
    absent optional inputs, are skipped)."""
    ts = [t for t in tensors if t is not None]
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("a kernel's tensors must be on one CUDA device, got "
                         + ", ".join(sorted({str(t.device) for t in ts})))
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
