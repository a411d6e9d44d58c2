"""Rules of the PyTorch port that no parity test covers: dsf_tpu_torch
imports nothing of JAX, Flax or dsf_tpu; its entry points run on CUDA
unless told otherwise and raise, never fall back, when CUDA is missing;
and its kernel wrappers refuse what the kernels do not take."""

import ast
import os

import numpy as np
import pytest
import torch

import dsf_tpu_torch
from dsf_tpu_torch import kernels
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.device import resolve_device
from dsf_tpu_torch.mano.model import load_model
from dsf_tpu_torch.ops import (codec_kernel, moments_kernel,
                               point_mesh_kernel, raster_kernel,
                               tapsum_kernel)
from dsf_tpu_torch.serving import InferenceEngine
from dsf_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)

PKG = os.path.dirname(dsf_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dsf_tpu")


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_flax_or_dsf_tpu_imports():
    files = list(_py_files())
    assert len(files) > 10
    bad = [(os.path.relpath(p, PKG), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_chip_smoke_imports_no_jax():
    path = os.path.join(os.path.dirname(PKG), "chip_smoke.py")
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_default_device_is_cuda_and_raises_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    # the engine checks the device before it touches weights or assets
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(Config(mano_model_path=str(tmp_path / "none.npz")), {})
    # so do the MANO loader and the trainer, the other public constructors
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(str(tmp_path / "none.npz"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(Config(), str(tmp_path / "none.npz"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches on a CUDA tensor or raises; it never computes."""
    with pytest.raises(ValueError, match="CUDA"):
        raster_kernel.raster_skip_cuda(torch.zeros(1, 64, 16),
                                       torch.zeros(1, 1, 4),
                                       torch.zeros(1, 256, 2), (16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        codec_kernel.encode_cuda(torch.zeros(1, 21, 3),
                                 torch.zeros(1, 1, 8, 8), 0.8)
    with pytest.raises(ValueError, match="CUDA"):
        codec_kernel.decode_cuda(torch.zeros(1, 84, 8, 8),
                                 torch.zeros(1, 1, 8, 8), 0.8, 30.0)
    with pytest.raises(ValueError, match="CUDA"):
        codec_kernel.encode_bwd_cuda(torch.zeros(1, 21, 3),
                                     torch.zeros(1, 1, 8, 8),
                                     torch.zeros(1, 84, 8, 8), 0.8)
    with pytest.raises(ValueError, match="CUDA"):
        codec_kernel.decode_bwd_cuda(torch.zeros(1, 84, 8, 8),
                                     torch.zeros(1, 1, 8, 8),
                                     torch.zeros(1, 21, 3), 0.8, 30.0)
    with pytest.raises(ValueError, match="CUDA"):
        moments_kernel.face_moments_cuda(torch.zeros(1, 16, dtype=torch.int32),
                                         torch.zeros(1, 16, 3), 8)
    with pytest.raises(ValueError, match="CUDA"):
        point_mesh_kernel.argmin_faces_cuda(torch.zeros(1, 16, 3),
                                            torch.zeros(1, 4, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        point_mesh_kernel.argmin_faces_launch(
            torch.zeros(1, 16, 3), torch.zeros(1, 4, 28),
            torch.zeros(4, dtype=torch.int32),
            torch.zeros(1, 16, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tapsum_kernel.tail_conv_cuda(torch.zeros(1, 8, 14, 14),
                                     torch.zeros(1, 8, 7, 7), torch.zeros(1))
    assert kernels.LAUNCHES == {name: 0 for name in (
        "raster_skip", "raster_moments", "codec_encode", "codec_encode_bwd",
        "codec_decode", "codec_decode_bwd", "point_mesh_argmin", "tail_conv")}


def test_kernel_sources_and_build_flags():
    """One nvcc per source for sm_90a, no fast-math, and each source names
    the TPU kernel it replaces."""
    from dsf_tpu_torch.kernels import build
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in f for f in build.NVCC_FLAGS)
    for name, tpus in (("raster_skip", ("raster_pallas_skip",)),
                       ("moments", ("face_moments_pallas",)),
                       ("codec", ("_encode_fwd_call", "_decode_fwd_call",
                                  "_encode_bwd", "_decode_bwd")),
                       ("point_mesh", ("argmin_faces_pallas",)),
                       ("tail_conv", ("pallas_tapsum.py:tail_conv_tanh",
                                      "_fast_tail"))):
        with open(os.path.join(build.CSRC, name + ".cu")) as f:
            src = f.read()
        assert all(t in src for t in tpus) and "Replaces:" in src
    assert np.array_equal(sorted(build.SOURCES),
                          ["codec", "moments", "point_mesh", "raster_skip",
                           "tail_conv"])
