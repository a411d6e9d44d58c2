"""K2 — the raster-backward moments (csrc/moments.cu), replacing the Pallas
``dsf_tpu/ops/pallas_raster.py:face_moments_pallas`` (and computing what
the JAX raster backward's default chunked one-hot einsum computes,
``dsf_tpu/ops/rasterize.py:499-511``).

``face_moments_plain`` is the plain version (``index_add_``), which the
raster backward takes for CPU tensors; ``face_moments_cuda`` launches the
kernel or raises.  The kernel keeps a copy of every face's sums per warp
in shared memory, so it takes at most ``max_faces()`` faces (the MANO
mesh has 1,554).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dsf_tpu_torch.kernels import LAUNCHES, build

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("moments").dsf_raster_moments
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def max_faces():
    """The most faces K2 takes (csrc/moments.cu: each warp's copy of the
    3T sums fits in one CTA's shared memory)."""
    fn = build.library("moments").dsf_raster_moments_max_faces
    fn.restype = ctypes.c_int
    return fn()


def face_moments_plain(idx, upd, num_faces):
    """idx (B, P) integer face ids (-1 = background), upd (B, P, 3) rows
    [g, g*u, g*v] -> (B, num_faces, 3): the sum of the rows of each face's
    pixels.  Ids outside [0, num_faces) add nothing."""
    B, P = idx.shape
    idx = idx.long()
    valid = (idx >= 0) & (idx < num_faces)
    flat = (torch.where(valid, idx, torch.zeros_like(idx))
            + torch.arange(B, device=idx.device)[:, None] * num_faces)
    rows = torch.where(valid[..., None], upd, torch.zeros_like(upd))
    out = torch.zeros((B * num_faces, 3), dtype=upd.dtype, device=upd.device)
    out.index_add_(0, flat.reshape(-1), rows.reshape(B * P, 3))
    return out.reshape(B, num_faces, 3)


def face_moments_cuda(idx, upd, num_faces):
    """The K2 kernel: idx (B, P) int32 and upd (B, P, 3) float32, contiguous
    on one GPU -> (B, num_faces, 3) float32, summed in a fixed order (two
    runs agree bitwise)."""
    B, P = idx.shape
    if idx.device.type != "cuda" or idx.dtype != torch.int32:
        raise ValueError(f"idx: need an int32 CUDA tensor, got {idx.dtype} "
                         f"on {idx.device}")
    if upd.device != idx.device or upd.dtype != torch.float32:
        raise ValueError(f"upd: need a float32 tensor on {idx.device}, got "
                         f"{upd.dtype} on {upd.device}")
    if tuple(upd.shape) != (B, P, 3) or not (upd.is_contiguous()
                                            and idx.is_contiguous()):
        raise ValueError(f"need contiguous idx (B, P) and upd (B, P, 3), got "
                         f"{tuple(idx.shape)} and {tuple(upd.shape)}")
    if B == 0 or P == 0 or num_faces <= 0:
        raise ValueError(f"empty moments: B={B}, P={P}, T={num_faces}")
    if num_faces > max_faces():
        raise ValueError(f"moments: at most {max_faces()} faces, got "
                         f"{num_faces}")
    out = torch.empty((B, num_faces, 3), dtype=torch.float32,
                      device=idx.device)
    fn = _launcher()
    with build.on_device(idx, upd, out) as stream:
        err = fn(idx.data_ptr(), upd.data_ptr(), out.data_ptr(), B, P,
                 int(num_faces), stream)
    build.check(err, "raster_moments")
    LAUNCHES["raster_moments"] += 1
    return out
