"""The serving path's kernels as ``torch.library`` custom ops (namespace
``dsf``), so that a program exported with ``torch.export`` holds them:
a ctypes call on ``data_ptr()`` cannot be traced with fake tensors, an op
with a fake implementation can.

- ``dsf::raster_skip``: K1 with its face set-up
  (``raster_kernel.raster_skip_cuda``); plain version
  ``rasterize.raster_scan``;
- ``dsf::raster_binned``: K10 with its set-up
  (``raster_kernel.raster_binned_cuda``); plain version
  ``rasterize.raster_binned_plain`` over ``rasterize.binned_tables``;
- ``dsf::encode``: K5's forward (``codec_kernel.encode_cuda``); plain
  version ``offset_codec.joint2offset_plain``;
- ``dsf::decode``: K4's forward, joints and the softmax statistics
  (``codec_kernel.decode_cuda``); plain version
  ``offset_codec.decode_fwd_plain``.

Each op has exactly two implementations: CUDA (the wrapper: it launches
on the tensors' card, on its current stream, counts the launch in
``kernels.LAUNCHES`` and raises on a failed build or launch) and CPU (the
plain version).  There is no default implementation, so a CUDA tensor
never reaches a plain version; the fake implementations give the exact
shapes and dtypes.  The data-dependent branches of the plain versions
(``raster_scan``'s cull, ``raster_binned_plain``'s overflow) stay inside
the CPU implementations, which an export does not trace.

The ops carry no gradient: the raster routes run on detached inputs
(``rasterize.AttachRasterGrad`` adds the raster's gradient), and the
codec's ``autograd.Function``s (``codec_kernel.EncodeFn``, ``DecodeFn``)
call the codec ops in their forwards.  The plain versions are imported
inside the CPU implementations: ``ops/rasterize`` and ``ops/offset_codec``
import this module.

This module imports nothing of ``models``, ``render``, ``mano`` or
``training``: loading an exported program (``dsf_tpu_torch.exported``)
needs the registry and the kernels, not the model code.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from dsf_tpu_torch.ops import codec_kernel, raster_kernel

OPS = ("raster_skip", "raster_binned", "encode", "decode")


def _float_type(*ts: Tensor) -> torch.dtype:
    """The plain versions' result type: float32, or float64 for a float64
    witness run."""
    dt = torch.float32
    for t in ts:
        dt = torch.promote_types(dt, t.dtype)
    return dt


# ------------------------------------------------------------------ K1

@torch.library.custom_op("dsf::raster_skip", mutates_args=(),
                         device_types="cpu")
def raster_skip(proj: Tensor, pix_uv: Tensor, faces: Tensor, H: int,
                W: int) -> Tuple[Tensor, Tensor]:
    """proj (B, V, 3), pix_uv (B, H*W, 2) row-major over an H x W layout,
    faces (F, 3) -> zbuf (B, H*W) (0 = background), idx (B, H*W) int32
    (-1).  CPU: ``rasterize.raster_scan``."""
    from dsf_tpu_torch.ops import rasterize
    return rasterize.raster_scan(proj, pix_uv, faces)


@raster_skip.register_kernel("cuda")
def _raster_skip_cuda(proj, pix_uv, faces, H, W):
    return raster_kernel.raster_skip_cuda(
        proj.float().contiguous(), faces.to(torch.int32).contiguous(),
        pix_uv.contiguous(), (H, W))


@raster_skip.register_fake
def _raster_skip_fake(proj, pix_uv, faces, H, W):
    B, P = pix_uv.shape[0], pix_uv.shape[1]
    return (proj.new_empty((B, P), dtype=_float_type(proj)),
            proj.new_empty((B, P), dtype=torch.int32))


# ------------------------------------------------------------------ K10

@torch.library.custom_op("dsf::raster_binned", mutates_args=(),
                         device_types="cpu")
def raster_binned(proj: Tensor, pix_uv: Tensor, faces: Tensor, H: int,
                  W: int) -> Tuple[Tensor, Tensor]:
    """proj (B, V, 3), pix_uv (B, H*W, 2) row-major over H x W (multiples
    of 16), faces (F, 3) -> (zbuf, idx) as ``raster_skip``.  CPU:
    ``rasterize.raster_binned_plain`` over ``rasterize.binned_tables``."""
    from dsf_tpu_torch.ops import rasterize
    rows = rasterize.face_rows(proj, faces)
    return rasterize.raster_binned_plain(
        rows, pix_uv, (H, W),
        *rasterize.binned_tables(proj, pix_uv, faces, (H, W), rows))


@raster_binned.register_kernel("cuda")
def _raster_binned_cuda(proj, pix_uv, faces, H, W):
    return raster_kernel.raster_binned_cuda(proj, faces, pix_uv, (H, W))


@raster_binned.register_fake
def _raster_binned_fake(proj, pix_uv, faces, H, W):
    B = proj.shape[0]
    return (proj.new_empty((B, H * W), dtype=_float_type(proj)),
            proj.new_empty((B, H * W), dtype=torch.int32))


# ------------------------------------------------------------------ K5

@torch.library.custom_op("dsf::encode", mutates_args=(), device_types="cpu")
def encode(joint: Tensor, img_s: Tensor, kernel_size: float) -> Tensor:
    """joint (B, J, 3) normalized uvd + img_s (B, 1, S, S) at the feature
    size -> (B, 4J, S, S).  CPU: ``offset_codec.joint2offset_plain``."""
    from dsf_tpu_torch.ops import offset_codec
    return offset_codec.joint2offset_plain(joint, img_s, kernel_size)


@encode.register_kernel("cuda")
def _encode_cuda(joint, img_s, kernel_size):
    return codec_kernel.encode_cuda(joint, img_s, kernel_size)


@encode.register_fake
def _encode_fake(joint, img_s, kernel_size):
    B, J, S = joint.shape[0], joint.shape[1], img_s.shape[-1]
    return joint.new_empty((B, 4 * J, S, S),
                           dtype=_float_type(joint, img_s))


# ------------------------------------------------------------------ K4

@torch.library.custom_op("dsf::decode", mutates_args=(), device_types="cpu")
def decode(offset: Tensor, depth_s: Tensor, kernel_size: float,
           scale: float) -> Tuple[Tensor, Tensor]:
    """offset (B, 4J, S, S) + depth_s (B, 1, S, S) -> (joints (B, J, 3),
    the softmax's statistics (B, J, 2)).  CPU:
    ``offset_codec.decode_fwd_plain``."""
    from dsf_tpu_torch.ops import offset_codec
    return offset_codec.decode_fwd_plain(offset, depth_s, kernel_size, scale)


@decode.register_kernel("cuda")
def _decode_cuda(offset, depth_s, kernel_size, scale):
    return codec_kernel.decode_cuda(offset, depth_s, kernel_size, scale)


@decode.register_fake
def _decode_fake(offset, depth_s, kernel_size, scale):
    B, J = offset.shape[0], offset.shape[1] // 4
    dt = _float_type(offset, depth_s)
    return (offset.new_empty((B, J, 3), dtype=dt),
            offset.new_empty((B, J, 2), dtype=dt))
