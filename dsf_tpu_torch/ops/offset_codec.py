"""Dense-representation codec: joints <-> 3D offset field + cone heatmap
(counterpart of dsf_tpu/ops/offset_codec.py).

Encoding (joint2offset): per joint, a 3-channel unit offset field toward
the joint plus a cone heatmap (k - dist)/k, masked to foreground pixels
(img < 0.99) within the cone.  Decoding (offset2joint_softmax): a
softmax(scale * heatmap)-weighted vote of coords + offset * dist.
Feature layout: (B, 4J, S, S) = [3J offset channels | J heatmap channels].

``*_plain`` are the plain PyTorch versions (the JAX package's jnp paths,
with three-term sums written out left to right); on the CPU their
gradients are plain autograd, the jnp paths' autodiff.  The public
functions resize the image to the feature size (outside the kernels, as
in the JAX package, so the resize's gather gradient is torch's), then
take the plain version for CPU tensors and, for GPU tensors, the
``autograd.Function`` whose forward and backward are the CUDA kernels
(``codec_kernel.EncodeFn``: K5, ``DecodeFn``: K4).
"""

from __future__ import annotations

import torch

from dsf_tpu_torch.ops import codec_kernel
from dsf_tpu_torch.ops.image import resize_nearest


def _coords(depth, feature_size):
    """(B, 3, S, S): normalized pixel-centre u, v grids + depth channel."""
    B = depth.shape[0]
    r = ((torch.arange(feature_size, dtype=depth.dtype, device=depth.device)
          + 0.5) / feature_size * 2.0 - 1.0)
    v, u = torch.meshgrid(r, r, indexing="ij")
    uu = u.expand(B, 1, feature_size, feature_size)
    vv = v.expand(B, 1, feature_size, feature_size)
    return torch.cat([uu, vv, depth], dim=1)


def joint2offset_plain(joint, img_s, kernel_size):
    """joints (B, J, 3) normalized uvd + img_s (B, 1, S, S) already at the
    feature size -> (B, 4J, S, S)."""
    B, J, _ = joint.shape
    S = img_s.shape[-1]
    coords = _coords(img_s, S)                                   # (B,3,S,S)
    offset = joint.reshape(B, J, 3, 1, 1) - coords[:, None]      # (B,J,3,S,S)
    sq = offset * offset
    dist = torch.sqrt(sq[:, :, 0] + sq[:, :, 1] + sq[:, :, 2] + 1e-8)
    offset_norm = offset / dist[:, :, None]
    heatmap = (kernel_size - dist) / kernel_size
    fg = (img_s < 0.99).to(img_s.dtype)                          # (B,1,S,S)
    mask = (heatmap >= 0).to(img_s.dtype) * fg
    offset_m = (offset_norm * mask[:, :, None]).reshape(B, J * 3, S, S)
    return torch.cat([offset_m, heatmap * mask], dim=1)


def offset2joint_plain(offset, depth_s, kernel_size, scale=30.0):
    """(B, 4J, S, S) feature + depth_s (B, 1, S, S) at the feature size ->
    joints (B, J, 3)."""
    B, C, S, _ = offset.shape
    J = C // 4
    unit = offset[:, : J * 3].reshape(B, J, 3, S * S)
    heatmap = offset[:, J * 3:].reshape(B, J, S * S)
    coords = _coords(depth_s, S).reshape(B, 1, 3, S * S)
    mask = (depth_s < 0.99).to(offset.dtype).reshape(B, 1, S * S)
    unit_m = unit * mask[:, :, None]
    heat_m = heatmap * mask
    normal_heat = torch.softmax(heat_m * scale, dim=-1)
    dist = kernel_size - heat_m * kernel_size
    vote = unit_m * dist[:, :, None] + coords
    return torch.sum(vote * normal_heat[:, :, None], dim=-1)


def joint2offset(joint, img, kernel_size, feature_size):
    """joints (B, J, 3) normalized uvd + img (B, 1, H, W) -> (B, 4J, S, S)
    (ref: GFM.joint2offset)."""
    img_s = resize_nearest(img, (feature_size, feature_size))
    if joint.device.type == "cpu":
        return joint2offset_plain(joint, img_s, kernel_size)
    if joint.device.type == "cuda":
        return codec_kernel.EncodeFn.apply(joint.float().contiguous(),
                                           img_s.float().contiguous(),
                                           kernel_size)
    raise ValueError(f"no codec path for device {joint.device}")


def offset2joint_softmax(offset, depth, kernel_size, scale=30.0):
    """(B, 4J, S, S) feature + depth (B, 1, H, W) -> joints (B, J, 3)
    (ref: GFM.offset2joint_softmax)."""
    S = offset.shape[-1]
    if depth.shape[-1] != S:
        depth = resize_nearest(depth, (S, S))
    if offset.device.type == "cpu":
        return offset2joint_plain(offset, depth, kernel_size, scale)
    if offset.device.type == "cuda":
        return codec_kernel.DecodeFn.apply(offset.float().contiguous(),
                                           depth.float().contiguous(),
                                           kernel_size, scale)
    raise ValueError(f"no codec path for device {offset.device}")
