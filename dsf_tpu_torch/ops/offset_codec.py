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
in the JAX package, so the resize's gather gradient is torch's), then,
where no gradient is asked (serving, eval, an exported program), call
the custom ops ``dsf::encode`` / ``dsf::decode`` (``kernels/custom_ops``:
the plain versions on the CPU, K5 / K4 on the card); where one is asked,
the plain version's autograd for CPU tensors and, for GPU tensors, the
``autograd.Function`` whose forward (the op) and backward are the CUDA
kernels (``codec_kernel.EncodeFn``: K5, ``DecodeFn``: K4).  The CPU decode
without a gradient is ``decode_fwd_plain``'s, with a gradient
``offset2joint_plain``'s: the two differ by float32 rounding alone (a
division by the softmax's mass against ``torch.softmax``'s product with
its inverse).
"""

from __future__ import annotations

import torch

from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.device import widen
from dsf_tpu_torch.kernels import custom_ops
from dsf_tpu_torch.ops import codec_kernel
from dsf_tpu_torch.ops.image import resize_nearest


def _coords(depth, feature_size):
    """(B, 3, S, S): normalized pixel-centre u, v grids + depth channel."""
    B = depth.shape[0]
    u, v = geo.norm_grid_center(feature_size, depth.dtype, depth.device)
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


def _decode_terms(offset, depth_s, kernel_size):
    """The decode's per-pixel terms, as (B, J, 3, P) / (B, J, P) / (B, 1,
    P) tensors: the masked units, the masked heat, the distance k - k hm,
    the coordinates (B, 1, 3, P) and the foreground mask."""
    B, C, S, _ = offset.shape
    J = C // 4
    unit = offset[:, : J * 3].reshape(B, J, 3, S * S)
    heatmap = offset[:, J * 3:].reshape(B, J, S * S)
    coords = _coords(depth_s, S).reshape(B, 1, 3, S * S)
    mask = (depth_s < 0.99).to(offset.dtype).reshape(B, 1, S * S)
    unit_m = unit * mask[:, :, None]
    heat_m = heatmap * mask
    dist = kernel_size - heat_m * kernel_size
    return unit_m, heat_m, dist, coords, mask


def offset2joint_plain(offset, depth_s, kernel_size, scale=30.0):
    """(B, 4J, S, S) feature + depth_s (B, 1, S, S) at the feature size ->
    joints (B, J, 3)."""
    unit_m, heat_m, dist, coords, _ = _decode_terms(offset, depth_s,
                                                    kernel_size)
    normal_heat = torch.softmax(heat_m * scale, dim=-1)
    vote = unit_m * dist[:, :, None] + coords
    return torch.sum(vote * normal_heat[:, :, None], dim=-1)


def decode_fwd_plain(offset, depth_s, kernel_size, scale=30.0):
    """K4 forward's plain version: ``offset2joint_plain``'s joints y
    (B, J, 3) and the softmax's statistics (B, J, 2): the max m of
    scale * heat * mask over the pixels and the mass Z = sum exp(. - m),
    which the VJP ``decode_bwd_plain`` takes instead of a second pass."""
    unit_m, heat_m, dist, coords, _ = _decode_terms(offset, depth_s,
                                                    kernel_size)
    s = heat_m * scale
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    z = e.sum(-1, keepdim=True)
    vote = unit_m * dist[:, :, None] + coords
    y = torch.sum(vote * (e / z)[:, :, None], dim=-1)
    return y, torch.cat([m, z], -1)


def decode_bwd_plain(offset, depth_s, g, y, stats, kernel_size, scale=30.0):
    """K4 VJP's plain version, in closed form from the forward's y and
    statistics: per pixel p of joint j, w = exp(scale hm - m) / Z,
    U = mask (g . unit), V = dist U + g . coords, and A = sum_p w V = g . y,
    so d unit = g mask dist w, d heat = mask w (scale (V - A) - k U) and
    d depth = sum_j w g_z (the mask is not differentiated).  Returns
    (d offset (B, 4J, S, S), d depth_s (B, 1, S, S))."""
    B, C, S, _ = offset.shape
    J = C // 4
    unit_m, heat_m, dist, coords, mask = _decode_terms(offset, depth_s,
                                                       kernel_size)
    w = torch.exp(heat_m * scale - stats[..., :1]) / stats[..., 1:]
    gc = g[..., None]                                           # (B,J,3,1)
    U = (unit_m * gc).sum(2)
    V = dist * U + (coords * gc).sum(2)
    A = (g * y).sum(-1, keepdim=True)
    d_unit = gc * (mask * dist * w)[:, :, None]
    d_heat = mask * w * (scale * (V - A) - kernel_size * U)
    dd = (w * g[..., 2:]).sum(1)
    return (torch.cat([d_unit.reshape(B, 3 * J, S, S),
                       d_heat.reshape(B, J, S, S)], 1),
            dd.reshape(B, 1, S, S))


def _codec_device(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no codec path for device {t.device}")
    return t.device.type


def _wants_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def joint2offset(joint, img, kernel_size, feature_size):
    """joints (B, J, 3) normalized uvd + img (B, 1, H, W) -> (B, 4J, S, S)
    (ref: GFM.joint2offset)."""
    img_s = resize_nearest(img, (feature_size, feature_size))
    dev = _codec_device(joint)
    if dev == "cuda":
        joint, img_s = joint.float().contiguous(), img_s.float().contiguous()
    if not _wants_grad(joint, img_s):
        return custom_ops.encode(joint, img_s, kernel_size)
    if dev == "cpu":
        return joint2offset_plain(joint, img_s, kernel_size)
    return codec_kernel.EncodeFn.apply(joint, img_s, kernel_size)


def offset2joint_softmax(offset, depth, kernel_size, scale=30.0):
    """(B, 4J, S, S) feature + depth (B, 1, H, W) -> joints (B, J, 3)
    (ref: GFM.offset2joint_softmax).  A bfloat16 feature (the net's under
    the bfloat16 compute dtype) is decoded in float32 on both devices, K4
    on the card; the JAX package's serving decodes it in bfloat16 through
    its jnp path (ROADMAP Queue 3 records the difference)."""
    S = offset.shape[-1]
    if depth.shape[-1] != S:
        depth = resize_nearest(depth, (S, S))
    dev = _codec_device(offset)
    if dev == "cuda":
        offset, depth = offset.float().contiguous(), depth.float().contiguous()
    else:
        offset, depth = widen(offset), widen(depth)
    if not _wants_grad(offset, depth):
        return custom_ops.decode(offset, depth, kernel_size, scale)[0]
    if dev == "cpu":
        return offset2joint_plain(offset, depth, kernel_size, scale)
    return codec_kernel.DecodeFn.apply(offset, depth, kernel_size, scale)


def joint2feature(joint, img, feature_paras, feature_size,
                  feature_types=("offset",)):
    """The reference API's encoder dispatch (generateFeature.py:68-74): the
    last ``"offset"`` entry of ``feature_types`` encodes with its kernel
    size from ``feature_paras``; None when there is none."""
    feature = None
    for i, ft in enumerate(feature_types):
        if ft == "offset":
            feature = joint2offset(joint, img, feature_paras[i], feature_size)
    return feature


def feature2joint(img, pixel_pd, feature_types=("offset",),
                  feature_paras=(0.8,)):
    """The reference API's decoder dispatch (generateFeature.py:61-66), as
    ``joint2feature``'s, over ``offset2joint_softmax``."""
    joint = None
    for i, ft in enumerate(feature_types):
        if ft == "offset":
            joint = offset2joint_softmax(pixel_pd, img, feature_paras[i])
    return joint
