"""Image resampling ops (counterpart of dsf_tpu/ops/image.py): nearest
resize, ``grid_sample``, ``warp_perspective``, ``affine_warp`` and
``roi_align``.  Images are NCHW, as in the
JAX package's public functions.  These are PyTorch ops on both devices:
the JAX package computes them outside any Pallas kernel.

``grid_sample`` and ``affine_warp`` are the JAX package's own gathers,
not ``F.grid_sample`` / ``F.affine_grid``: the sample coordinates are
computed in its order, so that a nearest sample falls on the same pixel
wherever a coordinate is not an exact tie at .5.
"""

from __future__ import annotations

import torch

from dsf_tpu_torch import geometry as geo


def resize_nearest(img, out_hw):
    """torch F.interpolate(img, size=out_hw) default (nearest) semantics:
    src index = floor(dst * in/out), computed in float32 as the JAX
    package does.  img: (..., H, W)."""
    H, W = img.shape[-2], img.shape[-1]
    oh, ow = out_hw
    if (oh, ow) == (H, W):
        return img
    ih = torch.floor(torch.arange(oh, dtype=torch.float32, device=img.device)
                     * (H / oh)).long()
    iw = torch.floor(torch.arange(ow, dtype=torch.float32, device=img.device)
                     * (W / ow)).long()
    return img[..., ih[:, None], iw[None, :]]


def unnormalize(coord, size):
    """[-1, 1] to pixel coordinates, align_corners=False."""
    return ((coord + 1.0) * size - 1.0) / 2.0


def grid_sample(img, grid, mode="nearest"):
    """torch ``F.grid_sample(img, grid, mode, padding_mode="zeros",
    align_corners=False)`` computed as the JAX package's ``grid_sample``.

    img (B, C, H, W); grid (B, Ho, Wo, 2), x (width) first, in [-1, 1].
    ``nearest`` rounds half to even; ``bilinear`` weights the four
    neighbours; a sample outside the image reads 0."""
    B, C, H, W = img.shape
    x = unnormalize(grid[..., 0], W)
    y = unnormalize(grid[..., 1], H)
    b = torch.arange(B, device=img.device)[:, None, None]

    def gather(ix, iy):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        out = img[b, :, iy.clamp(0, H - 1), ix.clamp(0, W - 1)]  # (B,Ho,Wo,C)
        out = torch.where(valid[..., None], out, torch.zeros_like(out))
        return out.permute(0, 3, 1, 2)

    if mode == "nearest":
        return gather(torch.round(x).long(), torch.round(y).long())
    if mode != "bilinear":
        raise ValueError(f"grid_sample mode {mode!r}: nearest or bilinear")
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    v00, v01 = gather(x0, y0), gather(x0 + 1, y0)
    v10, v11 = gather(x0, y0 + 1), gather(x0 + 1, y0 + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def warp_perspective(img, M, crop_size, mode="nearest"):
    """Crop-warp an NCHW image by the 3x3 matrix M (full-frame px -> crop
    px) (ref: warpPerspective, mano_layer.py:1244-1260): the integer crop
    pixels mapped through M^-1, normalized by the frame, and sampled by
    ``grid_sample`` (zeros padding).  crop_size (cw, ch)."""
    B, C, H, W = img.shape
    cw, ch = crop_size
    v, u = torch.meshgrid(torch.arange(ch, dtype=img.dtype, device=img.device),
                          torch.arange(cw, dtype=img.dtype, device=img.device),
                          indexing="ij")
    pix = torch.stack([u, v, torch.ones_like(u)], dim=-1).reshape(1, -1, 3)
    uv = geo.transform_points_2d(pix.expand(B, ch * cw, 3), geo.inv_3x3(M))
    # divisors on the image's device: CUDA divides by a Python number as
    # a product with its reciprocal, which moves a nearest sample at a
    # tie off the CPU's (and JAX's) pixel
    frame = uv.new_tensor([float(W), float(H)])
    gx = uv[..., 0] / frame[0] * 2.0 - 1.0
    gy = uv[..., 1] / frame[1] * 2.0 - 1.0
    grid = torch.stack([gx, gy], dim=-1).reshape(B, ch, cw, 2)
    return grid_sample(img, grid, mode)


def affine_grid(theta, H, W):
    """The sample grid (B, H, W, 2) of ``theta`` (B, 2, 3), an
    output -> input map in normalized coordinates, align_corners=False:
    the pixel centres (x + 0.5) / W * 2 - 1, then theta . (x, y, 1), in
    the JAX package's order (``F.affine_grid`` rounds otherwise); the
    divisions on the device (``geometry.div``), since the nearest warps
    sample through this grid."""
    dev, dt = theta.device, theta.dtype
    ys = geo.div(torch.arange(H, device=dev, dtype=dt) + 0.5, H) * 2.0 - 1.0
    xs = geo.div(torch.arange(W, device=dev, dtype=dt) + 0.5, W) * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    t = theta[:, :, None, None, :]                   # (B, 2, 1, 1, 3)
    grid = t[..., 0] * gx + t[..., 1] * gy + t[..., 2]
    return grid.permute(0, 2, 3, 1)


def affine_warp(img, theta, mode="bilinear"):
    """``grid_sample(img, affine_grid(theta, H, W), mode)``: the cycle
    augmentation's and the CCSSL test-time augmentation's warp
    (ref: render_loader.py:1238-1241, CCSSL/consistency.py:97-107)."""
    B, C, H, W = img.shape
    return grid_sample(img, affine_grid(theta.to(img.dtype), H, W), mode)


def roi_align(img, rois, out_hw, spatial_scale=1.0, sampling_ratio=1):
    """torchvision's ``RoIAlign`` with aligned=False, in tensor ops (the
    reference builds one for its resize and crop variants,
    mano_layer.py:963-964, 1262-1273).  img (B, C, H, W); rois (N, 5) rows
    [batch index, x1, y1, x2, y2] in input pixels.  Each output pixel
    averages the sampling_ratio^2 bilinear samples at (i + 0.5) / s of its
    bin, read at half-pixel centres (the position - 0.5), zeros outside
    the image.  Returns (N, C, out_h, out_w)."""
    B, C, H, W = img.shape
    oh, ow = out_hw
    dev = img.device
    bidx = rois[:, 0].long()
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale for i in range(1, 5))
    bin_w = (x2 - x1) / ow
    bin_h = (y2 - y1) / oh
    s = max(int(sampling_ratio), 1)
    sub = (torch.arange(s, device=dev)[None, None, :] + 0.5) / s  # (1, 1, s)
    px = x1[:, None, None] + (torch.arange(ow, device=dev)[None, :, None]
                              + sub) * bin_w[:, None, None]    # (N, ow, s)
    py = y1[:, None, None] + (torch.arange(oh, device=dev)[None, :, None]
                              + sub) * bin_h[:, None, None]    # (N, oh, s)
    fx = px.reshape(-1, ow * s) - 0.5
    fy = py.reshape(-1, oh * s) - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx = (fx - x0)[:, None, None, :]
    wy = (fy - y0)[:, None, :, None]
    x0, y0 = x0.long(), y0.long()

    def gather(ix, iy):
        # ix (N, ow*s), iy (N, oh*s) -> (N, C, oh*s, ow*s)
        valid = ((ix[:, None, :] >= 0) & (ix[:, None, :] < W)
                 & (iy[:, :, None] >= 0) & (iy[:, :, None] < H))
        out = img[bidx[:, None, None], :, iy.clamp(0, H - 1)[:, :, None],
                  ix.clamp(0, W - 1)[:, None, :]]        # (N, oh*s, ow*s, C)
        return out.permute(0, 3, 1, 2) * valid[:, None]

    out = (gather(x0, y0) * (1 - wx) * (1 - wy)
           + gather(x0 + 1, y0) * wx * (1 - wy)
           + gather(x0, y0 + 1) * (1 - wx) * wy
           + gather(x0 + 1, y0 + 1) * wx * wy)
    N = rois.shape[0]
    return out.reshape(N, C, oh, s, ow, s).mean(dim=(3, 5))
