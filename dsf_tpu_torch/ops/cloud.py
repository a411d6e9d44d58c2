"""Depth-image <-> point-cloud ops with fixed shapes (counterpart of
dsf_tpu/ops/cloud.py; ref: render_loader.py:1121-1227).

Ported: what the FinetuneStage step's real-image prep runs — the uvd
grid, ``uvd_img_to_xyz_img``, ``crop_hand`` and the fixed-N cloud
``img_to_pcl``, whose random subsampling takes its scores as a tensor.
"""

from __future__ import annotations

import torch

from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.ops.image import resize_nearest


def uvd_image_grid(img, img_size):
    """(B, 1, S, S) depth -> (B, 3, S, S) normalized uvd per pixel on the
    corner-anchored grid (ref: render_loader.py:1194-1198)."""
    B, _, S, _ = img.shape
    r = (torch.arange(S, dtype=img.dtype, device=img.device) / (S - 1.0)
         * 2.0 - 1.0)
    vg, ug = torch.meshgrid(r, r, indexing="ij")
    return torch.cat([ug.expand(B, 1, S, S), vg.expand(B, 1, S, S), img],
                     dim=1)


def uvd_img_to_xyz_img(img, center, M, cube, paras, img_size, flip=1.0):
    """(B, 1, S, S) -> (xyz mm (B, 3, S, S), xyz normalized (B, 3, S, S))
    (ref: uvdImg2xyzImg, render_loader.py:1190-1201)."""
    B, _, S, _ = img.shape
    uvd = uvd_image_grid(img, img_size).reshape(B, 3, S * S).transpose(1, 2)
    xyz = geo.uvd_nl_to_xyz(uvd, center, M, cube, paras, img_size, flip)
    xyz_nl = (xyz - center[:, None, :]) / (cube[:, None, :] / 2.0)

    def to_img(a):
        return a.transpose(1, 2).reshape(B, 3, S, S)

    return to_img(xyz), to_img(xyz_nl)


def crop_hand(img, joint_nl, center, M, cube, paras, img_size, flip=1.0):
    """Pixels outside the joints' box plus margins become background, +1
    (ref: crop_hand, render_loader.py:1209-1227): 25 mm in x and y, 20 mm
    in z, and 20 mm more behind the hand for its thickness."""
    skel = joint_nl * cube[:, None] / 2.0 + center[:, None]
    lo_m = torch.tensor([25.0, 25.0, 40.0], dtype=skel.dtype,
                        device=skel.device)
    hi_m = torch.tensor([25.0, 25.0, 20.0], dtype=skel.dtype,
                        device=skel.device)
    lo = (skel.min(dim=1).values - lo_m)[:, :, None, None]
    hi = (skel.max(dim=1).values + hi_m)[:, :, None, None]
    xyz, _ = uvd_img_to_xyz_img(img, center, M, cube, paras, img_size, flip)
    inside = ((xyz > lo) & (xyz < hi)).all(dim=1, keepdim=True)
    return torch.where(inside, img, torch.ones_like(img))


def img_to_pcl(score, img, center, M, cube, paras, img_size,
               sample_num=2048, feature_size=128, flip=1.0):
    """Fixed-N normalized point cloud (B, sample_num, 3) from the
    foreground pixels of img (B, 1, S, S) (ref: Img2pcl,
    render_loader.py:1121-1156).

    ``score`` (B, feature_size^2): one uniform draw in [0, 1) per pixel of
    the image resized to feature_size.  The foreground pixels are ordered
    by descending score (a stable sort of the negated scores, so equal
    scores keep pixel order) and the cloud takes them cyclically: row i is
    the (i mod min(n_valid, N))-th, so each foreground pixel appears
    floor- or ceil-(N / n_valid) times.  An empty image gives zeros."""
    B = img.shape[0]
    img_rs = resize_nearest(img, (feature_size, feature_size))
    uvd = uvd_image_grid(img_rs, img_size).reshape(B, 3, -1).transpose(1, 2)
    valid = (img_rs <= 0.99).reshape(B, -1)
    xyz = geo.uvd_nl_to_xyz_nl(uvd, center, M, cube, paras, img_size, flip)

    score = torch.where(valid, score, torch.full_like(score, -1.0))
    order = torch.sort(-score, dim=-1, stable=True).indices[:, :sample_num]
    head = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    n_valid = valid.sum(-1)
    take = (torch.arange(sample_num, device=img.device)[None, :]
            % torch.clamp_min(torch.clamp_max(n_valid, sample_num), 1)[:, None])
    pcl = torch.gather(head, 1, take[..., None].expand(-1, -1, 3))
    return torch.where((n_valid > 0)[:, None, None], pcl,
                       torch.zeros_like(pcl))
