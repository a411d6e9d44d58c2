"""Depth-image <-> point-cloud ops with fixed shapes (counterpart of
dsf_tpu/ops/cloud.py; ref: render_loader.py:1121-1227).

The uvd grid, ``uvd_img_to_xyz_img``, ``crop_hand`` and the fixed-N cloud
``img_to_pcl`` (whose random subsampling takes its scores as a tensor, or
the JAX package's fixed per-pixel scores), its inverse ``pcl_to_img``,
and the skeleton-interpolation segmentation labelers.
"""

from __future__ import annotations

import numpy as np
import torch

from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.mano.constants import BONE_CHILD
from dsf_tpu_torch.ops.image import resize_nearest


def uvd_image_grid(img, img_size):
    """(B, 1, S, S) depth -> (B, 3, S, S) normalized uvd per pixel on the
    corner-anchored grid (ref: render_loader.py:1194-1198)."""
    B, _, S, _ = img.shape
    ug, vg = geo.norm_grid_corner(S, img.dtype, img.device)
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
    inside = _skeleton_box(img, joint_nl, center, M, cube, paras, img_size,
                           flip, [25.0, 25.0, 40.0], [25.0, 25.0, 20.0])
    return torch.where(inside, img, torch.ones_like(img))


def draw_scores(gen: torch.Generator, batch: int, feature_size: int):
    """``img_to_pcl``'s draw on the CPU from ``gen``: one uniform score in
    [0, 1) per pixel of the feature_size^2 image, (batch,
    feature_size^2)."""
    return torch.rand(batch, feature_size * feature_size, generator=gen)


def weyl_scores(n, device=None):
    """(n,) float32: img_to_pcl's fixed score of pixel i, the top 24 bits
    of the uint32 product i * 2654435761 over 2^24 (the uint32 arithmetic
    done in int64 with a mask)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    w = ((i * 2654435761) & 0xFFFFFFFF) >> 8
    return w.to(torch.float32) / float(1 << 24)


def img_to_pcl(score, img, center, M, cube, paras, img_size,
               sample_num=2048, feature_size=128, flip=1.0):
    """Fixed-N normalized point cloud (B, sample_num, 3) from the
    foreground pixels of img (B, 1, S, S) (ref: Img2pcl,
    render_loader.py:1121-1156).

    ``score`` (B, feature_size^2): one uniform draw in [0, 1) per pixel of
    the image resized to feature_size, or None for the JAX package's
    ``key=None`` mode: each pixel i gets the batch-independent score
    ((i * 2654435761) mod 2^32 >> 8) / 2^24 (a Weyl sequence), so a
    validity row always yields the same points.  The foreground pixels
    are ordered by descending score (a stable sort of the negated scores,
    so equal scores keep pixel order) and the cloud takes them
    cyclically: row i is the (i mod min(n_valid, N))-th, so each
    foreground pixel appears floor- or ceil-(N / n_valid) times.  An
    empty image gives zeros."""
    B = img.shape[0]
    img_rs = resize_nearest(img, (feature_size, feature_size))
    uvd = uvd_image_grid(img_rs, img_size).reshape(B, 3, -1).transpose(1, 2)
    valid = (img_rs <= 0.99).reshape(B, -1)
    xyz = geo.uvd_nl_to_xyz_nl(uvd, center, M, cube, paras, img_size, flip)

    if score is None:
        score = weyl_scores(valid.shape[-1], img.device).expand(valid.shape)
    score = torch.where(valid, score, torch.full_like(score, -1.0))
    order = torch.sort(-score, dim=-1, stable=True).indices[:, :sample_num]
    head = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    n_valid = valid.sum(-1)
    take = (torch.arange(sample_num, device=img.device)[None, :]
            % torch.clamp_min(torch.clamp_max(n_valid, sample_num), 1)[:, None])
    pcl = torch.gather(head, 1, take[..., None].expand(-1, -1, 3))
    return torch.where((n_valid > 0)[:, None, None], pcl,
                       torch.zeros_like(pcl))


def pcl_to_img(pcl_nl, feature_size, center, M, cube, paras, img_size,
               flip=1.0):
    """Scatter a normalized cloud (B, N, 3) back into a (B, 1,
    feature_size, feature_size) depth image, background 1, where a later
    point overwrites an earlier one on the same pixel, as torch.scatter
    does on the CPU (ref: pcl2Img, render_loader.py:1158-1171).  The pixel
    is the JAX package's int32 truncation of floor(v) * fs + u (u is not
    floored on its own).  A scatter of duplicate indices has no order on
    CUDA, so the last writer is found explicitly: each pixel's largest
    point index by a scatter-max, then its depth by a gather."""
    B, N, _ = pcl_nl.shape
    fs = feature_size
    uvd = geo.xyz_nl_to_uvd_nl(pcl_nl, center, M, cube, paras, img_size, flip)
    uv = torch.clamp((uvd[..., :2] + 1.0) / 2.0, 0.0, 1.0) * (fs - 1)
    lin = (torch.floor(uv[..., 1]) * fs + uv[..., 0]).to(torch.int32).long()
    last = torch.full((B, fs * fs), -1, dtype=torch.long, device=lin.device)
    last.scatter_reduce_(1, lin, torch.arange(N, device=lin.device)
                         .expand(B, N), "amax")
    d = torch.gather(uvd[..., 2], 1, last.clamp_min(0))
    out = torch.where(last >= 0, d, torch.ones_like(d))
    return out.reshape(B, 1, fs, fs)


# ---------------------------------------------------------------------------
# skeleton-interpolation segmentation labelers
# (ref: render_loader.py:1352-1480 — Joint2BKSeg / Joint2FingerSeg /
#  Joint2JointSeg / InterpolationJoint / PCL2JointSeg)
# ---------------------------------------------------------------------------

_PALM_CHILD = [1, 4, 7, 10, 13]


def _unit_linspace(n, like):
    """jnp.linspace(0, 1, n) as the JAX package gets it on the CPU: XLA
    turns its float32 i / (n - 1) into i * fl(1 / (n - 1)), and the last
    entry is exactly 1."""
    t = (torch.arange(n, dtype=like.dtype, device=like.device)
         * float(np.float32(1) / np.float32(n - 1)))
    t[-1] = 1.0
    return t


def interpolation_joint(joints, interval):
    """Densify the 21-joint skeleton (B, 21, 3) into bone-interpolated
    sphere centres (ref: InterpolationJoint, render_loader.py:1429-1452).

    Layout (the label tables below read it): [wrist, 5 palm bones x
    ``interval`` interior points, 15 finger bones x (interval + 1) points
    (parent included, child excluded)] -> (B, 1 + 5 interval + 15
    (interval + 1), 3)."""
    B = joints.shape[0]
    t = _unit_linspace(interval + 2, joints)
    palm_t = t[1:-1].reshape(1, 1, -1, 1)
    bone_t = t[:-1].reshape(1, 1, -1, 1)
    wrist = joints[:, 0:1]
    palm = ((joints[:, _PALM_CHILD] - wrist)[:, :, None] * palm_t
            + wrist[:, :, None])
    palm = torch.cat([wrist, palm.reshape(B, -1, 3)], dim=1)
    fparent = joints[:, 1:16]
    fbone = ((joints[:, BONE_CHILD] - fparent)[:, :, None] * bone_t
             + fparent[:, :, None])
    return torch.cat([palm, fbone.reshape(B, -1, 3)], dim=1)


def _finger_label_table(interval):
    """argmin sphere index -> finger part id: 0 palm, 1..5 fingers."""
    n = 1 + 5 * interval + 15 * (interval + 1)
    table = np.zeros(n, np.int32)
    start = 5 * interval + 1
    block = 3 * (interval + 1)
    for f in range(5):
        table[start + f * block:start + (f + 1) * block] = f + 1
    return table


def _joint_label_table(interval):
    """argmin sphere index -> joint part id: 0 palm, f*3+1..3 finger
    segments, 16..20 tips.  The reference's sequential where-chain
    (render_loader.py:1395-1424) gives the same labels for interval >= 4,
    where the labels it writes cannot collide with later ranges."""
    n = 1 + 5 * interval + 15 * (interval + 1)
    table = np.zeros(n, np.int32)
    start = 5 * interval + 1
    block = 3 * (interval + 1)
    h = interval // 2 + 1
    for f in range(5):
        s = start + f * block
        table[s:s + h] = f * 3 + 1
        table[s + h:s + h + interval] = f * 3 + 2
        table[s + h + interval:s + h + 2 * interval] = f * 3 + 3
        table[s + h + 2 * interval:s + block] = 16 + f
    return table


def _skeleton_box(img, joint_nl, center, M, cube, paras, img_size, flip,
                  lo_margin, hi_margin):
    """Whether each pixel's camera point lies inside the joints' box grown
    by the margins (mm, per axis) -> (B, 1, S, S) bool."""
    skel = joint_nl * cube[:, None] / 2.0 + center[:, None]
    lo_m = torch.tensor(lo_margin, dtype=skel.dtype, device=skel.device)
    hi_m = torch.tensor(hi_margin, dtype=skel.dtype, device=skel.device)
    lo = (skel.min(dim=1).values - lo_m)[:, :, None, None]
    hi = (skel.max(dim=1).values + hi_m)[:, :, None, None]
    xyz, _ = uvd_img_to_xyz_img(img, center, M, cube, paras, img_size, flip)
    return ((xyz > lo) & (xyz < hi)).all(dim=1, keepdim=True)


def joint_to_bk_seg(img, joint_nl, center, M, cube, paras, img_size,
                    flip=1.0, offset=20.0, hand_thickness=20.0):
    """Binary hand/background labels (B, S, S) int32: foreground pixels
    inside the skeleton's box grown by ``offset`` mm, and by
    ``hand_thickness`` more behind the hand (ref: Joint2BKSeg,
    render_loader.py:1352-1371)."""
    inside = _skeleton_box(img, joint_nl, center, M, cube, paras, img_size,
                           flip, [offset, offset, offset + hand_thickness],
                           [offset, offset, offset])
    return (inside & (img < 0.99)).to(torch.int32).squeeze(1)


def _nearest_sphere(points, spheres):
    """(B, N, 3) x (B, K, 3) -> (B, N) the first nearest sphere (squared
    euclidean distance, summed x + y + z)."""
    diff = points[:, :, None] - spheres[:, None]
    sq = diff * diff
    return torch.argmin(sq[..., 0] + sq[..., 1] + sq[..., 2], dim=-1)


def _pixel_labels(img, joint_nl, center, M, cube, paras, img_size, interval,
                  table, flip):
    """Each pixel's label (B, S, S) int32: ``table`` at its camera point's
    nearest interpolated sphere."""
    skel = (interpolation_joint(joint_nl, interval) * cube[:, None] / 2.0
            + center[:, None])
    xyz, _ = uvd_img_to_xyz_img(img, center, M, cube, paras, img_size, flip)
    B, _, S, _ = xyz.shape
    idx = _nearest_sphere(xyz.reshape(B, 3, -1).transpose(1, 2), skel)
    return torch.as_tensor(table, device=img.device)[idx].reshape(B, S, S)


def joint_to_finger_seg(img, joint_nl, center, M, cube, paras, img_size,
                        interval, mask, flip=1.0):
    """Per-pixel finger labels (B, S, S) int32: 0 palm, 1..5 fingers, 6
    where ``mask`` is 0 (ref: Joint2FingerSeg, render_loader.py:1373-1393)."""
    seg = _pixel_labels(img, joint_nl, center, M, cube, paras, img_size,
                        interval, _finger_label_table(interval), flip)
    return torch.where(mask > 0, seg, torch.full_like(seg, 6))


def joint_to_joint_seg(img, joint_nl, center, M, cube, paras, img_size,
                       interval, mask, flip=1.0):
    """Per-pixel joint-segment labels (B, S, S) int32: 0 palm, f*3+1..3,
    tips 16..20, 21 where ``mask`` is 0 (ref: Joint2JointSeg,
    render_loader.py:1395-1424)."""
    seg = _pixel_labels(img, joint_nl, center, M, cube, paras, img_size,
                        interval, _joint_label_table(interval), flip)
    return torch.where(mask > 0, seg, torch.full_like(seg, 21))


def pcl_to_joint_seg(pcl, joint, interval, mask):
    """Per-point joint-segment labels (B, N) int32, 21 where ``mask`` is 0
    (ref: PCL2JointSeg, render_loader.py:1454-1480); pcl and joint share
    the caller's space."""
    idx = _nearest_sphere(pcl, interpolation_joint(joint, interval))
    seg = torch.as_tensor(_joint_label_table(interval), device=pcl.device)[idx]
    return torch.where(mask > 0, seg, torch.full_like(seg, 21))
