"""Elementwise losses (counterpart of dsf_tpu/losses/basic.py; ref:
metric/losses.py), the depth terms and the surface loss."""

from __future__ import annotations

import torch

from dsf_tpu_torch.losses.icp import chamfer_distance
from dsf_tpu_torch.ops.cloud import img_to_pcl


def smooth_l1(x, y):
    """SmoothL1 with delta=0.01: 0.5 z^2 below, 0.01(|z|-0.005) above.

    Keeps the reference's split: the mean over the last dimension of the
    small-residual terms plus the mean of the large ones, then the mean
    over the rest."""
    z = x - y
    az = torch.abs(z)
    small = az < 0.01
    val = torch.where(small, 0.5 * z * z, 0.01 * (az - 0.005))
    zero = torch.zeros_like(val)
    per = (torch.where(small, val, zero).mean(-1)
           + torch.where(small, zero, val).mean(-1))
    return per.mean()


def weighted_smooth_l1(x, y, weight):
    """The per-joint weighted SmoothL1 (ref: metric/losses.py:32-58): the
    magnitude split is taken on the plain residual z, the terms on the
    weighted one, z * weight (``weight`` has x's shape without its last
    dimension); then ``smooth_l1``'s reduction."""
    z = x - y
    small = torch.abs(z) < 0.01
    zw = z * weight[..., None]
    val = torch.where(small, 0.5 * zw * zw, 0.01 * (torch.abs(zw) - 0.005))
    zero = torch.zeros_like(val)
    per = (torch.where(small, val, zero).mean(-1)
           + torch.where(small, zero, val).mean(-1))
    return per.mean()


def masked_depth_loss(real, synth, thresh=0.99):
    """Mean |real - synth| over the pixels where either is foreground, per
    sample (the m2d term, ref: train_render.py:729-732): the sum of the
    masked |diff| over the image over the mask's sum + 1e-8.  real, synth
    (B, 1, H, W) normalized depth -> (B, 1); the caller means."""
    mask = ((real < thresh) | (synth < thresh)).to(real.dtype)
    diff = torch.abs(real - synth) * mask
    return diff.sum((-1, -2)) / (mask.sum((-1, -2)) + 1e-8)


def depth_loss_select(real, synth, thresh=0.99):
    """The standalone depth_loss module's term (ref:
    render_model/render_loss.py:9-21): the mean |real - synth| over the
    pixels where both are foreground, across the whole batch (0 where
    there are none)."""
    mask = (real < thresh) & (synth < thresh)
    diff = torch.abs(real - synth)
    denom = torch.clamp_min(mask.sum(), 1)
    return torch.where(mask, diff, torch.zeros_like(diff)).sum() / denom


def surface_loss(score, real_img, verts_nl, center, M, cube, paras, img_size,
                 sample_num=1024, flip=1.0):
    """The batch mean of the chamfer distance between the depth image's
    cloud (``img_to_pcl`` at the image's size, ``sample_num`` points) and
    the mesh vertices verts_nl (B, V, 3) (ref: surface_loss,
    render_model/render_loss.py:37-117, built but unused by the reference
    trainer).  ``score`` (B, img_size^2) is the cloud's sampling draw
    (``cloud.draw_scores``), or None for img_to_pcl's fixed scores; the
    JAX package draws it from ``PRNGKey(0)`` when given no key, which
    the port cannot draw, so it has no default."""
    pcl = img_to_pcl(score, real_img, center, M, cube, paras, img_size,
                     sample_num, img_size, flip)
    return chamfer_distance(pcl, verts_nl).mean()
