"""Elementwise losses (counterpart of dsf_tpu/losses/basic.py; ref:
metric/losses.py) and the masked depth term."""

from __future__ import annotations

import torch


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
