"""Elementwise losses (counterpart of dsf_tpu/losses/basic.py; ref:
metric/losses.py)."""

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
