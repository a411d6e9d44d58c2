"""The stacked-hourglass backbone (counterpart of
dsf_tpu/models/hourglass.py; ref: model/hourglass.py:65-259), NCHW.

Per stack: a recursive 4-level hourglass over ``inp_dim`` channels, a
feature head and three 1x1 output convs (offset 3J, distance J, weight
J: 5J channels), with merge convs feeding the next stack.  Not the
default net (``ResNet_stage_18`` is); the trainer and the engine run
ResNets only.

Modules carry the reference's state-dict names (``pre.{0,1,3,4}``,
``hgs.i``, ``features.i.{0,1}``, ``outs_{1,2,3}.i``,
``merge_preds.i.conv``, ``merge_features.i.conv``; a ``Conv`` is
``conv`` [+ ``bn``], a ``Residual`` ``bn1..3``, ``conv1..3`` and, where
its channels change, ``skip_layer``), so ``weights.pose_net_from_reference``
only drops the reference's unused skip convs.  BatchNorm is the port's
``BatchNorm2d`` (Flax's running statistics in train mode).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dsf_tpu_torch.models.layers import Conv2d, batch_norm


class HgConv(nn.Module):
    """ref hourglass ``Conv`` (hourglass.py:65-85): a conv with bias
    ('same' padding) [+ BatchNorm] [+ ReLU]."""

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, bn=False,
                 relu=True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride, (kernel - 1) // 2,
                           bias=True)
        self.bn = batch_norm(out_ch) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class Residual(nn.Module):
    """The pre-activation bottleneck (hourglass.py:88-125): BN, ReLU and
    1x1 to out/2, BN, ReLU and 3x3, BN, ReLU and 1x1 to out; plus the
    input, through a 1x1 ``skip_layer`` where the channels change."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        half = out_ch // 2
        self.bn1 = batch_norm(in_ch)
        self.conv1 = HgConv(in_ch, half, 1, relu=False)
        self.bn2 = batch_norm(half)
        self.conv2 = HgConv(half, half, 3, relu=False)
        self.bn3 = batch_norm(half)
        self.conv3 = HgConv(half, out_ch, 1, relu=False)
        self.skip_layer = (HgConv(in_ch, out_ch, 1, relu=False)
                           if in_ch != out_ch else None)

    def forward(self, x):
        skip = x if self.skip_layer is None else self.skip_layer(x)
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        out = self.conv3(F.relu(self.bn3(out)))
        return out + skip


def _pool2(x):
    return F.max_pool2d(x, 2, 2)


def _upsample2(x):
    return x.repeat_interleave(2, -2).repeat_interleave(2, -1)


class Hourglass(nn.Module):
    """The recursive hourglass (hourglass.py:128-152): ``up1`` at this
    scale plus the upsampled ``low3(low2(low1(pool(x))))``, ``low2`` the
    next level (a Residual at the last)."""

    def __init__(self, n, features, increase=0):
        super().__init__()
        nf = features + increase
        self.up1 = Residual(features, features)
        self.low1 = Residual(features, nf)
        self.low2 = (Hourglass(n - 1, nf) if n > 1 else Residual(nf, nf))
        self.low3 = Residual(nf, features)

    def forward(self, x):
        low = self.low3(self.low2(self.low1(_pool2(x))))
        return self.up1(x) + _upsample2(low)


class Merge(nn.Module):
    """ref ``Merge``: a 1x1 ``Conv`` without BatchNorm or ReLU."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv = HgConv(in_ch, out_ch, 1, relu=False)

    def forward(self, x):
        return self.conv(x)


class PoseNet(nn.Module):
    """The stacked hourglass with per-stack offset / distance / weight
    heads (hourglass.py:169-259), as the JAX package's ``PoseNet``: a 7x7
    stride-2 stem with BatchNorm, Residual to 128, a 2x2 max pool,
    Residuals to 256 and ``inp_dim``, then ``nstack`` hourglasses.
    ``forward(imgs)`` (B, 1, S, S) -> (list of (B, 5J, S/4, S/4) per
    stack, the last hourglass's output (B, inp_dim, S/4, S/4)), in
    float32."""

    def __init__(self, nstack=1, joint_num=21, inp_dim=256, in_ch=1):
        super().__init__()
        self.nstack, self.joint_num = nstack, joint_num
        self.pre = nn.Sequential(HgConv(in_ch, 64, 7, 2, bn=True, relu=True),
                                 Residual(64, 128), nn.MaxPool2d(2, 2),
                                 Residual(128, 256), Residual(256, inp_dim))
        self.hgs = nn.ModuleList(Hourglass(4, inp_dim) for _ in range(nstack))
        self.features = nn.ModuleList(
            nn.Sequential(Residual(inp_dim, inp_dim),
                          HgConv(inp_dim, inp_dim, 1, bn=True, relu=True))
            for _ in range(nstack))
        self.outs_1 = nn.ModuleList(Conv2d(inp_dim, 3 * joint_num, 1)
                                    for _ in range(nstack))
        self.outs_2 = nn.ModuleList(Conv2d(inp_dim, joint_num, 1)
                                    for _ in range(nstack))
        self.outs_3 = nn.ModuleList(Conv2d(inp_dim, joint_num, 1)
                                    for _ in range(nstack))
        self.merge_preds = nn.ModuleList(Merge(5 * joint_num, inp_dim)
                                         for _ in range(nstack - 1))
        self.merge_features = nn.ModuleList(Merge(inp_dim, inp_dim)
                                            for _ in range(nstack - 1))

    def forward(self, imgs):
        x = self.pre(imgs)
        preds_all, hg = [], x
        for i in range(self.nstack):
            hg = self.hgs[i](x)
            feat = self.features[i](hg)
            preds = torch.cat([self.outs_1[i](feat), self.outs_2[i](feat),
                               self.outs_3[i](feat)], 1)
            preds_all.append(preds)
            if i < self.nstack - 1:
                x = x + self.merge_preds[i](preds) + self.merge_features[i](
                    feat)
        return preds_all, hg
