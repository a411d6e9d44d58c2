"""Building blocks of the pose networks (counterpart of
dsf_tpu/models/layers.py), NCHW as the reference's torch modules are.

The blocks are the reference's own torch modules (conv_bn_relu,
convtranspose_bn_relu, ...), so a reference state dict loads into them
as it is.  BatchNorm is ``BatchNorm2d``: ``nn.BatchNorm2d``'s state-dict
names and eval mode (running statistics), with Flax ``nn.BatchNorm``'s
train-mode statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv(in_ch, out_ch, kernel, stride=1, padding=0, bias=False):
    """torch nn.Conv2d (the Flax side's ``Conv``)."""
    return nn.Conv2d(in_ch, out_ch, kernel, stride, padding, bias=bias)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode keeps Flax ``nn.BatchNorm``'s
    running statistics (dsf_tpu/models/layers.py:BatchNorm).

    Both normalize by the batch's biased variance and take the EMA
    ``(1 - momentum) * running + momentum * batch`` (momentum 0.1: Flax's
    0.9 decay).  Flax feeds that EMA the biased variance; torch feeds it
    the unbiased one, n/(n-1) times larger, with n = N*H*W.  So after
    torch's forward the running variance is corrected per channel:
    ``running -= (running - (1 - momentum) * old) / n``, which turns
    ``momentum * var_unbiased`` into ``momentum * var_biased``.  Eval mode
    is ``nn.BatchNorm2d``'s.

    ``groups`` > 1 (train mode only) treats the batch as that many stacked
    batches, as Flax's grouped BatchNorm does (dsf_tpu/models/layers.py:
    _GroupedBN): each group is normalized by its own statistics and the
    running statistics take one EMA update per group, in group order, as
    sequential calls would.  Each group is one ``F.batch_norm`` call on a
    contiguous slice of the batch; the outputs are concatenated (one copy
    of the activation, no extra statistics pass).  ``ManoOCRStage`` sets
    it for the length of a forward."""

    groups = 1

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.groups == 1:
            return self._train_forward(x)
        return torch.cat([self._train_forward(h)
                          for h in x.chunk(self.groups)])

    def _train_forward(self, x):
        # torch's EMA of the variance goes into a copy: the CPU backward
        # keeps the running variance it was given
        ema = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, ema, self.weight, self.bias,
                         training=True, momentum=self.momentum, eps=self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(
                ema - (ema - (1.0 - self.momentum) * self.running_var) / n)
            self.num_batches_tracked.add_(1)
        return y


def batch_norm(ch):
    """``BatchNorm2d(momentum=0.1, eps=1e-5)`` (Flax ``BatchNorm``)."""
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


def conv_transpose(in_ch, out_ch, kernel=4, stride=2, padding=1, bias=False):
    """torch nn.ConvTranspose2d: exact 2x upsampling for k4 s2 p1 (Flax
    ``ConvTranspose``)."""
    return nn.ConvTranspose2d(in_ch, out_ch, kernel, stride, padding,
                              bias=bias)


class ConvBNRelu(nn.Sequential):
    """ref conv_bn_relu (backbone.py:16-27): conv k, stride 1, pad 1."""

    def __init__(self, in_ch, out_ch, kernel=3):
        super().__init__(conv(in_ch, out_ch, kernel, 1, 1), batch_norm(out_ch),
                         nn.ReLU(inplace=True))


class DeconvBNRelu(nn.Sequential):
    """ref convtranspose_bn_relu (backbone.py:30-42): deconv k4 s2 p1."""

    def __init__(self, in_ch, out_ch):
        super().__init__(conv_transpose(in_ch, out_ch, 4, 2, 1),
                         batch_norm(out_ch), nn.ReLU(inplace=True))


def max_pool_3x3_s2():
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1)."""
    return nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
