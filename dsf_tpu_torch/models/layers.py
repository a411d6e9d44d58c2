"""Building blocks of the pose networks (counterpart of
dsf_tpu/models/layers.py), NCHW as the reference's torch modules are.

The blocks are the reference's own torch modules (conv_bn_relu,
convtranspose_bn_relu, ...), so a reference state dict loads into them
as it is.  BatchNorm is ``BatchNorm2d``: ``nn.BatchNorm2d``'s state-dict
names and eval mode (running statistics), with Flax ``nn.BatchNorm``'s
train-mode statistics.

The compute dtype is Flax's ``dtype=``: ``Conv2d``, ``ConvTranspose2d``
and ``Linear`` keep float32 parameters and, with ``compute_dtype``
bfloat16 (``set_compute_dtype``), cast the input and the parameters to
it, round the product and add the bias in it, as ``nn.Conv`` /
``nn.ConvTranspose`` / ``nn.Dense`` do; gradients come back float32
through the casts.  ``compute_dtype`` None (float32) is
``nn.Conv2d``'s own forward, in the input's type.  BatchNorm follows
its input's type (``BatchNorm2d``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with Flax ``nn.Conv``'s ``dtype``: ``compute_dtype``
    None computes as ``nn.Conv2d``; bfloat16 casts x, the weight and the
    bias, rounds the convolution, then adds the bias in bfloat16."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with Flax ``nn.ConvTranspose``'s ``dtype``, as
    ``Conv2d``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                               self.stride, self.padding, self.output_padding,
                               self.groups, self.dilation)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class Linear(nn.Linear):
    """``nn.Linear`` with Flax ``nn.Dense``'s ``dtype``, as ``Conv2d``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Set the compute dtype of every ``Conv2d``, ``ConvTranspose2d`` and
    ``Linear`` in ``module``: float32 computes in the input's type (no
    cast), bfloat16 as Flax's ``dtype=jnp.bfloat16``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.compute_dtype = None if dtype == torch.float32 else dtype


def conv(in_ch, out_ch, kernel, stride=1, padding=0, bias=False):
    """torch nn.Conv2d (the Flax side's ``Conv``)."""
    return Conv2d(in_ch, out_ch, kernel, stride, padding, bias=bias)


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
    it for the length of a forward.

    On a bfloat16 input (the compute dtype), the float32 parameters and
    statistics are kept and the two paths round where Flax's do:
    ``groups`` 1 (train or eval) is ``F.batch_norm``'s float32 arithmetic
    rounded once to bfloat16, as Flax ``nn.BatchNorm``'s ``_normalize``;
    ``groups`` > 1 is ``_grouped_bf16``, the arithmetic of the JAX
    package's ``_GroupedBN`` in bfloat16.

    ``sync``, an active ``parallel.mesh.Mesh`` (more than one rank), makes the
    train-mode statistics global, as the JAX package's are over a sharded
    batch (``_GroupedBN``'s ``pmean``): each group's float32 count, sum and
    sum of squares are summed over the ranks by an all-reduce that autograd
    sees, so the backward sums the statistics' gradients over the ranks
    too (``_sync_forward``).  ``ManoOCRStage`` sets it for the length of a
    forward; None (world 1) keeps the paths above.

    ``replay`` (set by ``ManoOCRStage`` while ``DSF_REMAT`` recomputes a
    checkpointed part in the backward pass) runs the train-mode forward
    with the same arithmetic but leaves the running statistics and the
    counter alone: the forward being replayed has updated them once."""

    groups = 1
    sync = None
    replay = False

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.sync is not None and self.sync.active:
            return self._sync_forward(x)
        if self.groups == 1:
            return self._train_forward(x)
        if x.dtype == torch.bfloat16:
            return self._grouped_bf16(x)
        return torch.cat([self._train_forward(h)
                          for h in x.chunk(self.groups)])

    def _grouped_bf16(self, x):
        """dsf_tpu/models/layers.py:_GroupedBN on a bfloat16 x: float32
        statistics per group (the fast variance E[x^2] - E[x]^2), then
        ``(x - mean) * mul + bias`` in bfloat16 with mean, ``mul =
        rsqrt(var + eps) * weight`` and bias rounded to bfloat16; the
        running statistics take Flax's EMA of the biased variance, one
        update per group in group order."""
        g, dt = self.groups, x.dtype
        xf = x.float().unflatten(0, (g, -1))
        mean = xf.mean((1, 3, 4))                                  # (g, C)
        var = (xf * xf).mean((1, 3, 4)) - mean * mean
        mul = torch.rsqrt(var + self.eps) * self.weight
        self._update_stats(mean, var)
        y = ((x.unflatten(0, (g, -1)) - mean.to(dt)[:, None, :, None, None])
             * mul.to(dt)[:, None, :, None, None]
             + self.bias.to(dt)[:, None, None])
        return y.flatten(0, 1)

    def _sync_forward(self, x):
        """Train mode with statistics over every rank's rows: per group the
        float32 (sum, sum of squares, count) all-reduced over
        ``sync.group``, then the fast variance E[x^2] - E[x]^2 (Flax's),
        Flax's EMA of the global biased variance, one update per group in
        group order, and the normalization at the one-rank paths' rounding
        points: float32 throughout for a float32 x; for a bfloat16 x with
        one group float32 rounded once (Flax ``nn.BatchNorm``), with more
        ``_grouped_bf16``'s bfloat16 arithmetic."""
        from torch.distributed.nn.functional import all_reduce
        g, dt, C = self.groups, x.dtype, x.shape[1]
        xf = x.float().unflatten(0, (g, -1))                   # (g, b, C, H, W)
        count = torch.full((g, 1), float(xf[0, :, 0].numel()),
                           dtype=torch.float32, device=x.device)
        sums = all_reduce(torch.cat([xf.sum((1, 3, 4)),
                                     (xf * xf).sum((1, 3, 4)), count], 1),
                          group=self.sync.group)
        n = sums[:, 2 * C:]
        mean = sums[:, :C] / n                                     # (g, C)
        var = sums[:, C:2 * C] / n - mean * mean
        mul = torch.rsqrt(var + self.eps) * self.weight
        self._update_stats(mean, var)
        bc = lambda t: t[:, None, :, None, None]
        if dt == torch.bfloat16 and g > 1:
            y = ((x.unflatten(0, (g, -1)) - bc(mean.to(dt))) * bc(mul.to(dt))
                 + self.bias.to(dt)[:, None, None])
        else:
            y = ((xf - bc(mean)) * bc(mul)
                 + self.bias[:, None, None]).to(dt)
        return y.flatten(0, 1)

    def _update_stats(self, mean, var):
        """Flax's EMA of each group's (g, C) mean and biased variance, one
        update per group in group order; nothing in a replay."""
        if self.replay:
            return
        with torch.no_grad():
            m = self.momentum
            for i in range(mean.shape[0]):
                self.running_mean.mul_(1.0 - m).add_(m * mean[i])
                self.running_var.mul_(1.0 - m).add_(m * var[i])
            self.num_batches_tracked.add_(mean.shape[0])

    def _train_forward(self, x):
        # torch's EMA of the variance goes into a copy: the CPU backward
        # keeps the running variance it was given
        ema = self.running_var.clone()
        # a replay updates copies of both (the same kernel runs)
        mean = self.running_mean.clone() if self.replay else self.running_mean
        y = F.batch_norm(x, mean, ema, self.weight, self.bias,
                         training=True, momentum=self.momentum, eps=self.eps)
        if self.replay:
            return y
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
    return ConvTranspose2d(in_ch, out_ch, kernel, stride, padding, bias=bias)


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
