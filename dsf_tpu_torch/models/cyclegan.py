"""The Consis-CycleGAN generator, the frozen domain-transfer net of the
training steps (counterpart of dsf_tpu/models/cyclegan.py's
``ResnetGenerator``; ref: render_model/transfer.py:393-449, define_G
'resnet_9blocks' with instance norm).

NCHW.  The submodules carry the reference pix2pix ``Sequential``'s
indices (dsf_tpu/models/torch_import.py:45-75), so a reference
``latest_net_G_A.pth`` loads with ``load_state_dict``:

  model.0 reflect pad 3     model.1 7x7 stem        model.2-3 IN, ReLU
  model.4 / model.7 3x3 stride-2 convs (zero pad 1), each + IN, ReLU
  model.10 .. model.(9+n) ResnetBlocks, convs conv_block.1 and .5
  model.(10+n) / (13+n) ConvTranspose2d(k3, s2, p1, output_padding 1),
    each + IN, ReLU
  model.(16+n) reflect pad 3  model.(17+n) 7x7 head + tanh (K9)

(n = 9 blocks: the head is model.26.)  IN is instance norm without an
affine part: biased variance, eps 1e-5 inside the square root.  Every
conv has a bias.  The head is ``TailConvTanh``: the reference's head conv
and its Tanh in one module, through ``ops.tapsum.tail_conv_tanh`` (the
plain version on the CPU, the K9 kernel on a GPU).

``dtype`` is the compute dtype, as the JAX generator's ``dtype=``: with
bfloat16 the parameters stay float32, the convolutions compute in
bfloat16 (``layers.set_compute_dtype``), the instance norms round where
the JAX package's ``_instance_norm`` does, the head is K9's bfloat16
variant and the image is bfloat16.
"""

from __future__ import annotations

import torch
from torch import nn

from dsf_tpu_torch.models.layers import (Conv2d, ConvTranspose2d,
                                         set_compute_dtype)
from dsf_tpu_torch.models.weights import load_into
from dsf_tpu_torch.ops.tapsum import tail_conv_tanh


class InstanceNorm(nn.InstanceNorm2d):
    """InstanceNorm2d without an affine part (biased variance, eps 1e-5
    inside the square root).  A float32 input takes ``nn.InstanceNorm2d``,
    which normalizes in float32 and rounds once, so the float32 generator
    runs the program it ran before the compute dtype (the explicit ops
    below would hold its tests too).  A bfloat16 input takes
    the JAX package's ``_instance_norm`` (dsf_tpu/models/cyclegan.py:31-35)
    in bfloat16: the mean and the variance reduced in float32 and rounded
    to bfloat16, then the subtraction, the square root and the division in
    bfloat16."""

    def __init__(self, ch):
        super().__init__(ch, affine=False, track_running_stats=False,
                         eps=1e-5)

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        mean = x.mean((2, 3), keepdim=True)
        var = x.var((2, 3), keepdim=True, unbiased=False)
        return (x - mean) / torch.sqrt(var + self.eps)


class TailConvTanh(Conv2d):
    """The 7x7 C -> 1 head conv with its bias, then tanh, on an input the
    caller has already reflect-padded (``nn.Conv2d``'s parameters, so the
    reference's head loads into it); with a compute dtype, x, the weight
    and the bias are cast to it first (K9's bfloat16 variant)."""

    def __init__(self, in_ch, out_ch=1, kernel=7):
        if out_ch != 1:
            raise ValueError("the tail conv has one output channel")
        super().__init__(in_ch, out_ch, kernel)

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return tail_conv_tanh(x, self.weight, self.bias)
        return tail_conv_tanh(x.to(dt), self.weight.to(dt),
                              self.bias.to(dt))


class ResnetBlock(nn.Module):
    """x + (reflect pad 1, 3x3 conv, IN, ReLU, reflect pad 1, 3x3 conv,
    IN)(x) (ref: transfer.py:547-604)."""

    def __init__(self, dim):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), Conv2d(dim, dim, 3), InstanceNorm(dim),
            nn.ReLU(), nn.ReflectionPad2d(1), Conv2d(dim, dim, 3),
            InstanceNorm(dim))

    def forward(self, x):
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    """(B, input_nc, H, W) -> (B, output_nc, H, W) in [-1, 1]; H and W
    multiples of 4.  Only ``output_nc=1`` (the transfer net's) is
    supported: its head is the C -> 1 tail conv.  ``dtype``: the compute
    dtype (module docstring)."""

    def __init__(self, input_nc=1, output_nc=1, ngf=64, n_blocks=9,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        layers = [nn.ReflectionPad2d(3), Conv2d(input_nc, ngf, 7),
                  InstanceNorm(ngf), nn.ReLU()]
        for i in range(2):                          # downsampling
            ch = ngf * 2 ** i
            layers += [Conv2d(ch, 2 * ch, 3, stride=2, padding=1),
                       InstanceNorm(2 * ch), nn.ReLU()]
        layers += [ResnetBlock(ngf * 4) for _ in range(n_blocks)]
        for i in range(2):                          # upsampling
            ch = ngf * 2 ** (2 - i)
            layers += [ConvTranspose2d(ch, ch // 2, 3, stride=2, padding=1,
                                       output_padding=1),
                       InstanceNorm(ch // 2), nn.ReLU()]
        layers += [nn.ReflectionPad2d(3), TailConvTanh(ngf, output_nc)]
        self.model = nn.Sequential(*layers)
        set_compute_dtype(self, dtype)

    @classmethod
    def from_state_dict(cls, sd, dtype: torch.dtype = torch.float32):
        """A generator shaped by a reference-layout state dict (its width
        from the stem, its depth from the blocks), with the dict loaded."""
        n_blocks = sum(1 for k in sd if k.endswith("conv_block.1.weight"))
        gen = cls(ngf=int(sd["model.1.weight"].shape[0]), n_blocks=n_blocks,
                  dtype=dtype)
        load_into(gen, sd)
        return gen

    def forward(self, x):
        return self.model(x)
