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

The generator trains as it is (``training/cyclegan_trainer.py``): on a
GPU its head's gradient goes through ``tapsum_kernel.TailConvFn``'s
backward (autograd of the plain version).  The rest of the CycleGAN zoo
follows the JAX module, float32 only: ``NLayerDiscriminator`` (the
PatchGAN the trainer uses) and ``gan_loss``; ``ResnetEncoder`` and
``ResnetDecoder`` (the generator's two halves, the decoder's head K9
too), ``UnetGenerator``, ``PixelDiscriminator`` and
``gradient_penalty``.  ``models/weights.py`` carries each one's weights
from and to the JAX package's trees.
"""

from __future__ import annotations

import torch
from torch import nn

import torch.nn.functional as F

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


def _encoder_layers(input_nc, ngf, n_blocks):
    """The generator's stem, two stride-2 convs and resnet blocks."""
    layers = [nn.ReflectionPad2d(3), Conv2d(input_nc, ngf, 7),
              InstanceNorm(ngf), nn.ReLU()]
    for i in range(2):                              # downsampling
        ch = ngf * 2 ** i
        layers += [Conv2d(ch, 2 * ch, 3, stride=2, padding=1),
                   InstanceNorm(2 * ch), nn.ReLU()]
    return layers + [ResnetBlock(ngf * 4) for _ in range(n_blocks)]


def _decoder_layers(output_nc, ngf):
    """The generator's two transposed convs and its head."""
    layers = []
    for i in range(2):                              # upsampling
        ch = ngf * 2 ** (2 - i)
        layers += [ConvTranspose2d(ch, ch // 2, 3, stride=2, padding=1,
                                   output_padding=1),
                   InstanceNorm(ch // 2), nn.ReLU()]
    return layers + [nn.ReflectionPad2d(3), TailConvTanh(ngf, output_nc)]


class ResnetGenerator(nn.Module):
    """(B, input_nc, H, W) -> (B, output_nc, H, W) in [-1, 1]; H and W
    multiples of 4.  Only ``output_nc=1`` (the transfer net's) is
    supported: its head is the C -> 1 tail conv.  ``dtype``: the compute
    dtype (module docstring)."""

    def __init__(self, input_nc=1, output_nc=1, ngf=64, n_blocks=9,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model = nn.Sequential(*_encoder_layers(input_nc, ngf, n_blocks),
                                   *_decoder_layers(output_nc, ngf))
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


class NLayerDiscriminator(nn.Module):
    """The PatchGAN discriminator (ref: transfer.py:709-754; JAX
    ``NLayerDiscriminator``): a 4x4 stride-2 conv and LeakyReLU(0.2), then
    ``n_layers - 1`` 4x4 stride-2 convs and one stride-1, each + IN +
    LeakyReLU(0.2), then a 4x4 stride-1 conv to one channel; padding 1 and
    a bias everywhere.  A 128^2 input gives (B, 1, 14, 14).  The
    submodules carry the pix2pix ``Sequential``'s indices (model.0, .2,
    .5, .8 and the head .11 for 3 layers)."""

    def __init__(self, input_nc=1, ndf=64, n_layers=3):
        super().__init__()
        layers = [Conv2d(input_nc, ndf, 4, stride=2, padding=1),
                  nn.LeakyReLU(0.2)]
        mult = 1
        for i in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** i, 8)
            layers += [Conv2d(ndf * prev, ndf * mult, 4,
                              stride=2 if i < n_layers else 1, padding=1),
                       InstanceNorm(ndf * mult), nn.LeakyReLU(0.2)]
        layers.append(Conv2d(ndf * mult, 1, 4, stride=1, padding=1))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


def gan_loss(pred, target_is_real: bool, mode: str = "lsgan"):
    """GANLoss (ref: transfer.py:287-354): ``lsgan`` is the mean squared
    distance to the 1 (real) or 0 (fake) label, ``vanilla`` the mean
    binary cross-entropy of the logits; any other mode raises
    ValueError."""
    target = torch.ones_like(pred) if target_is_real else torch.zeros_like(pred)
    if mode == "lsgan":
        return torch.mean((pred - target) ** 2)
    if mode == "vanilla":
        return torch.mean(torch.clamp(pred, min=0) - pred * target
                          + torch.log1p(torch.exp(-pred.abs())))
    raise ValueError(mode)


class ResnetEncoder(nn.Module):
    """The generator's stem, downsampling and resnet blocks (ref:
    transfer.py:451-498): (B, input_nc, H, W) -> (B, 4 ngf, H/4, W/4),
    under the generator's indices (model.1, .4, .7, blocks from
    model.10)."""

    def __init__(self, input_nc=1, ngf=64, n_blocks=6):
        super().__init__()
        self.model = nn.Sequential(*_encoder_layers(input_nc, ngf, n_blocks))

    def forward(self, x):
        return self.model(x)


class ResnetDecoder(nn.Module):
    """The generator's upsampling and head (ref: transfer.py:501-544):
    (B, 4 ngf, h, w) -> (B, 1, 4h, 4w) in [-1, 1]; the head is
    ``TailConvTanh`` (K9 on a GPU).  Indices: model.0 and .3 the
    transposed convs, model.7 the head."""

    def __init__(self, output_nc=1, ngf=64):
        super().__init__()
        self.model = nn.Sequential(*_decoder_layers(output_nc, ngf))

    def forward(self, x):
        return self.model(x)


class UnetGenerator(nn.Module):
    """The U-Net generator (ref: transfer.py:607-706; JAX
    ``UnetGenerator``): ``num_downs`` 4x4 stride-2 convs (``downs``; a
    LeakyReLU(0.2) before each but the first, IN after each but the
    innermost), then per level up a ReLU, a 4x4 stride-2 transposed conv
    (``ups``), IN and the skip concatenated before it, and a ReLU, the
    transposed conv ``head`` and tanh.  H and W multiples of
    2^num_downs."""

    def __init__(self, input_nc=1, output_nc=1, num_downs=7, ngf=64):
        super().__init__()
        chans = [min(ngf * 2 ** i, ngf * 8) for i in range(num_downs)]
        self.downs = nn.ModuleList(
            Conv2d(c_in, c, 4, stride=2, padding=1)
            for c_in, c in zip([input_nc] + chans[:-1], chans))
        self.down_norms = nn.ModuleList(InstanceNorm(c) for c in chans[:-1])
        ups = chans[-2::-1]
        self.ups = nn.ModuleList(
            ConvTranspose2d(c_in, c, 4, stride=2, padding=1)
            for c_in, c in zip([chans[-1]] + [2 * c for c in ups[:-1]], ups))
        self.up_norms = nn.ModuleList(InstanceNorm(c) for c in ups)
        self.head = ConvTranspose2d(2 * chans[0], output_nc, 4, stride=2,
                                    padding=1)

    def forward(self, x):
        skips, h = [], x
        for i, down in enumerate(self.downs):
            h = down(F.leaky_relu(h, 0.2) if i else h)
            if i < len(self.down_norms):
                h = self.down_norms[i](h)
            skips.append(h)
        h = skips.pop()
        for up, norm in zip(self.ups, self.up_norms):
            h = torch.cat([skips.pop(), norm(up(F.relu(h)))], dim=1)
        return torch.tanh(self.head(F.relu(h)))


class PixelDiscriminator(nn.Module):
    """The 1x1 PatchGAN (ref: transfer.py:757-786): 1x1 convs to ndf
    (LeakyReLU(0.2)), to 2 ndf (IN, LeakyReLU(0.2)) and to one channel,
    with biases; pix2pix's indices net.0, .2, .5."""

    def __init__(self, input_nc=1, ndf=64):
        super().__init__()
        self.net = nn.Sequential(
            Conv2d(input_nc, ndf, 1), nn.LeakyReLU(0.2),
            Conv2d(ndf, 2 * ndf, 1), InstanceNorm(2 * ndf), nn.LeakyReLU(0.2),
            Conv2d(2 * ndf, 1, 1))

    def forward(self, x):
        return self.net(x)


def gradient_penalty(alpha, disc, real, fake, mode: str = "mixed",
                     constant: float = 1.0):
    """The WGAN-GP penalty (ref: cal_gradient_penalty, transfer.py:356-390;
    JAX ``gradient_penalty``): mean over the batch of (|d disc(x).sum() /
    dx| - constant)^2 at x = ``real`` ("real"), ``fake`` ("fake"), or else
    ``alpha * real + (1 - alpha) * fake`` with ``alpha`` (B, 1, 1, 1) in
    place of the JAX function's key.  The result is differentiable in
    ``disc``'s parameters (the input gradient keeps its graph)."""
    if mode == "real":
        interp = real
    elif mode == "fake":
        interp = fake
    else:
        interp = alpha * real + (1 - alpha) * fake
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_(True)
    grads, = torch.autograd.grad(disc(interp).sum(), interp, create_graph=True)
    gnorm = torch.sqrt(torch.sum(grads.reshape(grads.shape[0], -1) ** 2,
                                 dim=1) + 1e-16)
    return torch.mean((gnorm - constant) ** 2)
