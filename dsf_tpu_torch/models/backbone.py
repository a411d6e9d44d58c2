"""Dual-branch pose networks (counterpart of dsf_tpu/models/backbone.py;
ref: model/backbone.py:94-343).

``ManoOCRStage`` is the default net: a ResNet trunk (depth 18, 50, 101 or
152, ``RESNET_SPECS``) with two heads per stage — a MANO parameter
regressor (62-D) and a 3-deconv dense decoder emitting a 4J-channel
offset feature at input/2.  With ``refine=True``
stage 2 re-renders the stage-1 MANO prediction inside the forward,
re-encodes it with the offset codec, fuses it with stage-1 features and
runs a second trunk and heads.

Submodules carry the reference MANO_OCR_stage state-dict names (pre.{0,1},
layer{1..4}[_s2], mano_regress[_s2].2, deconv_layer{4,3,2}[_s2].{0,1},
finals[_s2].{0,1}, fusion.{0,1}), so a reference ``.pth`` loads with
``load_state_dict`` as it is.  Activations are NCHW.

``DSF_REMAT=1`` in the environment (the JAX package's switch, read at each
forward as its ``_maybe_remat`` reads it) rematerializes each stage's
trunk and heads: while autograd records, they run under
``torch.utils.checkpoint`` and their activations are recomputed in the
backward pass instead of kept.  Outputs, running statistics and gradients
are those of ``DSF_REMAT=0`` bitwise (``_replay``).

Under ``n_fsdp`` > 1 the trainer shards the parameters over
``fsdp_units`` (``parallel.fsdp``): each unit is gathered whole for its
forward and again for its backward, its recompute included.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dsf_tpu_torch.device import widen
from dsf_tpu_torch.models.layers import (BatchNorm2d, ConvBNRelu,
                                         DeconvBNRelu, Linear, batch_norm,
                                         conv, max_pool_3x3_s2,
                                         set_compute_dtype)
from dsf_tpu_torch.models.resnet import RESNET_SPECS, res_layer
from dsf_tpu_torch.ops.offset_codec import joint2offset
from dsf_tpu_torch.render import renderer as rnd

MANO_PARAM_DIM = 3 + 45 + 10 + 4

# the backend switches that change float results, kept by a forward for its
# recompute
_FLOAT_FLAGS = ((torch.backends.cudnn, "allow_tf32"),
                (torch.backends.cudnn, "benchmark"),
                (torch.backends.cudnn, "deterministic"),
                (torch.backends.cuda.matmul, "allow_tf32"),
                (torch.backends.cuda.matmul,
                 "allow_bf16_reduced_precision_reduction"))


def remat_enabled() -> bool:
    """``DSF_REMAT=1``: rematerialize the trunks and heads."""
    return os.environ.get("DSF_REMAT", "0") == "1"


@contextlib.contextmanager
def _replay(bns, groups, sync, flags):
    """The recompute of a checkpointed part in the backward pass, as its
    forward ran: every BatchNorm with the forward's ``groups`` and ``sync``
    (the net's forward has cleared ``sync`` by then, and a later forward
    may have changed ``groups``) and ``replay`` set, so its train-mode
    statistics are not taken into the running ones a second time; the
    backend switches that change float results as the forward had them.
    Everything is put back after."""
    saved = [(m.groups, m.sync, m.replay) for m in bns]
    saved_flags = [getattr(mod, name) for mod, name in _FLOAT_FLAGS]
    for m in bns:
        m.groups, m.sync, m.replay = groups, sync, True
    for (mod, name), v in zip(_FLOAT_FLAGS, flags):
        setattr(mod, name, v)
    try:
        yield
    finally:
        for m, (g, s, r) in zip(bns, saved):
            m.groups, m.sync, m.replay = g, s, r
        for (mod, name), v in zip(_FLOAT_FLAGS, saved_flags):
            setattr(mod, name, v)


class ManoOCRStage(nn.Module):
    """Dual-branch two-stage net (ref: MANO_OCR_stage, backbone.py:188-323).

    ``forward(img, render, center, cube, bn_groups=1)`` ->
    [[img_result, mano_para]] per stage: img_result (B, 4J, S/2, S/2),
    mano_para (B, 62).  ``bn_groups`` > 1 runs that many stacked batches
    (the self-supervised phases' [synth | real]) as one forward whose
    train-mode BatchNorms keep statistics per group (``BatchNorm2d.groups``):
    the same parameters and buffers, the stage-2 render once for all.

    ``dtype`` is the compute dtype (Flax's ``dtype=``, ``set_compute_dtype``):
    with bfloat16 the parameters and BatchNorm statistics stay float32,
    every layer computes in bfloat16 and both stages' outputs are bfloat16,
    as the JAX package's; the stage-2 render and its remap stay float32
    (the remap is cast to bfloat16 for the fusion).

    ``sync`` (a ``parallel.mesh.Mesh``, set by the trainer of a world of
    more than one rank) is handed to every BatchNorm for the length of a
    forward: in train mode their statistics are then over every rank's
    rows, group by group.

    With ``DSF_REMAT=1`` each stage's trunk and (``remat_heads``) heads
    are checkpointed while autograd records; the stage-2 render and the
    fusion are not, as in the JAX package."""

    sync = None
    remat_heads = True

    def __init__(self, joint_num: int = 21, depth: int = 18,
                 refine: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.joint_num = joint_num
        self.refine = refine
        block, layers = RESNET_SPECS[depth]
        # Flax trunk/pre_conv, trunk/pre_bn (+ relu, maxpool)
        self.pre = nn.Sequential(conv(1, 64, 5, 1, 2), batch_norm(64),
                                 nn.ReLU(inplace=True), max_pool_3x3_s2())
        # Flax trunk/layer1..4
        self._add_trunk("", block, layers, in_planes=64)
        # Flax heads/
        self._add_heads("", block)
        if refine:
            fusion_in = 64 + 256 + 4 * joint_num + 4 * joint_num
            # Flax fusion/
            self.fusion = ConvBNRelu(fusion_in, 256, 3)
            # Flax trunk_s2/layer1..4 (no stem)
            self._add_trunk("_s2", block, layers, in_planes=256)
            # Flax heads_s2/
            self._add_heads("_s2", block)
        set_compute_dtype(self, dtype)

    def _add_trunk(self, suffix, block, layers, in_planes):
        exp = block.expansion
        planes_in = (in_planes, 64 * exp, 128 * exp, 256 * exp)
        for i, (planes, stride) in enumerate(
                zip((64, 128, 256, 512), (1, 2, 2, 2))):
            setattr(self, f"layer{i + 1}{suffix}",
                    res_layer(block, planes_in[i], planes, layers[i], stride))

    def _add_heads(self, suffix, block):
        J = self.joint_num
        feat_in = 512 * block.expansion
        # Flax heads[_s2]/mano_regress (Dense at index 2, as in the reference)
        setattr(self, f"mano_regress{suffix}", nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Flatten(1),
            Linear(feat_in, MANO_PARAM_DIM)))
        # Flax heads[_s2]/deconv4, deconv3, deconv2
        setattr(self, f"deconv_layer4{suffix}", DeconvBNRelu(feat_in, 256))
        setattr(self, f"deconv_layer3{suffix}", DeconvBNRelu(256, 256))
        setattr(self, f"deconv_layer2{suffix}", DeconvBNRelu(256, 256))
        # Flax heads[_s2]/final_offset, final_heat
        setattr(self, f"finals{suffix}", nn.ModuleList([
            conv(256, 3 * J, 1, 1, 0, bias=True),
            conv(256, J, 1, 1, 0, bias=True)]))

    def fsdp_units(self):
        """The units ZeRO-3 gathers one at a time (``parallel.fsdp``), in
        the parameters' order: the stem, each ResNet block, each head
        (``mano_regress``, each deconv, each final conv), the fusion."""
        units = []
        for name, m in self.named_children():
            if name.startswith(("layer", "finals")):
                units += list(m.children())
            else:
                units.append(m)
        return units

    def _trunk(self, x, suffix):
        """Flax ``_Trunk``: the stem (stage 1) and layer1..4 -> (c0, c4)."""
        if suffix == "":
            x = self.pre(x)
        c0 = x
        for i in range(1, 5):
            x = getattr(self, f"layer{i}{suffix}")(x)
        return c0, x

    def _heads(self, c4, suffix):
        mano_para = getattr(self, f"mano_regress{suffix}")(c4)
        x = getattr(self, f"deconv_layer4{suffix}")(c4)
        x = getattr(self, f"deconv_layer3{suffix}")(x)
        feat = getattr(self, f"deconv_layer2{suffix}")(x)
        finals = getattr(self, f"finals{suffix}")
        img_result = torch.cat([finals[0](feat), finals[1](feat)], dim=1)
        return img_result, mano_para, feat

    def forward(self, img, render: rnd.Renderer = None, center=None,
                cube=None, bn_groups: int = 1):
        bns = [m for m in self.modules() if isinstance(m, BatchNorm2d)]
        for m in bns:
            m.groups, m.sync = bn_groups, self.sync
        remat = None
        if remat_enabled() and torch.is_grad_enabled():
            flags = [getattr(mod, name) for mod, name in _FLOAT_FLAGS]
            remat = lambda: (contextlib.nullcontext(),
                             _replay(bns, bn_groups, self.sync, flags))
        try:
            return self._forward(img, render, center, cube, remat)
        finally:
            for m in bns:
                m.sync = None

    @staticmethod
    def _part(remat, fn, *args):
        """``fn(*args)``, checkpointed when ``remat`` (the recompute's
        context function) is given."""
        if remat is None:
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=remat)

    def _forward(self, img, render, center, cube, remat=None):
        heads_remat = remat if self.remat_heads else None
        c0, c4 = self._part(remat, self._trunk, img, "")
        img_result, mano_para, img_feature = self._part(
            heads_remat, self._heads, c4, "")
        if not self.refine:
            return [[img_result, mano_para]]

        # stage 2: re-render the stage-1 MANO inside the forward, directly
        # at the decoder resolution (img_stride=2: the remap codec would
        # nearest-downsample a full render to that size anyway)
        mano_img, mano_joint_uvd, _, _ = rnd.render_params(
            render, widen(mano_para), center, cube, img_stride=2)
        remap = joint2offset(mano_joint_uvd, mano_img, 0.8,
                             img_result.shape[-1])
        fusion = torch.cat([c0, img_feature, img_result,
                            remap.to(img_result.dtype)], dim=1)
        x = self.fusion(fusion)
        _, c4_s2 = self._part(remat, self._trunk, x, "_s2")
        img_result_s2, mano_para_s2, _ = self._part(
            heads_remat, self._heads, c4_s2, "_s2")
        return [[img_result, mano_para], [img_result_s2, mano_para_s2]]


class ManoOCR(ManoOCRStage):
    """Single-stage variant (ref: MANO_OCR, backbone.py:94-185); its heads
    are not rematerialized, as in the JAX package."""

    remat_heads = False

    def __init__(self, joint_num: int = 21, depth: int = 18,
                 dtype: torch.dtype = torch.float32):
        super().__init__(joint_num, depth, refine=False, dtype=dtype)
