"""Dual-branch pose networks (counterpart of dsf_tpu/models/backbone.py;
ref: model/backbone.py:94-343).

``ManoOCRStage`` is the default net: a ResNet-18 trunk with two heads per
stage — a MANO parameter regressor (62-D) and a 3-deconv dense decoder
emitting a 4J-channel offset feature at input/2.  With ``refine=True``
stage 2 re-renders the stage-1 MANO prediction inside the forward,
re-encodes it with the offset codec, fuses it with stage-1 features and
runs a second trunk and heads.

Submodules carry the reference MANO_OCR_stage state-dict names (pre.{0,1},
layer{1..4}[_s2], mano_regress[_s2].2, deconv_layer{4,3,2}[_s2].{0,1},
finals[_s2].{0,1}, fusion.{0,1}), so a reference ``.pth`` loads with
``load_state_dict`` as it is.  Activations are NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from dsf_tpu_torch.models.layers import (ConvBNRelu, DeconvBNRelu,
                                         batch_norm, conv, max_pool_3x3_s2)
from dsf_tpu_torch.models.resnet import RESNET_SPECS, res_layer
from dsf_tpu_torch.ops.offset_codec import joint2offset
from dsf_tpu_torch.render import renderer as rnd

MANO_PARAM_DIM = 3 + 45 + 10 + 4


class ManoOCRStage(nn.Module):
    """Dual-branch two-stage net (ref: MANO_OCR_stage, backbone.py:188-323).

    ``forward(img, render, center, cube)`` -> [[img_result, mano_para]]
    per stage: img_result (B, 4J, S/2, S/2), mano_para (B, 62)."""

    def __init__(self, joint_num: int = 21, depth: int = 18,
                 refine: bool = True):
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
            nn.Linear(feat_in, MANO_PARAM_DIM)))
        # Flax heads[_s2]/deconv4, deconv3, deconv2
        setattr(self, f"deconv_layer4{suffix}", DeconvBNRelu(feat_in, 256))
        setattr(self, f"deconv_layer3{suffix}", DeconvBNRelu(256, 256))
        setattr(self, f"deconv_layer2{suffix}", DeconvBNRelu(256, 256))
        # Flax heads[_s2]/final_offset, final_heat
        setattr(self, f"finals{suffix}", nn.ModuleList([
            conv(256, 3 * J, 1, 1, 0, bias=True),
            conv(256, J, 1, 1, 0, bias=True)]))

    def _trunk(self, x, suffix):
        for i in range(1, 5):
            x = getattr(self, f"layer{i}{suffix}")(x)
        return x

    def _heads(self, c4, suffix):
        mano_para = getattr(self, f"mano_regress{suffix}")(c4)
        x = getattr(self, f"deconv_layer4{suffix}")(c4)
        x = getattr(self, f"deconv_layer3{suffix}")(x)
        feat = getattr(self, f"deconv_layer2{suffix}")(x)
        finals = getattr(self, f"finals{suffix}")
        img_result = torch.cat([finals[0](feat), finals[1](feat)], dim=1)
        return img_result, mano_para, feat

    def forward(self, img, render: rnd.Renderer = None, center=None,
                cube=None):
        c0 = self.pre(img)
        c4 = self._trunk(c0, "")
        img_result, mano_para, img_feature = self._heads(c4, "")
        if not self.refine:
            return [[img_result, mano_para]]

        # stage 2: re-render the stage-1 MANO inside the forward, directly
        # at the decoder resolution (img_stride=2: the remap codec would
        # nearest-downsample a full render to that size anyway)
        mano_img, mano_joint_uvd, _, _ = rnd.render_params(
            render, mano_para, center, cube, img_stride=2)
        remap = joint2offset(mano_joint_uvd, mano_img, 0.8,
                             img_result.shape[-1])
        fusion = torch.cat([c0, img_feature, img_result,
                            remap.to(img_result.dtype)], dim=1)
        x = self.fusion(fusion)
        c4_s2 = self._trunk(x, "_s2")
        img_result_s2, mano_para_s2, _ = self._heads(c4_s2, "_s2")
        return [[img_result, mano_para], [img_result_s2, mano_para_s2]]


class ManoOCR(ManoOCRStage):
    """Single-stage variant (ref: MANO_OCR, backbone.py:94-185)."""

    def __init__(self, joint_num: int = 21, depth: int = 18):
        super().__init__(joint_num, depth, refine=False)
