"""Training phases as loss functions (counterpart of
dsf_tpu/training/phases.py; ref: train_render.py:415-488, 826-864).

Ported so far: the Pretrain phase, the synth-only supervised one, as
``pretrain_sample`` (the synth batch) and ``pretrain_loss`` (the net and
the losses on it).  The net is an ``nn.Module`` in train mode, so its
BatchNorm running statistics update in the forward.

Random draws come in as tensors (``PretrainDraws``): ``draw_pretrain``
makes them from an explicit ``torch.Generator`` with the distributions of
the JAX package's ``_aug_keys`` and ``synth_sample``, and the parity tests
hand in the values ``jax.random`` drew from the same key splits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.losses.basic import smooth_l1
from dsf_tpu_torch.ops.offset_codec import joint2offset, offset2joint_softmax
from dsf_tpu_torch.render import renderer as rnd


def xyz2error_mm(pd_nl, gt_nl, center, cube):
    """Mean 3D error in mm between normalized predictions and GT (ref:
    Trainer.xyz2error)."""
    pd = pd_nl * cube[:, None] / 2.0 + center[:, None]
    gt = gt_nl * cube[:, None] / 2.0 + center[:, None]
    return torch.sqrt(((pd - gt) ** 2).sum(-1) + 1e-12).mean()


@dataclasses.dataclass(frozen=True)
class PretrainDraws:
    """The random draws of one Pretrain step (ref: _aug_keys and the
    synth factory): shape (B, 10) added to the MANO shape, center (B, 3)
    mm added to the crop centre, size (B, 1) scaling the cube, depth_z
    (B, 1) mm the hand's placement depth, and the sphere-occlusion draws
    (None without occlusion)."""
    shape: torch.Tensor
    center: torch.Tensor
    size: torch.Tensor
    depth_z: torch.Tensor
    mask: Optional[rnd.MaskDraws]

    def to(self, device) -> "PretrainDraws":
        return PretrainDraws(
            self.shape.to(device), self.center.to(device),
            self.size.to(device), self.depth_z.to(device),
            None if self.mask is None else self.mask.to(device))


def draw_pretrain(gen: torch.Generator, batch: int, depth_range,
                  mask: bool = True) -> PretrainDraws:
    """Draws for one Pretrain step on the CPU from ``gen``: shape ~ N(0, 3),
    center ~ U(-20, 20) mm, size ~ U(0.8, 1.2), depth_z ~ U(depth_range)."""
    shape = torch.randn(batch, 10, generator=gen) * 3.0
    center = (torch.rand(batch, 3, generator=gen) - 0.5) * 40.0
    size = 1.0 + (torch.rand(batch, 1, generator=gen) - 0.5) * 0.4
    lo, hi = depth_range
    depth_z = lo + torch.rand(batch, 1, generator=gen) * (hi - lo)
    mask_draws = rnd.draw_mask(gen, batch, 21) if mask else None
    return PretrainDraws(shape, center, size, depth_z, mask_draws)


def pretrain_sample(r: rnd.Renderer, draws: PretrainDraws, model_para,
                    cube) -> tuple:
    """The Pretrain phase's synth batch (ref: train_render.py:417-434):
    ``synth_sample`` of ``model_para`` (B, 62) and ``cube`` (B, 3) with the
    draws, no view augmentation (zero rotation, as the reference's
    pretrain) and the sphere occlusion when the draws hold one.  Returns (img,
    joint_uvd, verts_uvd, joint_xyz, verts_xyz, center, cube, M)."""
    B = model_para.shape[0]
    aug_view = torch.zeros(B, 3, dtype=model_para.dtype,
                           device=model_para.device)
    return rnd.synth_sample(
        r, model_para, cube, depth_z=draws.depth_z, augment_view=aug_view,
        augment_shape=draws.shape, augment_center=draws.center,
        augment_size=draws.size, mask=draws.mask)


def pretrain_loss(net, r: rnd.Renderer, sample: tuple, cfg, stage_num: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The Pretrain phase's losses (ref: train_render.py:435-488) on a synth
    batch from ``pretrain_sample``: run the net on it (train mode:
    BatchNorm statistics update) and sum per stage the codec SmoothL1
    terms, the MANO joint / vertex SmoothL1 terms, the shape prior and the
    scale penalty.  Returns (loss, metrics)."""
    img, juvd_gt, _, jxyz_gt, vxyz_gt, center, cube_s, M = sample
    # the losses run in the net's type: float32 (the JAX package's _apply
    # casts its bfloat16 outputs to float32; the port trains float32 only)
    outputs = net(img, r, center, cube_s)

    loss = 0.0
    metrics = {}
    for idx in range(stage_num):
        pixel_pd, para_pd = outputs[idx]
        fs = pixel_pd.shape[-1]
        pixel_gt = joint2offset(juvd_gt, img, cfg.feature_para[0], fs)
        juvd_pd = offset2joint_softmax(pixel_pd, img, cfg.feature_para[0])
        jxyz_pd = geo.uvd_nl_to_xyz_nl(juvd_pd, center, M, cube_s, r.paras,
                                       cfg.input_size, r.flip)
        loss = loss + smooth_l1(pixel_pd, pixel_gt) * cfg.deconv_weight
        loss = loss + smooth_l1(juvd_pd, juvd_gt) * cfg.coord_weight

        mano_jxyz, mano_mesh = rnd.get_mesh_xyz(r, para_pd)
        joint_loss = smooth_l1(mano_jxyz, jxyz_gt) * cfg.coord_weight
        verts_loss = smooth_l1(mano_mesh, vxyz_gt) * cfg.coord_weight
        beta_loss = torch.mean(para_pd[:, 48:58] ** 2) * cfg.coord_weight * 10.0
        scale_loss = torch.mean(torch.abs(torch.clamp_max(para_pd[:, 58],
                                                          0.0))) * 0.1
        loss = loss + beta_loss + verts_loss + joint_loss + scale_loss

        with torch.no_grad():
            metrics[f"pixel_error_{idx}"] = xyz2error_mm(jxyz_pd, jxyz_gt,
                                                         center, cube_s)
            metrics[f"mano_error_{idx}"] = xyz2error_mm(mano_jxyz, jxyz_gt,
                                                        center, cube_s)
        metrics[f"scale_loss_{idx}"] = scale_loss.detach()
    return loss, metrics
