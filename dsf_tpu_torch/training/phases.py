"""Training phases as loss functions (counterpart of
dsf_tpu/training/phases.py; ref: train_render.py:415-864).

Ported:

* Pretrain, the synth-only supervised phase: ``pretrain_sample`` (the
  synth batch) and ``pretrain_loss`` (the net and the losses on it);
* Finetune, the one-stage self-supervised phase: ``finetune_stage_sample``
  (its synth batch is FinetuneStage's) and ``finetune_loss``;
* FinetuneStage, the two-stage self-supervised phase with stage 2 as the
  teacher: ``finetune_stage_sample`` and ``finetune_stage_loss``.

Both run on any dataset's camera (the renderer's): their error metrics
read the real batch's joints through the dataset's joint order
(``transfer_for_dataset(cfg.dataset)``, the JAX trainer's
``transfer_map``) with its error rules (``xyz2error_mm``'s ``dataset``:
ICVL's z bias, MSRA's mean without the wrist).

The net is an ``nn.Module`` in train mode, so its BatchNorm running
statistics update in the forward.  ``transfer`` is the frozen CycleGAN
generator's forward, or None: the net sees the transferred synth image,
and the offset codec keeps reading the raw one, as in the JAX package.
Under the bfloat16 compute dtype the net's outputs and the generator's
image are cast to float32 (``_run_net``, ``_transferred``: the JAX
package's ``_apply`` and phases.py:252, 367), so the losses, the renders
and the codec run in float32.

Random draws come in as tensors (``PretrainDraws``,
``FinetuneStageDraws``): ``draw_pretrain`` and ``draw_finetune_stage``
make them from an explicit ``torch.Generator`` with the distributions of
the JAX package's ``_aug_keys``, ``synth_sample`` and ``img_to_pcl``, and
the parity tests hand in the values ``jax.random`` drew from the same key
splits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.device import widen
from dsf_tpu_torch.losses.basic import smooth_l1
from dsf_tpu_torch.losses.icp import icp_and_joint_icp
from dsf_tpu_torch.mano import spheres as sph
from dsf_tpu_torch.mano.constants import ICVL_Z_BIAS, transfer_for_dataset
from dsf_tpu_torch.ops import cloud
from dsf_tpu_torch.ops.offset_codec import joint2offset, offset2joint_softmax
from dsf_tpu_torch.render import renderer as rnd

CLOUD_POINTS = 2048     # points per cloud of the real-image prep


def xyz2error_mm(pd_nl, gt_nl, center, cube, keep_batch=False,
                 keep_joint=False, dataset=None):
    """Mean 3D error in mm between normalized predictions and GT (ref:
    Trainer.xyz2error, train_render.py:826-864): per (sample, joint) with
    ``keep_joint``, per sample with ``keep_batch``, else the mean.  ICVL
    subtracts its per-joint z bias from the prediction (the first
    min(J, 16) joints); MSRA's mean skips the wrist."""
    pd = pd_nl * cube[:, None] / 2.0 + center[:, None]
    gt = gt_nl * cube[:, None] / 2.0 + center[:, None]
    if dataset == "icvl":
        J = pd.shape[1]
        k = min(J, 16)
        bias = torch.zeros(J, dtype=pd.dtype, device=pd.device)
        bias[:k] = torch.as_tensor(ICVL_Z_BIAS[:k], dtype=pd.dtype)
        pd = torch.cat([pd[..., :2], (pd[..., 2] - bias)[..., None]], -1)
    err = torch.sqrt(((pd - gt) ** 2).sum(-1) + 1e-12)
    if keep_joint:
        return err
    if keep_batch:
        return err.mean(-1)
    if dataset == "msra":
        return err[:, 1:].mean()
    return err.mean()


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

    def stripe(self, mesh) -> "PretrainDraws":
        """This rank's rows of a global batch's draws (``mesh.stripe``;
        the mask's sphere count and joints are the batch's)."""
        s, m = mesh.stripe, self.mask
        return PretrainDraws(
            s(self.shape), s(self.center), s(self.size), s(self.depth_z),
            None if m is None else rnd.MaskDraws(
                m.n_active, m.joint_ids, s(m.offs), s(m.radius)))


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


def _transferred(img, transfer: Optional[Callable]):
    """The net's synth input: the frozen generator's image (in float32),
    or img."""
    return img if transfer is None else widen(transfer(img))


def _run_net(net, *args, **kw):
    """The net's outputs with each stage's pair in float32 (the JAX
    package's ``_apply``: the losses run in float32 whatever the net's
    compute dtype)."""
    return [[widen(o[0]), widen(o[1])] for o in net(*args, **kw)]


def pretrain_loss(net, r: rnd.Renderer, sample: tuple, cfg, stage_num: int,
                  transfer: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The Pretrain phase's losses (ref: train_render.py:435-488) on a synth
    batch from ``pretrain_sample``: run the net on it (on its transferred
    image when ``transfer`` is given; train mode: BatchNorm statistics
    update) and sum per stage the codec SmoothL1 terms, the MANO joint /
    vertex SmoothL1 terms, the shape prior and the scale penalty.  Returns
    (loss, metrics)."""
    img, juvd_gt, _, jxyz_gt, vxyz_gt, center, cube_s, M = sample
    outputs = _run_net(net, _transferred(img, transfer), r, center, cube_s)

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


# ---------------------------------------------------------------------------
# Finetune and FinetuneStage (ref: train_render.py:490-823)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FinetuneStageDraws:
    """The random draws of one FinetuneStage step: ``synth`` the synth
    factory's (as Pretrain's), ``view`` (B, 3) the axis-angle rotation of
    each synth hand about its centre (ref: _aug_keys), ``scores``
    (2B, S^2) the uniform cloud-sampling scores of the real-image prep's
    two clouds (the joint-masked crop, then the crop)."""
    synth: PretrainDraws
    view: torch.Tensor
    scores: torch.Tensor

    def to(self, device) -> "FinetuneStageDraws":
        return FinetuneStageDraws(self.synth.to(device), self.view.to(device),
                                  self.scores.to(device))

    def stripe(self, mesh) -> "FinetuneStageDraws":
        """This rank's rows of a global batch's draws: its rows of the view
        and of each of the two clouds' scores."""
        B = len(self.view)
        return FinetuneStageDraws(
            self.synth.stripe(mesh), mesh.stripe(self.view),
            torch.cat([mesh.stripe(self.scores[:B]),
                       mesh.stripe(self.scores[B:])]))


def draw_finetune_stage(gen: torch.Generator, batch: int, depth_range,
                        crop_size: int, mask: bool = True
                        ) -> FinetuneStageDraws:
    """Draws for one FinetuneStage step on the CPU from ``gen``: Pretrain's,
    view ~ U(0, 2 pi) per axis, scores ~ U(0, 1) per pixel of 2B crops of
    crop_size^2."""
    synth = draw_pretrain(gen, batch, depth_range, mask=mask)
    view = torch.rand(batch, 3, generator=gen) * (2.0 * math.pi)
    scores = torch.rand(2 * batch, crop_size * crop_size, generator=gen)
    return FinetuneStageDraws(synth, view, scores)


def finetune_stage_sample(r: rnd.Renderer, draws: FinetuneStageDraws,
                          model_para, cube) -> tuple:
    """The FinetuneStage phase's synth batch (ref: train_render.py:628-638):
    ``synth_sample`` with the draws, the random view included.  Returns
    what ``pretrain_sample`` returns."""
    d = draws.synth
    return rnd.synth_sample(
        r, model_para, cube, depth_z=d.depth_z, augment_view=draws.view,
        augment_shape=d.shape, augment_center=d.center,
        augment_size=d.size, mask=d.mask)


def _prep_real(r: rnd.Renderer, S: int, scores, img_r, center_r, M_r,
               cube_r, joints_xyz_t, mano_joints_t, mano_mesh_t):
    """crop_hand, the pixels' part segmentation and the two 2048-point
    clouds from the teacher (ref: train_render.py:692-703) -> (crop_img,
    joint_pcl, its part labels seg, pcl).  The two cloud extractions (the
    joint-masked crop and the crop) run as one ``img_to_pcl`` at 2B.  No
    gradient: every input is the data or the detached teacher."""
    B = img_r.shape[0]
    with torch.no_grad():
        crop_img = cloud.crop_hand(img_r, mano_joints_t, center_r, M_r,
                                   cube_r, r.paras, S, flip=r.flip)
        _, pcl_img = cloud.uvd_img_to_xyz_img(crop_img, center_r, M_r, cube_r,
                                              r.paras, S, r.flip)
        pcl_img = pcl_img.reshape(B, 3, -1).transpose(1, 2)
        seg_img = sph.seg_pcl(r.mano, joints_xyz_t, mano_joints_t,
                              mano_mesh_t, pcl_img)
        fg = (crop_img < 0.99).reshape(B, -1)
        seg_img = torch.where(fg, seg_img,
                              torch.zeros_like(seg_img)).reshape(B, 1, S, S)
        joint_img = torch.where(seg_img > 0, crop_img,
                                torch.ones_like(crop_img))
        both = cloud.img_to_pcl(
            scores, torch.cat([joint_img, crop_img]),
            torch.cat([center_r, center_r]), torch.cat([M_r, M_r]),
            torch.cat([cube_r, cube_r]), r.paras, S, CLOUD_POINTS, S, r.flip)
        joint_pcl, pcl = both[:B], both[B:]
        seg = sph.seg_pcl(r.mano, joints_xyz_t, mano_joints_t, mano_mesh_t,
                          joint_pcl)
    return crop_img, joint_pcl, seg, pcl


def _m2d(crop_img, mano_img_crop, masked_numerator=True):
    """(B, 1) |depth difference| over the union of the two silhouettes,
    divided by the union's size.  FinetuneStage masks the numerator (ref
    :730-731); the one-stage Finetune divides the unmasked sum (ref :557)."""
    mask = ((crop_img < 0.99) | (mano_img_crop < 0.99)).to(crop_img.dtype)
    diff = torch.abs(crop_img - mano_img_crop)
    if masked_numerator:
        diff = diff * mask
    return diff.sum((-1, -2)) / (mask.sum((-1, -2)) + 1e-8)


def _m2p_mask(crop_img, mano_img_crop, d2m_batch, pd2m_joint, thresh=0.99,
              union_denominator=True):
    """(B, 21) bool: the M2P gate.  A sample passes when its depth
    difference over the silhouettes' intersection (pixels below
    ``thresh``), divided by their union (FinetuneStage, thresh 0.99, ref
    :785-795) or by the intersection (Finetune, thresh 0.95, ref :586-589;
    an empty one fails), is below 0.04 and its ICP distance below 1e-3; a
    joint passes when its bone's part ICP is below 1e-3 (the wrist always;
    the five tips take their last bone's)."""
    B = crop_img.shape[0]
    a, b = crop_img < thresh, mano_img_crop < thresh
    both = (a & b).to(crop_img.dtype)
    denom = (a | b).to(crop_img.dtype) if union_denominator else both
    num = (torch.abs(crop_img - mano_img_crop) * both).sum((-1, -2))
    denom_sum = denom.sum((-1, -2))
    depth_mask = num / (denom_sum + 1e-8) < 0.04
    if not union_denominator:
        depth_mask = depth_mask & (denom_sum > 0)
    depth_mask = depth_mask.squeeze(-1)
    mano_mask = depth_mask & (d2m_batch < 1e-3)                     # (B,)
    joint_mask = pd2m_joint < 1e-3                                  # (B, 15)
    joint_mask = torch.cat(
        [torch.ones_like(joint_mask[:, :1]), joint_mask,
         joint_mask[:, [2, 5, 8, 11, 14]]], dim=-1)
    return mano_mask[:, None] & joint_mask


def _masked_select_sl1(a, b, mask_joint, sync=None):
    """SmoothL1 over the masked joints only, with a fixed shape (the
    reference gathers them, train_render.py:795-801).  a, b (B, J, 3);
    mask_joint (B, J) bool.  0 when no joint is masked.

    Over the ranks of ``sync`` (a ``parallel.mesh.Mesh``) the count is the
    global one, as the JAX package's over a sharded batch: each rank
    returns world x its sum over the global count, so the ranks' mean (the
    averaged gradient, the logged mean) is the global masked mean."""
    z = a - b
    az = torch.abs(z)
    val = torch.where(az < 0.01, 0.5 * z * z, 0.01 * (az - 0.005))
    per_joint = val.mean(-1)
    m = mask_joint.to(per_joint.dtype)
    n = m.sum()
    total = (per_joint * m).sum()
    if sync is not None and sync.active:
        n = n.detach().clone()
        dist.all_reduce(n, group=sync.group)
        total = total * sync.world
    return torch.where(n == 0, torch.zeros_like(n),
                       total / torch.clamp_min(n, 1.0))


def finetune_loss(net, r: rnd.Renderer, sample: tuple, scores, img_r,
                  center_r, cube_r, M_r, xyz_gt_r, cfg,
                  transfer: Optional[Callable] = None, sync=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The one-stage Finetune phase's losses (ref: train_render.py:490-619)
    on the synth batch from ``finetune_stage_sample`` and a real batch, as
    ``finetune_stage_loss`` takes them, for a one-stage net
    (``ManoOCRStage(refine=False)``).

    The reference's two net calls run as one stacked [synth | real]
    forward with per-group BatchNorm statistics, as in the JAX package.
    Synth: the codec, MANO joint and vertex SmoothL1 terms and the
    collision.  Real, from the student's own detached predictions: the
    loss render, the real-image prep, the crop of the rendered image with
    its own MANO joints, one ICP over the 2B clouds, P2M, M2P (gated on
    the uncropped render), m2d (unmasked numerator) and the collision.
    ``sync`` is the trainer's mesh of ranks (None at world 1): the M2P
    term's joint count is then global (``_masked_select_sl1``).
    Returns (loss, metrics)."""
    img, juvd_gt, _, jxyz_gt, vxyz_gt, center_s, cube_s, _ = sample
    B = img.shape[0]
    S = cfg.input_size
    fp = cfg.feature_para[0]

    out = _run_net(net, torch.cat([_transferred(img, transfer), img_r]), r,
                   torch.cat([center_s, center_r]),
                   torch.cat([cube_s, cube_r]), bn_groups=2)
    (pixel_2b, para_2b), = out
    pixel_pd, para_pd = pixel_2b[:B], para_2b[:B]
    pixel_r, para_r = pixel_2b[B:], para_2b[B:]

    # ---- synth (ref :506-514)
    pixel_gt = joint2offset(juvd_gt, img, fp, pixel_pd.shape[-1])
    juvd_pd = offset2joint_softmax(pixel_pd, img, fp)
    loss = smooth_l1(pixel_pd, pixel_gt) * cfg.deconv_weight
    loss = loss + smooth_l1(juvd_pd, juvd_gt) * cfg.coord_weight
    mano_jxyz_s, mesh_s = rnd.get_mesh_xyz(r, para_pd)
    loss = loss + smooth_l1(mano_jxyz_s, jxyz_gt) * cfg.coord_weight
    loss = loss + smooth_l1(mesh_s, vxyz_gt) * cfg.coord_weight
    loss = loss + sph.collision_loss(r.mano, mano_jxyz_s,
                                     mesh_s.detach()).mean() * cfg.coll_weight

    # ---- real (ref :517-600)
    juvd_r = offset2joint_softmax(pixel_r, img_r, fp)
    jxyz_r = geo.uvd_nl_to_xyz_nl(juvd_r, center_r, M_r, cube_r, r.paras, S,
                                  r.flip)
    mano_img_r, mano_juvd_r, mano_jxyz_r, mesh_r = rnd.render_params(
        r, para_r, center_r, cube_r)
    coll = sph.collision_loss(r.mano, mano_jxyz_r, mesh_r.detach()).mean()
    crop_img, joint_pcl, seg, pcl = _prep_real(
        r, S, scores, img_r, center_r, M_r, cube_r, jxyz_r.detach(),
        mano_jxyz_r.detach(), mesh_r.detach())
    # the one-stage phase crops its render with its own joints (ref :555)
    mano_img_crop = cloud.crop_hand(mano_img_r, mano_jxyz_r.detach(),
                                    center_r, M_r, cube_r, r.paras, S,
                                    flip=r.flip)
    m2d = _m2d(crop_img, mano_img_crop, masked_numerator=False).mean()
    d2m_b, pd2m_joint = icp_and_joint_icp(mesh_r, pcl, joint_pcl,
                                          r.mano.faces,
                                          r.mano.joint_face_mask, seg)
    pd2m = pd2m_joint.mean()
    d2m = d2m_b.mean()
    p2m = smooth_l1(mano_juvd_r, juvd_r.detach()) * cfg.coord_weight
    m2p_mask = _m2p_mask(crop_img, mano_img_r.detach(), d2m_b.detach(),
                         pd2m_joint.detach(), thresh=0.95,
                         union_denominator=False)
    m2p = _masked_select_sl1(juvd_r, mano_juvd_r.detach(), m2p_mask,
                             sync) * cfg.coord_weight

    loss = loss + p2m
    loss = loss + m2d * 0.1 * cfg.model_weight
    loss = loss + d2m * cfg.model_weight
    loss = loss + pd2m * cfg.partICP_weight
    loss = loss + m2p * cfg.M2P_weight
    loss = loss + coll * cfg.coll_weight

    tm = transfer_for_dataset(cfg.dataset)
    nt = len(tm)
    with torch.no_grad():
        metrics = {
            "pixel_error": xyz2error_mm(jxyz_r[:, tm], xyz_gt_r[:, :nt],
                                        center_r, cube_r, dataset=cfg.dataset),
            "mano_error": xyz2error_mm(mano_jxyz_r[:, tm], xyz_gt_r[:, :nt],
                                       center_r, cube_r, dataset=cfg.dataset)}
    metrics.update({k: v.detach() for k, v in (
        ("m2d", m2d), ("pd2m", pd2m), ("P2M", p2m), ("coll", coll),
        ("M2P", m2p), ("d2m", d2m))})
    return loss, metrics


def finetune_stage_loss(net, r: rnd.Renderer, sample: tuple, scores, img_r,
                        center_r, cube_r, M_r, xyz_gt_r, cfg,
                        transfer: Optional[Callable] = None, sync=None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The FinetuneStage phase's losses (ref: train_render.py:622-823) on
    the synth batch from ``finetune_stage_sample`` and a real batch:
    img_r (B, 1, S, S) normalized depth crops, center_r (B, 3) and cube_r
    (B, 3) mm, M_r (B, 3, 3) crop matrices, xyz_gt_r (B, J, 3)
    normalized ground truth in the dataset's joint order (its first
    ``len(transfer_for_dataset(cfg.dataset))`` joints are read, for the
    error metrics only).  ``scores`` are the cloud-sampling draws.  The
    net sees the synth image through ``transfer`` when it is given.

    The JAX package's restructure is kept: the reference's two net calls
    (synth, real) run as one stacked [synth | real] forward with per-group
    BatchNorm statistics (``net(..., bn_groups=2)``), and the two stages'
    loss tensors are stacked stage-major along the batch, so the synth LBS,
    the loss render (``render_params`` at 2B) and the ICP's nearest-face
    pass (one argmin over 4B clouds) run once for both stages.  Stage 2 is
    the detached teacher of stage 1 on the real batch.  ``sync`` is the
    trainer's mesh of ranks (None at world 1): the M2P term's joint count
    is then global (``_masked_select_sl1``).  Returns (loss, metrics)."""
    img, juvd_gt, _, jxyz_gt, vxyz_gt, center_s, cube_s, _ = sample
    B = img.shape[0]
    S = cfg.input_size
    fp = cfg.feature_para[0]

    def two(x):
        return torch.cat([x, x])

    out = _run_net(net, torch.cat([_transferred(img, transfer), img_r]), r,
                   torch.cat([center_s, center_r]),
                   torch.cat([cube_s, cube_r]), bn_groups=2)
    outputs = [[o[0][:B], o[1][:B]] for o in out]
    outputs_r = [[o[0][B:], o[1][B:]] for o in out]

    # ---- synth: full supervision of both stages (ref :633-667)
    loss = 0.0
    metrics = {}
    pixel_s = torch.cat([outputs[0][0], outputs[1][0]])
    para_s = torch.cat([outputs[0][1], outputs[1][1]])
    pixel_gt = joint2offset(juvd_gt, img, fp, pixel_s.shape[-1])
    juvd_pd_s = offset2joint_softmax(pixel_s, two(img), fp)
    mano_jxyz_s, mesh_s = rnd.get_mesh_xyz(r, para_s)   # one LBS, both stages
    coll_s = sph.collision_loss(r.mano, mano_jxyz_s, mesh_s.detach())
    for idx in range(2):
        sl = slice(idx * B, (idx + 1) * B)
        loss = loss + smooth_l1(pixel_s[sl], pixel_gt) * cfg.deconv_weight
        loss = loss + smooth_l1(juvd_pd_s[sl], juvd_gt) * cfg.coord_weight
        loss = loss + smooth_l1(mano_jxyz_s[sl], jxyz_gt) * cfg.coord_weight
        loss = loss + smooth_l1(mesh_s[sl], vxyz_gt) * cfg.coord_weight
        loss = loss + coll_s[sl].mean() * cfg.coll_weight
        with torch.no_grad():
            metrics[f"synth_error_{idx}"] = xyz2error_mm(
                mano_jxyz_s[sl], jxyz_gt, center_s, cube_s)

    # ---- real: stage 2 is the teacher (ref :670-703)
    pixel_t = outputs_r[1][0].detach()
    para_t = outputs_r[1][1].detach()
    juvd_t = offset2joint_softmax(pixel_t, img_r, fp)
    jxyz_t = geo.uvd_nl_to_xyz_nl(juvd_t, center_r, M_r, cube_r, r.paras, S,
                                  r.flip)
    mano_jxyz_t, mano_mesh_t = rnd.get_mesh_xyz(r, para_t)
    crop_img, joint_pcl, seg, pcl = _prep_real(
        r, S, scores, img_r, center_r, M_r, cube_r, jxyz_t, mano_jxyz_t,
        mano_mesh_t)

    pixel_r2 = torch.cat([outputs_r[0][0], outputs_r[1][0]])
    juvd_r2 = offset2joint_softmax(pixel_r2, two(img_r), fp)
    jxyz_r2 = geo.uvd_nl_to_xyz_nl(juvd_r2, two(center_r), two(M_r),
                                   two(cube_r), r.paras, S, r.flip)
    # both stages' loss renders (ref :719 and :759) as one raster at 2B
    para_r2 = torch.cat([outputs_r[0][1], outputs_r[1][1]])
    mano_img_r2, mano_juvd_r2, mano_jxyz_r2, mesh_r2 = rnd.render_params(
        r, para_r2, two(center_r), two(cube_r))
    coll_r2 = sph.collision_loss(r.mano, mano_jxyz_r2, mesh_r2.detach())
    mano_img_crop2 = cloud.crop_hand(mano_img_r2, two(mano_jxyz_t),
                                     two(center_r), two(M_r), two(cube_r),
                                     r.paras, S, flip=r.flip)
    m2d_b2 = _m2d(two(crop_img), mano_img_crop2)               # (2B, 1)
    d2m_b2, pd2m_joint2 = icp_and_joint_icp(
        mesh_r2, two(pcl), two(joint_pcl), r.mano.faces,
        r.mano.joint_face_mask, two(seg))

    tm = transfer_for_dataset(cfg.dataset)
    nt = len(tm)
    for idx in range(2):
        sl = slice(idx * B, (idx + 1) * B)
        juvd_r, jxyz_r = juvd_r2[sl], jxyz_r2[sl]
        mano_juvd_r, mano_jxyz_r = mano_juvd_r2[sl], mano_jxyz_r2[sl]
        with torch.no_grad():
            metrics[f"pixel_error_{idx}"] = xyz2error_mm(
                jxyz_r[:, tm], xyz_gt_r[:, :nt], center_r, cube_r,
                dataset=cfg.dataset)
            metrics[f"mano_error_{idx}"] = xyz2error_mm(
                mano_jxyz_r[:, tm], xyz_gt_r[:, :nt], center_r, cube_r,
                dataset=cfg.dataset)
        if idx == 0:
            # stage 1 distills from the stage-2 teacher (ref :706-724)
            loss = loss + smooth_l1(pixel_r2[sl], pixel_t) * cfg.deconv_weight
            loss = loss + smooth_l1(juvd_r, juvd_t) * cfg.coord_weight
            loss = loss + smooth_l1(mano_jxyz_r, jxyz_t) * cfg.coord_weight
            loss = loss + smooth_l1(mesh_r2[sl], mano_mesh_t) * cfg.coord_weight
        else:
            # stage-2 P2M against the detached teacher pixels (ref :766)
            p2m = smooth_l1(mano_juvd_r, juvd_t) * cfg.coord_weight
            loss = loss + p2m
            metrics["P2M"] = p2m.detach()

        coll = coll_r2[sl].mean()
        loss = loss + coll * cfg.coll_weight
        m2d = m2d_b2[sl].mean() * 0.1
        loss = loss + m2d * cfg.model_weight
        pd2m = pd2m_joint2[sl].mean()
        loss = loss + pd2m * cfg.partICP_weight
        d2m = d2m_b2[sl].mean()
        loss = loss + d2m * cfg.model_weight

        if idx == 1:
            m2p_mask = _m2p_mask(crop_img, mano_img_crop2[sl].detach(),
                                 d2m_b2[sl].detach(),
                                 pd2m_joint2[sl].detach())
            m2p = _masked_select_sl1(juvd_r, mano_juvd_r.detach(),
                                     m2p_mask, sync) * cfg.coord_weight
            loss = loss + m2p * cfg.M2P_weight
            metrics["M2P"] = m2p.detach()
        metrics[f"m2d_{idx}"] = m2d.detach()
        metrics[f"d2m_{idx}"] = d2m.detach()
        metrics[f"pd2m_{idx}"] = pd2m.detach()
        metrics[f"coll_{idx}"] = coll.detach()
    return loss, metrics
