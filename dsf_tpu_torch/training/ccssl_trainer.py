"""The CCSSL baseline: confidence-weighted training on pseudo labels from
test-time augmentation (counterpart of dsf_tpu/training/ccssl_trainer.py;
ref: CCSSL/consis*.py, metric/losses.py:32, nyu_CCSSL_loader).

1. ``generate_pseudo_labels`` runs the net in eval mode with
   ``tools.ccssl.prediction_check`` over a dataset and writes
   ``joint_uvd.txt`` and ``weight.txt``.  The joints are written in the
   image frame (pixels and mm), which ``datasets.NYUCCSSLDataset`` reads;
   the JAX package writes the crop frame's normalized joints into the
   same file, which its dataset then reads as pixels and mm
   (ROADMAP: a fault of the JAX package that the port avoids).
2. ``ccssl_loss`` is the supervised loss on those labels, per stage the
   pixel feature's SmoothL1 against the labels' offset field and the
   confidence-weighted SmoothL1 of the decoded joints;
   ``Trainer.ccssl_step_fn`` takes the step.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dsf_tpu_torch.device import exact_float32, widen
from dsf_tpu_torch.losses.basic import smooth_l1, weighted_smooth_l1
from dsf_tpu_torch.ops.offset_codec import joint2offset, offset2joint_softmax
from dsf_tpu_torch.tools.ccssl import prediction_check, ref_tta_draws

N_AUG = 5


def crop_to_image(joints, M, center, cube, img_size):
    """Crop-frame joints (B, J, 3) (u, v, d normalized to [-1, 1], as a
    batch's ``uvd_gt``) -> image-frame uvd (pixels and mm), float64,
    through each frame's crop matrix ``M`` (B, 3, 3), ``center`` (B, 3)
    (the crop's com in mm) and ``cube`` (B, 3): the inverse of the
    batch's normalization, uv = M^-1 . ((u + 1) * S / 2) and
    d = d_n * cube[0] / 2 + center[2]."""
    joints, M, center, cube = (np.asarray(x, np.float64)
                               for x in (joints, M, center, cube))
    uv = (joints[..., :2] + 1.0) * (img_size / 2.0)
    h = np.concatenate([uv, np.ones(uv.shape[:-1] + (1,))], -1) @ \
        np.linalg.inv(M).transpose(0, 2, 1)
    out = np.empty_like(joints)
    out[..., :2] = h[..., :2] / h[..., 2:3]
    out[..., 2] = joints[..., 2] * cube[:, None, 0] / 2.0 + center[:, None, 2]
    return out


def write_labels(out_dir, uvd, conf):
    """``joint_uvd.txt`` (a row of J x 3 values a frame) and
    ``weight.txt`` (J a frame), ``%.5f``, as the JAX package writes
    them."""
    os.makedirs(out_dir, exist_ok=True)
    np.savetxt(os.path.join(out_dir, "joint_uvd.txt"),
               np.asarray(uvd).reshape(len(uvd), -1), fmt="%.5f")
    np.savetxt(os.path.join(out_dir, "weight.txt"), np.asarray(conf),
               fmt="%.5f")


def generate_pseudo_labels(trainer, state, dataset, out_dir, batch_size=32,
                           n_aug=N_AUG, stage=-1, draw=None, seed=0):
    """Label every frame of ``dataset`` with ``prediction_check``: the
    net of ``state`` in eval mode, in the trainer's compute dtype, with
    each frame's own centre and cube for its stage-2 render; the pixel
    feature of stage ``stage`` in float32.  Batches of ``batch_size``
    frames in order, the last padded with its last frame; their draws
    from ``draw(B, n_aug)`` -> (s, rot), by default ``ref_tta_draws``
    from a generator seeded with ``seed``.  The dataset's own batches are
    used, augmented or not as it is set.  Writes the image-frame joints
    and the confidences (``write_labels``).  Returns (image-frame joints
    (N, J, 3) float64, confidences (N, J), crop-frame joints (N, J, 3))."""
    if draw is None:
        gen = torch.Generator().manual_seed(seed)
        draw = lambda b, n: ref_tta_draws(gen, b, n)
    cfg, r, dev = trainer.cfg, trainer.renderer, trainer.device
    net = state.net
    was_training = net.training
    net.eval()
    n = len(dataset)
    crop, conf, image = [], [], []
    try:
        with torch.no_grad(), exact_float32():
            for s in range(0, n, batch_size):
                idx = np.arange(s, min(s + batch_size, n))
                idx = np.concatenate([idx, np.repeat(idx[-1:],
                                                     batch_size - len(idx))])
                b = dataset._fetch_batch(idx)
                img, center, cube = (torch.from_numpy(b[k]).to(dev)
                                     for k in ("img", "center", "cube"))
                forward = lambda im: widen(net(im, r, center, cube)[stage][0])
                joints, c = prediction_check(forward, img,
                                             draw(batch_size, n_aug),
                                             cfg.feature_para[0])
                keep = min(batch_size, n - s)
                joints = joints.cpu().numpy()[:keep]
                crop.append(joints)
                conf.append(c.cpu().numpy()[:keep])
                image.append(crop_to_image(joints, b["M"][:keep],
                                           b["center"][:keep],
                                           b["cube"][:keep], img.shape[-1]))
    finally:
        net.train(was_training)
    crop, conf, image = (np.concatenate(x) for x in (crop, conf, image))
    write_labels(out_dir, image, conf)
    return image, conf, crop


def ccssl_loss(net, renderer, batch, cfg):
    """The CCSSL objective on a batch {img, center, cube, uvd_gt,
    weight?} of tensors: the net (in its mode) on img with the frames'
    centres and cubes, then per stage, its pixel feature in float32,
    SmoothL1(feature, joint2offset(labels)) * deconv_weight +
    WeightSmoothL1(decoded joints, labels, weight) * coord_weight (plain
    SmoothL1 without ``weight``).  Labels (and weights) with fewer joints
    than the net's are padded with zeros, as the JAX step pads them.
    Returns (loss, {"loss_i": stage i's term})."""
    img, center, cube = batch["img"], batch["center"], batch["cube"]
    kernel = cfg.feature_para[0]
    loss, terms = 0.0, {}
    for i, (pixel_pd, _para) in enumerate(net(img, renderer, center, cube)):
        pixel_pd = widen(pixel_pd)
        uvd_pd = offset2joint_softmax(pixel_pd, img, kernel)
        J = uvd_pd.shape[1]
        gt, w = batch["uvd_gt"], batch.get("weight")
        if gt.shape[1] != J:
            gt = torch.nn.functional.pad(gt, (0, 0, 0, J - gt.shape[1]))
            if w is not None:
                w = torch.nn.functional.pad(w, (0, J - w.shape[1]))
        pixel_gt = joint2offset(gt, img, kernel, pixel_pd.shape[-1])
        term = smooth_l1(pixel_pd, pixel_gt) * cfg.deconv_weight
        term = term + (weighted_smooth_l1(uvd_pd, gt, w) if w is not None
                       else smooth_l1(uvd_pd, gt)) * cfg.coord_weight
        terms[f"loss_{i}"] = term.detach()
        loss = loss + term
    return loss, terms
