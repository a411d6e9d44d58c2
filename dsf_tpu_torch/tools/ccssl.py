"""CCSSL pseudo labels by test-time augmentation (counterpart of
dsf_tpu/tools/ccssl.py; ref: CCSSL/consistency.py:72-113, CCSSL/consis.py
:9-50).

* ``prediction_check`` is the device-side variant (consistency.py): N
  rotation / scale passes through the net, the score maps warped back
  and averaged, one decode at the end; with consis.py's confidence (the
  per-pass spatial-softmax peak of the heat channels, averaged).
* ``prediction_check_joints`` is the host-side variant (consis.py):
  nearest warps on the host (the host library's copy of OpenCV's
  ``warpAffine``, border 1), a decode per pass, the joints mapped back and
  averaged.

The augmentation draws come in as tensors (``ref_tta_draws`` draws them
from a ``torch.Generator`` with the reference's distribution), so both
packages can be fed the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from dsf_tpu_torch.device import widen
from dsf_tpu_torch.ops.image import affine_warp
from dsf_tpu_torch.ops.offset_codec import offset2joint_softmax


def ref_tta_draws(gen: torch.Generator, batch: int, n_aug: int):
    """The reference's scale and rotation draws (consistency.py:82-94),
    each (n_aug, batch) float32 on the CPU: pass 0 is the identity; then
    s = clamp(N(0, 1) * 0.25 + 1, 0.75, 1.25) and rot = clamp(N(0, 1) *
    30, -60, 60), which the score-map variant uses as radians (kept)."""
    s = (torch.randn(n_aug, batch, generator=gen) * 0.25 + 1.0).clamp(
        0.75, 1.25)
    rot = (torch.randn(n_aug, batch, generator=gen) * 30.0).clamp(-60.0, 60.0)
    s[0], rot[0] = 1.0, 0.0
    return s, rot


def _ref_theta(s, rot):
    """consistency.py:142-152 get_trans_M: the scale multiplies only the
    diagonal (kept); returns theta (B, 2, 3) and its exact inverse (the
    translation is 0, so the 2x2 inverse)."""
    a, b = s * torch.cos(rot), -torch.sin(rot)
    c, d = torch.sin(rot), s * torch.cos(rot)
    zeros = torch.zeros_like(a)
    theta = torch.stack([torch.stack([a, b, zeros], -1),
                         torch.stack([c, d, zeros], -1)], -2)
    det = a * d - b * c
    theta_inv = torch.stack([torch.stack([d / det, -b / det, zeros], -1),
                             torch.stack([-c / det, a / det, zeros], -1)], -2)
    return theta, theta_inv


def _pass_confidence(feat, n_kpts):
    """consis.py:42: a pass's confidence, the peak of the spatial
    softmax(30 * heat) of each joint's heat channel."""
    heat = feat[:, 3 * n_kpts:].reshape(feat.shape[0], n_kpts, -1)
    return torch.softmax(heat * 30.0, dim=-1).amax(-1)


def prediction_check(forward_fn, img, draws, kernel=0.8):
    """Score-map-averaging test-time augmentation (consistency.py:72-113).

    forward_fn: img (B, 1, S, S) -> (B, 4J, S', S') float32, the pixel
    feature of the stage of choice.  ``draws`` (s, rot), each (n_aug, B):
    pass i warps the image by theta(s[i], rot[i]) (nearest; img - 1, so
    the background pads to 1), warps its feature back by the inverse
    (nearest, zero pad) and adds it up.  Returns (joints (B, J, 3) in the
    crop frame, decoded from the mean feature on ``img``; confidence
    (B, J), the passes' mean ``_pass_confidence``)."""
    s_all, rot_all = (d.to(img.device, torch.float32) for d in draws)
    n_aug = s_all.shape[0]
    acc, conf = None, 0.0
    for i in range(n_aug):
        theta, theta_inv = _ref_theta(s_all[i], rot_all[i])
        img_aug = affine_warp(img - 1.0, theta, mode="nearest") + 1.0
        feat = widen(forward_fn(img_aug))
        conf = conf + _pass_confidence(feat, feat.shape[1] // 4)
        back = affine_warp(feat, theta_inv, mode="nearest")
        acc = back if acc is None else acc + back
    joints = offset2joint_softmax(acc / n_aug, img, kernel)
    return joints, conf / n_aug


def ref_crop_affine(center, scale, rot_deg, out_size):
    """data/transform.py:57-91 get_affine_transform (the 128-anchored
    variant consis.py uses): the 2x3 affine solved from the reference's 3
    source / destination point pairs, float64."""
    cx, cy = float(center[0]), float(center[1])
    src_w = scale * 128.0
    dst_w = dst_h = float(out_size)
    rot = np.pi * rot_deg / 180.0
    sn, cs = np.sin(rot), np.cos(rot)
    sdir = np.array([src_w * 0.5 * sn, -src_w * 0.5 * cs])  # get_dir
    src = np.zeros((3, 2), np.float64)
    dst = np.zeros((3, 2), np.float64)
    src[0] = (cx, cy)
    src[1] = src[0] + sdir
    dst[0] = (dst_w * 0.5, dst_h * 0.5)
    dst[1] = dst[0] + np.array([0.0, -dst_w * 0.5])
    for p in (src, dst):
        d = p[0] - p[1]                                     # get_3rd_point
        p[2] = p[1] + np.array([-d[1], d[0]])
    A = np.zeros((6, 6))
    bvec = np.zeros(6)
    for i in range(3):
        A[2 * i, :3] = (src[i, 0], src[i, 1], 1.0)
        A[2 * i + 1, 3:] = (src[i, 0], src[i, 1], 1.0)
        bvec[2 * i:2 * i + 2] = dst[i]
    return np.linalg.solve(A, bvec).reshape(2, 3)


def prediction_check_joints(forward_fn, img, draws, kernel=0.8):
    """Joint-averaging test-time augmentation (consis.py:9-50), on the
    host.  Pass i warps each image by ``ref_crop_affine`` (scale s[i, b],
    rotation rot[i, b] in degrees here; the matrix cast to float32 as
    OpenCV is given it) with the host library's nearest warp (border 1),
    decodes the pass's feature on the warped image, maps the joints back
    through the inverse affine in the 128-px frame (consis.py:102-118)
    and adds them up.  ``img`` (B, 1, S, S) numpy or tensor; forward_fn
    takes and returns tensors, on the device it chooses.  Returns numpy
    (joints (B, J, 3), confidence (B, J)), the passes' means."""
    from dsf_tpu_torch.data import native
    img = np.asarray(img.cpu() if torch.is_tensor(img) else img, np.float32)
    B, _, H, W = img.shape
    s_all, rot_all = (np.asarray(d) for d in draws)
    n_aug = s_all.shape[0]
    joint_acc, conf_acc = 0.0, 0.0
    half = W / 2.0
    for i in range(n_aug):
        Ms = [ref_crop_affine((W // 2, H // 2), s_all[i, b], rot_all[i, b], W)
              for b in range(B)]
        warped = torch.from_numpy(np.stack([
            native.warp_affine_nearest(img[b, 0], Ms[b].astype(np.float32),
                                       (W, H), border=1.0)
            for b in range(B)])[:, None])
        feat = widen(forward_fn(warped))
        juvd = offset2joint_softmax(feat, warped.to(feat.device),
                                    kernel).cpu().numpy().copy()
        conf_acc += _pass_confidence(feat, feat.shape[1] // 4).cpu().numpy()
        for b in range(B):
            Minv = np.linalg.inv(np.vstack([Ms[b], (0.0, 0.0, 1.0)]))[:2]
            px = (juvd[b, :, :2] + 1.0) * half
            px = px @ Minv[:, :2].T + Minv[:, 2]
            juvd[b, :, :2] = px / half - 1.0
        joint_acc = joint_acc + juvd
    return joint_acc / n_aug, conf_acc / n_aug


def export_refine_centers(dataset, out_path):
    """A dataset's refined centres as world-xyz rows after the
    reference's y-negation round trip (project with flip -1, unproject
    with flip +1): the body of debug_CCSSL (ref: data/render_loader.py
    :5488-5495), which writes center_test_<view>_refine_xyz.txt for the
    CCSSL centre files.  Writes ``%.3f`` rows; returns them."""
    from dsf_tpu_torch.data import crop as C
    c = np.asarray(dataset.center_xyz, np.float32).reshape(-1, 1, 3)
    c = C.joint_img_to_3d(C.joint_3d_to_img(c, dataset.paras, flip=-1),
                          dataset.paras, flip=1).reshape(-1, 3)
    np.savetxt(out_path, c, fmt="%.3f")
    return c
