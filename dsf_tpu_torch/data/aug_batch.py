"""Batched augmented-crop fetch (host side; counterpart of
dsf_tpu/data/aug_batch.py).

The augmentation pipeline of ``crop.augment_crop``, batched:

  * crop: the host library's ``batch_crop_raw`` (crop WITHOUT normalize:
    the augmentation warps raw depth first, ref render_loader.py:653-695
    ordering), with the float64 crop matrix from
    ``crop.crop_matrix_deep_pp`` (bitwise the per-sample M);
  * warps: the host library's copies of cv2.warpAffine /
    cv2.warpPerspective (INTER_NEAREST, constant border) and
    cv2.getRotationMatrix2D, on the JAX package's matrices;
  * floor/z-window thresholds + depth normalization: one threaded pass in
    the host library (``batch_finish_aug``);
  * label math: vectorized numpy mirroring ``augment_crop`` and the item
    tail of the JAX package's ``NYUDataset.__getitem__``, op for op.

The draws come from one ``RandomState`` (``draw_params``), so a batch is
deterministic given the dataset's seed.  With every draw "none"
(``unaugmented_batch``) the same pipeline is the JAX package's per-item
eval path (``SHRECDataset`` / ``DHGDataset.__getitem__``), bitwise.
"""

from __future__ import annotations

import numpy as np

from dsf_tpu_torch.data import crop as C
from dsf_tpu_torch.data import native


def draw_params(rng, B, aug_para):
    """B (mode, off, rot, sc) tuples from one RandomState (the batch
    path replaces the per-thread streams of the item path; same
    marginal distributions, ref render_loader.py:627-651)."""
    return [C.rand_augment(rng, aug_para[0], aug_para[1], aug_para[2])
            for _ in range(B)]


def augment_fast_batch(depths, joints_xyz, centers_xyz, cubes64, paras,
                       flip, img_size, draws, nthreads=4, coms=None):
    """Full augmented train batch from decoded full-frame depths.

    depths (B,H,W) f32; joints_xyz (B,J,3) f32; centers_xyz (B,3) f32;
    cubes64 (B,3) f64; draws: list of (mode, off, rot, sc); coms (B,3)
    f32 the crop centres in uvd (the centres' projection when None).
    Returns the batch dict of ``datasets.NYUDataset``.
    """
    B = depths.shape[0]
    S = img_size
    if coms is None:
        coms = C.joint_3d_to_img(centers_xyz, paras, flip)      # (B,3) f32
    crops, _ = native.batch_crop_raw(
        depths, coms.astype(np.float32), cubes64.astype(np.float32),
        np.asarray(paras, np.float32), S, nthreads=nthreads)

    gt3Dcrops = (joints_xyz - centers_xyz[:, None]).astype(np.float32)
    premax = crops.max(axis=(1, 2))

    out = np.empty_like(crops)
    flags = np.zeros(B, np.uint8)
    floors = np.zeros(B, np.float32)
    zwins = np.zeros((B, 2), np.float64)
    out_coms = coms.copy()                                      # (B,3) f32
    out_cubes = np.asarray(cubes64, np.float64).copy()          # (B,3) f64
    out_Ms = np.empty((B, 3, 3), np.float64)
    labels = gt3Dcrops.copy()

    dsize = (S, S)
    for b in range(B):
        img = crops[b]
        com = coms[b]
        cube = cubes64[b]
        M = C.crop_matrix_deep_pp(com, cube, dsize, paras)
        out_Ms[b] = M
        mode, off, rot, sc = draws[b]
        name = C.AUG_MODES[mode]
        if premax[b] == 0 or name == "none":
            out[b] = img
            continue

        if name == "rot":
            # ref rotateHand (render_loader.py:458-495)
            if np.allclose(rot, 0.0):
                out[b] = img
                continue
            rot = np.mod(rot, 360)
            R = native.rotation_matrix_2d((S // 2, S // 2), -rot, 1)
            out[b] = native.warp_affine_nearest(img, R, dsize, 0.0)
            flags[b] = 1
            floors[b] = np.min(img[img > 0]) - 1
            com3D = C.joint_img_to_3d(com, paras, flip)
            joint_2D = C.joint_3d_to_img(labels[b] + com3D, paras, flip)
            # mirrors rotate_point_2d's rounding: the rotated offsets
            # land in f32 BEFORE the center is added back
            a = rot * np.pi / 180.0
            d = joint_2D.copy()
            px = joint_2D[:, 0] - com[0]
            py = joint_2D[:, 1] - com[1]
            d[:, 0] = (px * np.cos(a) - py * np.sin(a)).astype(
                np.float32) + com[0]
            d[:, 1] = (px * np.sin(a) + py * np.cos(a)).astype(
                np.float32) + com[1]
            labels[b] = C.joint_img_to_3d(d, paras, flip) - com3D

        elif name == "com":
            # ref moveCoM (render_loader.py:424-456)
            new_com = C.joint_3d_to_img(
                C.joint_img_to_3d(com, paras, flip) + off, paras, flip)
            if np.allclose(off, 0.0):
                out[b] = img
                continue
            if not (np.allclose(com[2], 0.0)
                    or np.allclose(new_com[2], 0.0)):
                Mnew = C.com_to_transform(new_com, cube, dsize, paras)
                out[b] = native.warp_perspective_nearest(
                    img, Mnew @ np.linalg.inv(M), dsize, 0.0)
                flags[b] = 3
                floors[b] = np.min(img[img > 0]) - 1
                _, _, _, _, zs, ze = C.com_to_bounds(new_com, cube, paras)
                zwins[b] = (zs, ze)
                out_Ms[b] = Mnew
            else:
                out[b] = img
            labels[b] = (labels[b] + C.joint_img_to_3d(com, paras, flip)
                         - C.joint_img_to_3d(new_com, paras, flip))
            out_coms[b] = new_com

        elif name == "sc":
            # ref scaleHand (render_loader.py:497-527); the z-window
            # comes from the OLD cube (the reference passes size=cube)
            if np.allclose(sc, 1.0):
                out[b] = img
                continue
            new_cube = np.asarray([s * sc for s in cube])
            if not np.allclose(com[2], 0.0):
                Mnew = C.com_to_transform(com, new_cube, dsize, paras)
                out[b] = native.warp_perspective_nearest(
                    img, Mnew @ np.linalg.inv(M), dsize, 0.0)
                flags[b] = 3
                floors[b] = np.min(img[img > 0]) - 1
                _, _, _, _, zs, ze = C.com_to_bounds(com, cube, paras)
                zwins[b] = (zs, ze)
                out_Ms[b] = Mnew
            else:
                out[b] = img
            out_cubes[b] = new_cube

    native.batch_finish_aug(
        out, flags, floors, zwins, premax,
        out_coms[:, 2].astype(np.float32),
        np.ascontiguousarray(out_cubes[:, 2]), nthreads=nthreads)

    # ---- label finishing, the exact item tail of the JAX package:
    # curLabel stays f64 through the uvd chain (the per-sample path only
    # casts at the output dict), and the homogeneous ratio rounds to f32
    # before the /(S/2)-1 like transform_points_2d's in-place store
    curLabel = labels / (out_cubes[:, None, 2:3] / 2.0)
    com3D = C.joint_img_to_3d(out_coms, paras, flip)            # (B,3) f32
    world = curLabel * (out_cubes[:, None, 0:1] / 2.0) + com3D[:, None]
    uvd = C.joint_3d_to_img(world, paras, flip)
    ones = np.ones(uvd.shape[:-1] + (1,), uvd.dtype)
    h = np.concatenate([uvd[..., :2], ones], axis=-1) @ \
        out_Ms.transpose(0, 2, 1)
    joint_img = uvd.copy()
    joint_img[..., :2] = (h[..., :2] / h[..., 2:3]).astype(np.float32) \
        / (S / 2) - 1
    joint_img[..., 2] = (uvd[..., 2] - com3D[:, None, 2]) \
        / (out_cubes[:, None, 0] / 2.0)
    return {
        "img": out[:, None].astype(np.float32),
        "xyz_gt": curLabel.astype(np.float32),
        "uvd_gt": joint_img.astype(np.float32),
        "center": com3D.astype(np.float32),
        "M": out_Ms.astype(np.float32),
        "cube": out_cubes.astype(np.float32),
    }


NO_AUGMENT = (C.AUG_MODES.index("none"), np.zeros(3), 0.0, 1.0)


def unaugmented_batch(depths, joints_xyz, coms, cubes64, paras, flip,
                      img_size, nthreads=4):
    """The unaugmented batch of the JAX package's per-item path (crop,
    normalize and labels op for op as its ``__getitem__`` computes them),
    with crop centres ``coms`` (B, 3) f32 in uvd: ``augment_fast_batch``
    with every draw "none"."""
    coms = np.asarray(coms, np.float32)
    return augment_fast_batch(
        depths, joints_xyz, C.joint_img_to_3d(coms, paras, flip), cubes64,
        paras, flip, img_size, [NO_AUGMENT] * len(coms), nthreads=nthreads,
        coms=coms)
