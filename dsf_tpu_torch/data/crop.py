"""Host-side crop and augmentation geometry (counterpart of
dsf_tpu/data/crop.py; ref: render_loader.py:356-745, 748-905), in numpy
and the host library, without OpenCV.

comToBounds / comToTransform crop matrices, Crop_Image_deep_pp, the
rot/com/sc/none augmentation modes and depth normalization.  Where the
JAX package calls OpenCV, this module calls the host library's copies of
the same arithmetic (``native.warp_affine_nearest``,
``native.warp_perspective_nearest``, ``native.rotation_matrix_2d``) and
cv2.resize's nearest rule in numpy, so the pixels are OpenCV's bitwise.
The batched loader (``aug_batch``, ``datasets``) uses the matrices here
and the host library's batched crop; ``crop_image_deep_pp`` and
``augment_crop`` are the per-sample forms (serving's raw-frame crop, and
the model the batched path is held against).
"""

from __future__ import annotations

import numpy as np

from dsf_tpu_torch.data import native


def joint_img_to_3d(uvd, paras, flip=1.0):
    fx, fy, fu, fv = paras
    ret = np.zeros_like(uvd, np.float32)
    ret[..., 0] = (uvd[..., 0] - fu) * uvd[..., 2] / fx
    ret[..., 1] = flip * (uvd[..., 1] - fv) * uvd[..., 2] / fy
    ret[..., 2] = uvd[..., 2]
    return ret


def joint_3d_to_img(xyz, paras, flip=1.0):
    fx, fy, fu, fv = paras
    ret = np.zeros_like(xyz, np.float32)
    ret[..., 0] = xyz[..., 0] * fx / xyz[..., 2] + fu
    ret[..., 1] = flip * xyz[..., 1] * fy / xyz[..., 2] + fv
    ret[..., 2] = xyz[..., 2]
    return ret


def com_to_bounds(com, size, paras):
    fx, fy, _, _ = paras
    zstart = com[2] - size[2] / 2.0
    zend = com[2] + size[2] / 2.0
    xstart = int(np.floor((com[0] * com[2] / fx - size[0] / 2.0) / com[2] * fx + 0.5))
    xend = int(np.floor((com[0] * com[2] / fx + size[0] / 2.0) / com[2] * fx + 0.5))
    ystart = int(np.floor((com[1] * com[2] / fy - size[1] / 2.0) / com[2] * fy + 0.5))
    yend = int(np.floor((com[1] * com[2] / fy + size[1] / 2.0) / com[2] * fy + 0.5))
    return xstart, xend, ystart, yend, zstart, zend


def com_to_transform(com, size, dsize, paras):
    """ref comToTransform with the "changed by pengfeiren" centering
    (render_loader.py:366-401)."""
    xstart, xend, ystart, yend, _, _ = com_to_bounds(com, size, paras)
    trans = np.eye(3)
    trans[0, 2] = -xstart
    trans[1, 2] = -ystart
    wb, hb = xend - xstart, yend - ystart
    if wb > hb:
        scale = np.eye(3) * dsize[0] / float(wb)
        sz = (dsize[0], hb * dsize[0] / wb)
    else:
        scale = np.eye(3) * dsize[1] / float(hb)
        sz = (wb * dsize[1] / hb, dsize[1])
    scale[2, 2] = 1
    off = np.eye(3)
    off[0, 2] = int(np.floor(dsize[0] / 2.0 - sz[0] / 2.0))
    off[1, 2] = int(np.floor(dsize[1] / 2.0 - sz[1] / 2.0))
    return off @ scale @ trans


def _resize_nearest(img, size_wh):
    """cv2.resize(img, size_wh, interpolation=INTER_NEAREST): resizeNN
    floors dst * (1.0/((double)dst/src)); the reciprocal's double rounding
    shifts exact-integer products (e.g. 64*(186/128)) below the integer,
    as in csrc/host_data.cpp."""
    w, h = size_wh
    ys = np.minimum((np.arange(h) * (1.0 / (h / img.shape[0]))).astype(int),
                    img.shape[0] - 1)
    xs = np.minimum((np.arange(w) * (1.0 / (w / img.shape[1]))).astype(int),
                    img.shape[1] - 1)
    return img[ys[:, None], xs[None, :]]


def get_crop(depth, xstart, xend, ystart, yend, zstart, zend,
             thresh_z=True, background=0):
    """ref getCrop (render_loader.py:867-905)."""
    H, W = depth.shape[:2]
    cropped = depth[max(ystart, 0):min(yend, H),
                    max(xstart, 0):min(xend, W)].copy()
    cropped = np.pad(
        cropped,
        ((abs(ystart) - max(ystart, 0), abs(yend) - min(yend, H)),
         (abs(xstart) - max(xstart, 0), abs(xend) - min(xend, W))),
        mode="constant", constant_values=background)
    if thresh_z:
        msk1 = np.logical_and(cropped < zstart, cropped != 0)
        msk2 = np.logical_and(cropped > zend, cropped != 0)
        cropped[msk1] = zstart
        cropped[msk2] = 0.0
    return cropped


def crop_image_deep_pp(depth, com, size, dsize, paras):
    """ref Crop_Image_deep_pp (render_loader.py:748-810): crop, aspect
    -preserving nearest resize, center-paste, return (img, M)."""
    xstart, xend, ystart, yend, zstart, zend = com_to_bounds(com, size, paras)
    cropped = get_crop(depth, xstart, xend, ystart, yend, zstart, zend)

    wb, hb = xend - xstart, yend - ystart
    if wb > hb:
        sz = (dsize[0], int(hb * dsize[0] / wb))
    else:
        sz = (int(wb * dsize[1] / hb), dsize[1])

    trans = np.eye(3)
    trans[0, 2] = -xstart
    trans[1, 2] = -ystart
    if cropped.shape[0] > cropped.shape[1]:
        scale = np.eye(3) * sz[1] / float(cropped.shape[0])
    else:
        scale = np.eye(3) * sz[0] / float(cropped.shape[1])
    scale[2, 2] = 1

    rz = _resize_nearest(cropped, sz)
    ret = np.zeros(dsize, np.float32)
    xs = int(np.floor(dsize[0] / 2.0 - rz.shape[1] / 2.0))
    ys = int(np.floor(dsize[1] / 2.0 - rz.shape[0] / 2.0))
    ret[ys:ys + rz.shape[0], xs:xs + rz.shape[1]] = rz
    off = np.eye(3)
    off[0, 2] = xs
    off[1, 2] = ys
    return ret, off @ scale @ trans


def crop_matrix_deep_pp(com, size, dsize, paras):
    """The 3x3 matrix ``crop_image_deep_pp`` returns, computed WITHOUT
    the image (the bounds/scale/offset math is deterministic in
    com/size/dsize).  Bitwise-identical to the full function's M; the
    batched augmented fetch path uses it so warp matrices compose in
    float64 while the crop pixels come from the native C++ path."""
    xstart, xend, ystart, yend, _, _ = com_to_bounds(com, size, paras)
    wb, hb = xend - xstart, yend - ystart
    if wb > hb:
        sz = (dsize[0], int(hb * dsize[0] / wb))
    else:
        sz = (int(wb * dsize[1] / hb), dsize[1])
    trans = np.eye(3)
    trans[0, 2] = -xstart
    trans[1, 2] = -ystart
    if hb > wb:
        scale = np.eye(3) * sz[1] / float(hb)
    else:
        scale = np.eye(3) * sz[0] / float(wb)
    scale[2, 2] = 1
    off = np.eye(3)
    off[0, 2] = int(np.floor(dsize[0] / 2.0 - sz[0] / 2.0))
    off[1, 2] = int(np.floor(dsize[1] / 2.0 - sz[1] / 2.0))
    return off @ scale @ trans


def normalize_img(premax, imgD, com, cube):
    """ref loader.normalize_img (render_loader.py:738-745); in-place."""
    imgD[imgD == premax] = com[2] + cube[2] / 2.0
    imgD[imgD == 0] = com[2] + cube[2] / 2.0
    imgD[imgD >= com[2] + cube[2] / 2.0] = com[2] + cube[2] / 2.0
    imgD[imgD <= com[2] - cube[2] / 2.0] = com[2] - cube[2] / 2.0
    imgD -= com[2]
    imgD /= cube[2] / 2.0
    return imgD


def transform_points_2d(pts, M):
    ret = pts.copy()
    uv1 = np.concatenate([pts[:, 0:2], np.ones((pts.shape[0], 1))], axis=1)
    out = (M @ uv1.T).T
    ret[:, 0:2] = out[:, 0:2] / out[:, 2:3]
    return ret


def rotate_point_2d(p, center, angle_deg):
    a = angle_deg * np.pi / 180.0
    pp = p.copy()
    pp[0:2] -= center[0:2]
    pr = np.zeros_like(pp)
    pr[0] = pp[0] * np.cos(a) - pp[1] * np.sin(a)
    pr[1] = pp[0] * np.sin(a) + pp[1] * np.cos(a)
    pr[2] = pp[2]
    pr[0:2] += center[0:2]
    return pr


def recrop_hand(crop, M, Mnew, target_size, paras, background=0.0,
                nv_val=0.0, thresh_z=True, com=None, size=(250, 250, 250)):
    """ref recropHand (render_loader.py:403-421)."""
    warped = native.warp_perspective_nearest(crop, M @ Mnew, target_size,
                                             float(background))
    warped[warped < nv_val] = background
    if thresh_z:
        _, _, _, _, zstart, zend = com_to_bounds(com, size, paras)
        msk1 = np.logical_and(warped < zstart, warped != 0)
        msk2 = np.logical_and(warped > zend, warped != 0)
        warped[msk1] = zstart
        warped[msk2] = 0.0
    return warped


def move_com(dpt, cube, com, off, joints3D, M, paras, flip=1.0, pad_value=0):
    """ref moveCoM (render_loader.py:424-456)."""
    if np.allclose(off, 0.0):
        return dpt, joints3D, com, M
    new_com = joint_3d_to_img(joint_img_to_3d(com, paras, flip) + off,
                              paras, flip)
    if not (np.allclose(com[2], 0.0) or np.allclose(new_com[2], 0.0)):
        Mnew = com_to_transform(new_com, cube, dpt.shape, paras)
        new_dpt = recrop_hand(dpt, Mnew, np.linalg.inv(M), dpt.shape, paras,
                              background=pad_value,
                              nv_val=np.min(dpt[dpt > 0]) - 1,
                              thresh_z=True, com=new_com, size=cube)
    else:
        Mnew, new_dpt = M, dpt
    new_joints3D = joints3D + joint_img_to_3d(com, paras, flip) - \
        joint_img_to_3d(new_com, paras, flip)
    return new_dpt, new_joints3D, new_com, Mnew


def rotate_hand(dpt, cube, com, rot, joints3D, paras, flip=1.0, pad_value=0):
    """ref rotateHand (render_loader.py:458-495)."""
    if np.allclose(rot, 0.0):
        return dpt, joints3D, rot
    rot = np.mod(rot, 360)
    M = native.rotation_matrix_2d((dpt.shape[1] // 2, dpt.shape[0] // 2),
                                  -rot, 1)
    new_dpt = native.warp_affine_nearest(dpt, M, (dpt.shape[1], dpt.shape[0]),
                                         pad_value)
    if (dpt > 0).sum() > 0:
        dpt_min = np.min(dpt[dpt > 0]) - 1
        new_dpt[new_dpt < dpt_min] = 0
    com3D = joint_img_to_3d(com, paras, flip)
    joint_2D = joint_3d_to_img(joints3D + com3D, paras, flip)
    data_2D = np.zeros_like(joint_2D)
    for k in range(data_2D.shape[0]):
        data_2D[k] = rotate_point_2d(joint_2D[k], com[0:2], rot)
    new_joints3D = joint_img_to_3d(data_2D, paras, flip) - com3D
    return new_dpt, new_joints3D, rot


def scale_hand(dpt, cube, com, sc, joints3D, M, paras, pad_value=0):
    """ref scaleHand (render_loader.py:497-527)."""
    if np.allclose(sc, 1.0):
        return dpt, joints3D, cube, M
    new_cube = [s * sc for s in cube]
    if not np.allclose(com[2], 0.0):
        Mnew = com_to_transform(com, new_cube, dpt.shape, paras)
        new_dpt = recrop_hand(dpt, Mnew, np.linalg.inv(M), dpt.shape, paras,
                              background=pad_value,
                              nv_val=np.min(dpt[dpt > 0]) - 1,
                              thresh_z=True, com=com, size=cube)
    else:
        Mnew, new_dpt = M, dpt
    return new_dpt, joints3D, new_cube, Mnew


AUG_MODES = ["rot", "com", "sc", "none"]


def rand_augment(rng, sigma_com=10.0, sigma_sc=0.2, rot_range=180.0):
    """ref rand_augment (render_loader.py:627-651), but on an explicit
    RandomState instead of the global python RNG (reproducible)."""
    mode = rng.randint(0, len(AUG_MODES))
    off = rng.uniform(-1, 1, 3) * sigma_com
    rot = rng.uniform(-rot_range, rot_range)
    sc = abs(1.0 + rng.uniform(-1, 1) * sigma_sc)
    return mode, off, rot, sc


def augment_crop(img, gt3Dcrop, com, cube, M, mode, off, rot, sc, paras,
                 flip=1.0):
    """ref augmentCrop (render_loader.py:653-695)."""
    premax = img.max()
    if np.max(img) == 0:
        imgD, new_joints3D = img, gt3Dcrop
        off = np.zeros(3); rot = 0.0; sc = 1.0
    elif AUG_MODES[mode] == "com":
        rot, sc = 0.0, 1.0
        imgD, new_joints3D, com, M = move_com(
            img.astype("float32"), cube, com, off, gt3Dcrop, M, paras, flip)
    elif AUG_MODES[mode] == "rot":
        off, sc = np.zeros(3), 1.0
        imgD, new_joints3D, rot = rotate_hand(
            img.astype("float32"), cube, com, rot, gt3Dcrop, paras, flip)
    elif AUG_MODES[mode] == "sc":
        off, rot = np.zeros(3), 0.0
        imgD, new_joints3D, cube, M = scale_hand(
            img.astype("float32"), cube, com, sc, gt3Dcrop, M, paras)
    elif AUG_MODES[mode] == "none":
        off, sc, rot = np.zeros(3), 1.0, 0.0
        imgD, new_joints3D = img, gt3Dcrop
    else:
        raise NotImplementedError(mode)
    imgD = normalize_img(premax, imgD, com, cube)
    return imgD, new_joints3D, np.asarray(cube), com, M, rot
