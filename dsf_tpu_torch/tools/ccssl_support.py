"""CCSSL support utilities, the numpy part (counterpart of
dsf_tpu/tools/ccssl_support.py; ref: CCSSL/imutils.py:41-102,
CCSSL/transforms.py:14-78, CCSSL/misc.py:29-55): the hourglass-style
label maps, the display colour map, the crop transforms and the
bookkeeping, each the JAX package's function as it is (host-side numpy,
no OpenCV).  ``crop``, ``sample_with_heatmap`` and ``batch_with_heatmap``
need OpenCV's bilinear ``warpAffine`` / ``resize``, which the host
library does not carry (ROADMAP Queue 1, item 5).

As in the JAX package, ``save_checkpoint`` / ``save_pred`` write .npz
and .mat files where the reference writes torch .pth.tar.
"""

from __future__ import annotations

import os
import shutil

import numpy as np


def gaussian(shape=(7, 7), sigma=1):
    """MATLAB fspecial('gaussian')-equivalent mask
    (ref: CCSSL/imutils.py:41-50), un-normalized, eps-floored."""
    m, n = [(ss - 1.0) / 2.0 for ss in shape]
    y, x = np.ogrid[-m:m + 1, -n:n + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h.astype(np.float32)


def draw_labelmap(img, pt, sigma, type="Gaussian"):
    """Write one joint's heatmap into ``img`` in place; returns
    (img, visible) where visible=0 iff the 3-sigma box misses the image
    entirely (ref: CCSSL/imutils.py:52-85, hourglass pose-hg-train).

    Quirks preserved: int() truncation of the box corners, center value
    exactly 1 (not normalized), straight ASSIGNMENT into the image (a
    later joint overwrites an earlier one where boxes overlap)."""
    img = np.asarray(img)
    ul = [int(pt[0] - 3 * sigma), int(pt[1] - 3 * sigma)]
    br = [int(pt[0] + 3 * sigma + 1), int(pt[1] + 3 * sigma + 1)]
    if (ul[0] >= img.shape[1] or ul[1] >= img.shape[0]
            or br[0] < 0 or br[1] < 0):
        return img, 0

    size = 6 * sigma + 1
    x = np.arange(0, size, 1, float)
    y = x[:, np.newaxis]
    x0 = y0 = size // 2
    if type == "Gaussian":
        g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2))
    elif type == "Cauchy":
        g = sigma / (((x - x0) ** 2 + (y - y0) ** 2 + sigma ** 2) ** 1.5)
    else:
        raise ValueError(type)

    g_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    g_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    img_x = max(0, ul[0]), min(br[0], img.shape[1])
    img_y = max(0, ul[1]), min(br[1], img.shape[0])
    img[img_y[0]:img_y[1], img_x[0]:img_x[1]] = \
        g[g_y[0]:g_y[1], g_x[0]:g_x[1]]
    return img, 1


def gaussian_label_map(joints_uv, size, sigma=1.0):
    """(J, 2) pixel coords -> (J, size, size) heatmaps via
    ``draw_labelmap`` (the reference composes it per joint in its
    dataset __getitem__)."""
    joints_uv = np.asarray(joints_uv)
    maps = np.zeros((joints_uv.shape[0], size, size), np.float32)
    for j, pt in enumerate(joints_uv):
        draw_labelmap(maps[j], pt, sigma)
    return maps


def gauss(x, a, b, c, d=0):
    return a * np.exp(-(x - b) ** 2 / (2 * c ** 2)) + d


def color_heatmap(x):
    """Heatmap -> RGB uint8 via the reference's 3-channel gaussian
    colormap (ref: CCSSL/imutils.py:94-102)."""
    x = np.asarray(x)
    color = np.zeros((x.shape[0], x.shape[1], 3))
    color[:, :, 0] = gauss(x, 0.5, 0.6, 0.2) + gauss(x, 1, 0.8, 0.3)
    color[:, :, 1] = gauss(x, 1, 0.5, 0.3)
    color[:, :, 2] = gauss(x, 1, 0.2, 0.3)
    color[color > 1] = 1
    return (color * 255).astype(np.uint8)


def color_normalize(x, mean, std=None):
    """Channel-mean subtraction; single-channel input is repeated to 3
    first.  Quirk preserved: ``std`` is accepted and IGNORED, exactly
    like the reference (ref: CCSSL/transforms.py:14-20)."""
    x = np.asarray(x, np.float32).copy()
    if x.shape[0] == 1:
        x = np.repeat(x, 3, axis=0)
    for c, m in enumerate(mean):
        x[c] -= m
    return x


def fliplr(x):
    """Horizontal flip of (C, H, W) or (B, C, H, W) arrays via the
    reference's transpose/np.fliplr dance (ref: transforms.py:23-29)."""
    x = np.asarray(x)
    if x.ndim == 3:
        x = np.transpose(np.fliplr(np.transpose(x, (0, 2, 1))), (0, 2, 1))
    elif x.ndim == 4:
        x = x.copy()
        for i in range(x.shape[0]):
            x[i] = np.transpose(
                np.fliplr(np.transpose(x[i], (0, 2, 1))), (0, 2, 1))
    return x.astype(float)


def get_transform(center, scale, res, rot=0):
    """Hourglass crop transform: 3x3 matrix from source pixels into a
    ``res`` crop centered on ``center`` with extent 100*scale, with
    optional rotation about the CROP center
    (ref: CCSSL/transforms.py:32-59)."""
    h = 100 * scale
    t = np.zeros((3, 3))
    t[0, 0] = float(res[1]) / h
    t[1, 1] = float(res[0]) / h
    t[0, 2] = res[1] * (-float(center[0]) / h + 0.5)
    t[1, 2] = res[0] * (-float(center[1]) / h + 0.5)
    t[2, 2] = 1
    if rot != 0:
        rot = -rot  # match the cropping rotation direction
        rot_mat = np.zeros((3, 3))
        rot_rad = rot * np.pi / 180
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        rot_mat[2, 2] = 1
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = np.dot(t_inv, np.dot(rot_mat, np.dot(t_mat, t)))
    return t


def transform(pt, center, scale, res, invert=0, rot=0):
    """Map one pixel through ``get_transform`` with the reference's
    1-based offset + int truncation (ref: CCSSL/transforms.py:62-69)."""
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = np.array([pt[0] - 1, pt[1] - 1, 1.0]).T
    new_pt = np.dot(t, new_pt)
    return new_pt[:2].astype(int) + 1


def transform_preds(coords, center, scale, res):
    """Crop-frame joint coords -> source-image frame, per point
    (ref: CCSSL/transforms.py:72-78)."""
    coords = np.array(coords, dtype=float)
    for p in range(coords.shape[0]):
        coords[p, 0:2] = transform(coords[p, 0:2], center, scale, res,
                                   invert=1, rot=0)
    return coords


def adjust_learning_rate(lr, epoch, schedule, gamma=0.1):
    """StepLR exactly as the reference applies it: decay fires only in
    the epoch that IS a milestone — the caller threads the running lr
    through every epoch (ref: CCSSL/misc.py:49-55)."""
    if epoch in schedule:
        lr *= gamma
    return lr


def save_pred(preds, checkpoint="checkpoint", filename="preds_valid.mat"):
    """preds -> .mat (ref: CCSSL/misc.py:43-46)."""
    import scipy.io
    scipy.io.savemat(os.path.join(checkpoint, filename),
                     mdict={"preds": np.asarray(preds)})


def save_checkpoint(state, preds, is_best, checkpoint="checkpoint",
                    filename="checkpoint.npz", snapshot=None):
    """Running checkpoint + preds.mat + periodic snapshot + best copy
    (ref: CCSSL/misc.py:29-40; an .npz of a flat dict of arrays instead
    of torch .pth.tar, the JAX package's files)."""
    import scipy.io
    filepath = os.path.join(checkpoint, filename)
    np.savez(filepath, **{k: np.asarray(v) for k, v in state.items()})
    if not os.path.exists(filepath) and os.path.exists(filepath + ".npz"):
        filepath += ".npz"  # np.savez appends the suffix if absent
    scipy.io.savemat(os.path.join(checkpoint, "preds.mat"),
                     mdict={"preds": np.asarray(preds)})
    if snapshot and state["epoch"] % snapshot == 0:
        shutil.copyfile(filepath, os.path.join(
            checkpoint, "checkpoint_{}.npz".format(int(state["epoch"]))))
    if is_best:
        shutil.copyfile(filepath,
                        os.path.join(checkpoint, "model_best.npz"))
        scipy.io.savemat(os.path.join(checkpoint, "preds_best.mat"),
                         mdict={"preds": np.asarray(preds)})
