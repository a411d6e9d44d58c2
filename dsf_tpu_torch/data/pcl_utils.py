"""Host-side point-cloud utilities in numpy (counterpart of
dsf_tpu/data/pcl_utils.py; ref: render_loader.py:907-1033): depth ->
cloud, OBB/PCA normalization, farthest-point sampling, the joint ->
synthetic-cloud fallback, for point-cloud-based pipelines (e.g. exporting
clouds for downstream consumers).  Each random draw comes from a
``np.random.RandomState(seed)``, so a seed gives the JAX package's
points."""

from __future__ import annotations

import numpy as np


def depth_to_pcl(dpt, M, paras, flip=1.0, background_val=0.0):
    """Cropped depth image -> camera-space cloud (ref: depthToPCL,
    render_loader.py:997-1013): undo the crop matrix for valid pixels,
    then unproject."""
    fx, fy, fu, fv = paras
    rows, cols = np.where(~np.isclose(dpt, background_val))
    pts = np.stack([cols + 0.5, rows + 0.5, np.ones(len(rows))], axis=1)
    pts = (np.linalg.inv(np.asarray(M)) @ pts.T).T
    pts = pts[:, 0:2] / pts[:, 2:3]
    depth = dpt[rows, cols]
    x = (pts[:, 0] - fu) / fx * depth
    y = flip * (pts[:, 1] - fv) / fy * depth
    return np.column_stack([x, y, depth])


def get_pcl(imgD, com3D, cube, M, paras, flip=1.0):
    """Normalized crop -> normalized cloud (ref: getpcl,
    render_loader.py:966-976)."""
    dpt = imgD * cube[2] / 2.0 + com3D[2]
    dpt = np.where(imgD > 0.99, 0.0, dpt)
    pcl = depth_to_pcl(dpt, M, paras, flip) - com3D
    return pcl / (np.asarray(cube) / 2.0)


def farthest_point_sample(xyz, npoint, seed=0):
    """Greedy FPS (ref: farthest_point_sample, render_loader.py:978-995)."""
    rng = np.random.RandomState(seed)
    N = xyz.shape[0]
    if N < npoint:
        base = np.arange(N)
        extra = rng.choice(N, npoint - N, replace=True)
        return np.unique(np.concatenate([base, extra]))
    centroids = np.zeros(npoint, np.int64)
    distance = np.full(N, 1e10)
    farthest = rng.randint(0, N)
    for i in range(npoint):
        centroids[i] = farthest
        d = np.sum((xyz - xyz[farthest]) ** 2, -1)
        distance = np.minimum(distance, d)
        farthest = int(distance.argmax())
    return np.unique(centroids)


def joint_to_pc(joint, sample_num=512, radius=15.0, seed=0):
    """Synthesize a cloud around a skeleton when the depth cloud is
    empty (ref: joint2pc, render_loader.py:948-963)."""
    rng = np.random.RandomState(seed)
    J = joint.shape[0]
    r = rng.rand(J, 100) * radius
    theta = rng.rand(J, 100) * np.pi
    phi = rng.rand(J, 100) * np.pi
    offs = np.stack([r * np.sin(phi) * np.cos(theta),
                     r * np.sin(phi) * np.sin(theta),
                     r * np.cos(phi)], axis=-1)
    pts = (joint[:, None, :] + offs).reshape(-1, 3)
    sel = rng.choice(len(pts), sample_num, replace=False)
    return pts[sel]


def pca_point(pcl, joint, sample_num=512, seed=0):
    """OBB/PCA cloud normalization (ref: pca_point,
    render_loader.py:907-946): orient by PCA axes (with the reference's
    sign fixups), sample to fixed size, scale by the x-extent, center."""
    rng = np.random.RandomState(seed)
    if pcl.shape[0] < 10:
        pcl = joint_to_pc(joint, sample_num, seed=seed)
    mean = pcl.mean(0)
    cov = np.cov((pcl - mean).T)
    w, v = np.linalg.eigh(cov)
    coeff = v[:, np.argsort(w)[::-1]]
    if coeff[1, 0] < 0:
        coeff[:, 0] = -coeff[:, 0]
    if coeff[2, 2] < 0:
        coeff[:, 2] = -coeff[:, 2]
    coeff[:, 1] = np.cross(coeff[:, 2], coeff[:, 0])
    rot = pcl @ coeff
    jrot = joint @ coeff

    idx = np.arange(rot.shape[0])
    if rot.shape[0] < sample_num:
        mult = sample_num // rot.shape[0]
        idx = np.concatenate([np.tile(idx, mult),
                              rng.choice(idx, sample_num % rot.shape[0],
                                         replace=False)])
    idx = rng.choice(idx, sample_num, replace=False)
    sampled = rot[idx]

    scale = 1.2
    max_len = scale * (rot[:, 0].max() - rot[:, 0].min()) / 2.0
    sampled = sampled / max_len
    jnorm = jrot / max_len
    offset = (rot.mean(0) / max_len if rot.shape[0] < sample_num
              else sampled.mean(0))
    return sampled - offset, jnorm - offset, offset, coeff, max_len


def save_label(path, joints_world_uvd):
    """Export predicted labels (ref: save_label, render_loader.py:3454)."""
    np.savetxt(path, np.asarray(joints_world_uvd).reshape(
        len(joints_world_uvd), -1), fmt="%.3f")
