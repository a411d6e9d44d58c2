"""Camera / crop / normalized-coordinate geometry (counterpart of
dsf_tpu/geometry.py), on torch tensors.

Conventions are the JAX package's: ``paras = (fx, fy, fu, fv)``; ``uvd``
is (column, row, depth mm); ``xyz`` camera mm; ``flip`` multiplies the
y-axis; crop matrices ``M`` map full-frame pixels to crop pixels.  Every
function broadcasts over leading batch dimensions and keeps the JAX
package's operation order, so float32 results agree to rounding.
"""

from __future__ import annotations

import torch


def div(x, c):
    """``x / c`` for a float32 or float64 ``x`` and a Python number ``c``,
    divided on ``x``'s device as the CPU divides: CUDA takes a Python
    divisor as a product with its rounded reciprocal, which moves the
    floor, nearest sample or tie that follows off the CPU's (and JAX's)."""
    return x / torch.full((), float(c), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# camera projection
# ---------------------------------------------------------------------------

def uvd_to_xyz(uvd, paras, flip=1.0):
    """Image coords -> camera-space mm (ref: jointImgTo3D)."""
    fx, fy, fu, fv = paras
    x = div((uvd[..., 0] - fu) * uvd[..., 2], fx)
    y = div(flip * (uvd[..., 1] - fv) * uvd[..., 2], fy)
    return torch.stack([x, y, uvd[..., 2]], dim=-1)


def xyz_to_uvd(xyz, paras, flip=1.0):
    """Camera-space mm -> image coords (ref: joint3DToImg), with the
    reference's +1e-8 on z."""
    fx, fy, fu, fv = paras
    z = xyz[..., 2]
    u = xyz[..., 0] * fx / (z + 1e-8) + fu
    v = flip * xyz[..., 1] * fy / (z + 1e-8) + fv
    return torch.stack([u, v, z], dim=-1)


# ---------------------------------------------------------------------------
# crop bounds and matrices
# ---------------------------------------------------------------------------

def com_to_bounds(com, size, paras):
    """Center-of-mass + cube -> crop bounds, with the reference's
    ``floor(. + 0.5)`` pixel snapping (ref: comToBounds)."""
    fx, fy, _, _ = paras
    cx, cy, cz = com[..., 0], com[..., 1], com[..., 2]
    sx, sy, sz = size[..., 0], size[..., 1], size[..., 2]
    zstart = cz - sz / 2.0
    zend = cz + sz / 2.0
    xstart = torch.floor((div(cx * cz, fx) - sx / 2.0) / cz * fx + 0.5)
    xend = torch.floor((div(cx * cz, fx) + sx / 2.0) / cz * fx + 0.5)
    ystart = torch.floor((div(cy * cz, fy) - sy / 2.0) / cz * fy + 0.5)
    yend = torch.floor((div(cy * cz, fy) + sy / 2.0) / cz * fy + 0.5)
    return xstart, xend, ystart, yend, zstart, zend


def bounds_to_trans(xstart, xend, ystart, yend, crop_size):
    """Bounds -> 3x3 crop matrix, keeping the render-side integer
    truncations of the reference's Offset2Trans."""
    cw, ch = float(crop_size[0]), float(crop_size[1])
    wb = xend - xstart
    hb = yend - ystart
    w_gt_h = wb > hb

    s = torch.where(w_gt_h, cw / wb, ch / hb)
    sz0 = torch.where(w_gt_h, torch.full_like(wb, cw),
                      torch.trunc(wb * cw / hb))
    sz1 = torch.where(w_gt_h, torch.trunc(hb * cw / wb),
                      torch.full_like(hb, ch))

    offx = torch.floor(cw / 2.0 - sz0 / 2.0)
    offy = torch.floor(ch / 2.0 - sz1 / 2.0)

    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    m02 = s * (-xstart) + offx
    m12 = s * (-ystart) + offy
    row0 = torch.stack([s, zeros, m02], dim=-1)
    row1 = torch.stack([zeros, s, m12], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def crop_matrix(com_uvd, cube, paras, crop_size):
    """com (uvd) + cube -> 3x3 crop matrix (comToBounds ∘ Offset2Trans)."""
    xs, xe, ys, ye, _, _ = com_to_bounds(com_uvd, cube, paras)
    return bounds_to_trans(xs, xe, ys, ye, crop_size)


def inv_3x3(M):
    """Closed-form (adjugate) inverse of (..., 3, 3) matrices."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            A, -(b * i - c * h), b * f - c * e,
            B, a * i - c * g, -(a * f - c * d),
            C, -(a * h - b * g), a * e - b * d,
        ],
        dim=-1,
    ).reshape(M.shape)
    return adj / det[..., None, None]


def transform_points_2d(pts, M):
    """Apply a 3x3 matrix to the uv part of (..., N, 3) points, keep d
    (affine use, no perspective divide; written elementwise so the
    products stay full float32 on every backend)."""
    Mb = M[..., None, :, :]
    u, v = pts[..., 0], pts[..., 1]
    un = Mb[..., 0, 0] * u + Mb[..., 0, 1] * v + Mb[..., 0, 2]
    vn = Mb[..., 1, 0] * u + Mb[..., 1, 1] * v + Mb[..., 1, 2]
    return torch.stack([un, vn, pts[..., 2]], dim=-1)


# ---------------------------------------------------------------------------
# depth normalization
# ---------------------------------------------------------------------------

def normalize_depth(img, com_z, cube_z):
    """Depth (mm, 0/-1 = background) -> [-1, 1], background at +1
    (ref: Render.normalize_img).  ``img`` (..., H, W); ``com_z`` and
    ``cube_z`` broadcast over the leading dims."""
    com_z = torch.as_tensor(com_z, dtype=img.dtype,
                            device=img.device)[..., None, None]
    cube_z = torch.as_tensor(cube_z, dtype=img.dtype,
                             device=img.device)[..., None, None]
    z_min = com_z - cube_z / 2.0
    z_max = com_z + cube_z / 2.0
    img = torch.where((img == -1) | (img == 0), z_max, img)
    img = torch.minimum(torch.maximum(img, z_min), z_max)
    return (img - com_z) / (cube_z / 2.0)


# ---------------------------------------------------------------------------
# normalized crop coords <-> normalized camera coords
# ---------------------------------------------------------------------------

def uvd_nl_to_xyz(uvd_nl, center, M, cube, paras, img_size, flip=1.0):
    """Normalized crop uvd -> camera xyz in mm (ref: uvd_nl2xyz_tensor)."""
    Minv = inv_3x3(M)
    uv = (uvd_nl[..., 0:2] + 1.0) * (img_size / 2.0)
    d = uvd_nl[..., 2:3] * (cube[..., None, 2:3] / 2.0) + center[..., None, 2:3]
    uvd = torch.cat([uv, d], dim=-1)
    uvd_ff = transform_points_2d(uvd, Minv)
    return uvd_to_xyz(uvd_ff, paras, flip)


def uvd_nl_to_xyz_nl(uvd_nl, center, M, cube, paras, img_size, flip=1.0):
    """Normalized crop uvd -> normalized camera xyz (ref:
    uvd_nl2xyznl_tensor)."""
    xyz = uvd_nl_to_xyz(uvd_nl, center, M, cube, paras, img_size, flip)
    return (xyz - center[..., None, :]) / (cube[..., None, :] / 2.0)


def xyz_nl_to_uvd_nl(xyz_nl, center, M, cube, paras, img_size, flip=1.0):
    """Normalized camera xyz -> normalized crop uvd (ref:
    xyz_nl2uvdnl_tensor)."""
    xyz = xyz_nl * (cube[..., None, :] / 2.0) + center[..., None, :]
    uvd = xyz_to_uvd(xyz, paras, flip)
    uvd_c = transform_points_2d(uvd, M)
    uv_nl = div(uvd_c[..., 0:2], img_size) * 2.0 - 1.0
    d_nl = (uvd_c[..., 2:3] - center[..., None, 2:3]) / (cube[..., None, 2:3] / 2.0)
    return torch.cat([uv_nl, d_nl], dim=-1)


def joint_trans(joint_xyz, M, com_uvd, cube, paras, crop_size, flip=1.0):
    """World xyz (mm) -> normalized crop uvd (ref: Render.JointTrans)."""
    uvd = xyz_to_uvd(joint_xyz, paras, flip)
    uvd_c = transform_points_2d(uvd, M)
    uv_nl = div(uvd_c[..., 0:2], crop_size) * 2.0 - 1.0
    d_nl = (uvd[..., 2:3] - com_uvd[..., None, 2:3]) / (cube[..., None, 2:3] / 2.0)
    return torch.cat([uv_nl, d_nl], dim=-1)


# ---------------------------------------------------------------------------
# pixel grids
# ---------------------------------------------------------------------------

def norm_grid_center(n, dtype=torch.float32, device=None):
    """Pixel-centre normalized grid: (i + 0.5) / n * 2 - 1, as the offset
    codec reads it (ref: generateFeature.py:22-23).  Returns (xx, yy), each
    (n, n), xx varying along axis 1 (u)."""
    r = div(torch.arange(n, dtype=dtype, device=device) + 0.5, n) * 2.0 - 1.0
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    return xx, yy


def norm_grid_corner(n, dtype=torch.float32, device=None):
    """Corner-anchored normalized grid: i / (n - 1) * 2 - 1, as Img2pcl and
    uvdImg2xyzImg read it (ref: render_loader.py:1126-1127).  Returns (xx,
    yy), each (n, n), xx varying along axis 1 (u)."""
    r = div(torch.arange(n, dtype=dtype, device=device), n - 1.0) * 2.0 - 1.0
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    return xx, yy


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

def quat_to_mat(quat):
    """Quaternion (w, x, y, z) -> rotation matrix, normalizing first
    (ref: quat2mat)."""
    q = quat / torch.sqrt((quat * quat).sum(-1, keepdim=True))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def rodrigues(theta):
    """Axis-angle (..., 3) -> rotation matrix via the half-angle
    quaternion, with the reference's norm(theta + 1e-8) (ref:
    batch_rodrigues)."""
    t = theta + 1e-8
    angle = torch.sqrt((t * t).sum(-1, keepdim=True))
    normalized = theta / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=-1)
    return quat_to_mat(quat)


def rotate_points_about(points, center, rot_vec):
    """Rotate (..., N, 3) points about ``center`` (..., 3) by the
    axis-angle ``rot_vec`` (..., 3) (ref: RotationPoints).  The products
    are written out elementwise, so they stay full float32 on every
    backend."""
    R = rodrigues(rot_vec)[..., None, :, :]               # (..., 1, 3, 3)
    p = points - center[..., None, :]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    p = torch.stack([R[..., i, 0] * x + R[..., i, 1] * y + R[..., i, 2] * z
                     for i in range(3)], dim=-1)
    return p + center[..., None, :]
