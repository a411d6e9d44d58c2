"""Exact point -> triangle squared distances (counterpart of
dsf_tpu/ops/point_mesh.py; ref: metric/meshLoss.py:21-269, pytorch3d's
point_face_dist kernels).

Two passes:

1. argmin (no gradient): per point, the nearest face, optionally under a
   factorized admissibility mask — a (T, K) face-to-part table plus a
   per-point part id, so the part-aware loss reuses the same pass without
   a (P x T) mask.  CPU tensors take the plain version
   ``argmin_faces_plain``; CUDA tensors launch K3
   (``point_mesh_kernel.argmin_faces_cuda``).
2. differentiable: gather the winning triangle of each point and
   evaluate the exact distance on it, so gradients flow through the
   closest face only (pytorch3d's hard backward).

Distances are squared and per point: the reference's
point_mesh_face_distance returns them early (meshLoss.py:266-269), a quirk
that is kept.
"""

from __future__ import annotations

import torch

from dsf_tpu_torch.ops import point_mesh_kernel

INF = 1e10
CHUNK = 128          # faces per step of the plain argmin


def point_tri_sqdist(p, tri):
    """Exact squared distance from points p (..., 3) to triangles
    tri (..., 3, 3), elementwise over the leading dims (Ericson's
    closest-point region analysis, every region evaluated and selected)."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    denom_uv = va + vb + vc

    eps = 1e-12

    def safe(x):
        return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)

    v_ab = d1 / safe(d1 - d3)
    v_ac = d2 / safe(d2 - d6)
    v_bc = (d4 - d3) / safe((d4 - d3) + (d5 - d6))
    denom = safe(denom_uv)
    v_f = vb / denom
    w_f = vc / denom

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    q = a + v_f[..., None] * ab + w_f[..., None] * ac
    q = torch.where(on_bc[..., None],
                    b + torch.clamp(v_bc, 0, 1)[..., None] * (c - b), q)
    q = torch.where(on_ac[..., None],
                    a + torch.clamp(v_ac, 0, 1)[..., None] * ac, q)
    q = torch.where(on_ab[..., None],
                    a + torch.clamp(v_ab, 0, 1)[..., None] * ab, q)
    q = torch.where(in_c[..., None], c, q)
    q = torch.where(in_b[..., None], b, q)
    q = torch.where(in_a[..., None], a, q)
    diff = p - q
    return (diff * diff).sum(-1)


def _extend_part_tables(part_mask, point_part):
    """Append an all-False part column so that point parts outside [0, K)
    admit no face: part_mask (T, K) bool -> (T, K + 1); point_part (B, P)
    -> (B, P) int64 in [0, K]."""
    T, K = part_mask.shape
    ext = torch.cat([part_mask, part_mask.new_zeros(T, 1)], dim=1)
    pp = torch.where((point_part >= 0) & (point_part < K), point_part,
                     torch.full_like(point_part, K))
    return ext, pp.long()


def argmin_faces_plain(points, tris, part_mask=None, point_part=None):
    """The plain version of K3: per-point nearest face, no gradients.

    points (B, P, 3), tris (B, T, 3, 3); optional factorized mask
    part_mask (T, K) bool + point_part (B, P) int: face t is admissible for
    point p iff part_mask[t, point_part[p]].  Returns (dmin (B, P),
    imin (B, P) int32).  Faces go in chunks of 128: the first minimum within
    a chunk, a strict ``<`` between chunks, so the lowest index of the
    least distance wins.  A point that admits no face keeps dmin = 1e10 and
    imin = 0 (the initial values: 1e10 < 1e10 is false)."""
    B, P, _ = points.shape
    T = tris.shape[1]
    points, tris = points.detach(), tris.detach()
    if part_mask is not None:
        ext, pp = _extend_part_tables(part_mask.bool(), point_part)
    dmin = torch.full((B, P), INF, dtype=points.dtype, device=points.device)
    imin = torch.zeros((B, P), dtype=torch.int32, device=points.device)
    for s in range(0, T, CHUNK):
        d = point_tri_sqdist(points[:, :, None], tris[:, None, s:s + CHUNK])
        if part_mask is not None:
            allowed = ext[s:s + CHUNK].T[pp]                # (B, P, chunk)
            d = torch.where(allowed, d, torch.full_like(d, INF))
        cmin = d.min(-1).values
        carg = torch.argmin(d, -1).to(torch.int32) + s
        better = cmin < dmin
        dmin = torch.where(better, cmin, dmin)
        imin = torch.where(better, carg, imin)
    return dmin, imin


def argmin_faces(points, tris, part_mask=None, point_part=None):
    """The argmin pass: the plain version for CPU tensors, K3 for CUDA
    tensors.  Returns (dmin, imin) as ``argmin_faces_plain`` does; K3's
    dmin is its divide-free distance (see csrc/point_mesh.cu)."""
    if points.device.type == "cpu":
        return argmin_faces_plain(points, tris, part_mask, point_part)
    if points.device.type == "cuda":
        return point_mesh_kernel.argmin_faces_cuda(points, tris, part_mask,
                                                   point_part)
    raise ValueError(f"no point-mesh path for device {points.device}")


def point_face_distance(points, verts, faces, part_mask=None,
                        point_part=None):
    """Per-point squared distance to the nearest (admissible) face.

    points (B, P, 3); verts (B, V, 3); faces (T, 3) int; optional
    part_mask (T, K) bool + point_part (B, P) int.  Differentiable in
    points and verts through the winning face only: the argmin runs
    without gradient, the winner is gathered and its distance evaluated
    again with ``point_tri_sqdist``."""
    tris = verts[:, faces]                                   # (B, T, 3, 3)
    with torch.no_grad():
        _, imin = argmin_faces(points.detach(), tris.detach(), part_mask,
                               point_part)
    B, P = imin.shape
    win = torch.gather(tris, 1, imin.long()[..., None, None].expand(B, P, 3, 3))
    return point_tri_sqdist(points, win)
