"""Depth rasterizer at crop pixels (counterpart of dsf_tpu/ops/rasterize.py).

Each crop pixel is mapped through M^-1 to its continuous full-frame
position and the nearest covering face is found there (blur=0,
faces_per_pixel=1, screen-space barycentric depth).  Per-face edge and
depth functions are linear in (u, v): ``e = a*u + b*v + c`` and
``z = az*u + bz*v + cz``, with the area sign folded into the edge
coefficients (inside test ``e >= 0``) and 1/A into the depth line.

``raster_scan`` is the plain PyTorch version, with the semantics of the
JAX package's ``_scan_minz``: faces in chunks, chunk-major strict ``<``
update, first argmin within a chunk — so the winner is the lowest face
index at the global minimum depth.  Every product and sum is rounded on
its own (no fused multiply-add), in the order written; the CUDA kernel
(``raster_kernel``, K1) repeats that order with round-to-nearest
intrinsics so the two are bitwise-equal on the same coefficients.

``raster_skip`` is the dispatch: the plain version for tensors on the
CPU, the K1 kernel for tensors on a GPU, an error otherwise.  Either runs
on gradient-stopped vertices; ``AttachRasterGrad`` then attaches the JAX
package's hard blur=0 gradient (``_attach_raster_grad``): through the hit
face's depth plane only, from the per-face moments of the cotangent (K2
on a GPU, ``index_add_`` on the CPU).  The pixel -> face assignment gets
no gradient.
"""

from __future__ import annotations

import torch

from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.ops import moments_kernel, raster_kernel

INF = 1e10
FACE_CHUNK = 256


def project_verts(verts, paras, flip=1.0):
    """World mm -> continuous pixel coords (u, v) + depth z."""
    return geo.xyz_to_uvd(verts, paras, flip)


def crop_pixel_rays(M, crop_size, stride=1):
    """Integer crop-pixel coords through M^-1 -> full-frame positions
    (..., (crop/stride)^2, 2), row-major over the crop.

    ``stride`` > 1 keeps every stride-th crop pixel (coords 0, s, 2s, ...),
    exactly the pixels a nearest downscale by ``stride`` keeps, so
    rastering at stride s equals rastering at stride 1 then
    resize_nearest, at 1/s^2 the pixels."""
    cw, ch = crop_size[0] // stride, crop_size[1] // stride
    dev = M.device
    v, u = torch.meshgrid(
        torch.arange(ch, dtype=torch.float32, device=dev) * stride,
        torch.arange(cw, dtype=torch.float32, device=dev) * stride,
        indexing="ij")
    pix = torch.stack([u.reshape(-1), v.reshape(-1),
                       torch.ones(cw * ch, dtype=torch.float32, device=dev)],
                      dim=-1)
    Minv = geo.inv_3x3(M)
    uv = geo.transform_points_2d(pix.expand(M.shape[:-2] + pix.shape), Minv)
    return uv[..., :2]


def face_coeffs(proj, faces):
    """Per-face linear edge and depth coefficients.

    proj (B, V, 3) projected verts; faces (F, 3) int64.  Returns
    a, b, c (B, F, 3); az, bz, cz (B, F); valid (B, F) bool.  Sums are
    written out term by term, left to right."""
    tri = proj[:, faces]                       # (B, F, 3, 3)
    u0, v0, z0 = tri[..., 0, 0], tri[..., 0, 1], tri[..., 0, 2]
    u1, v1, z1 = tri[..., 1, 0], tri[..., 1, 1], tri[..., 1, 2]
    u2, v2, z2 = tri[..., 2, 0], tri[..., 2, 1], tri[..., 2, 2]
    a = torch.stack([v1 - v2, v2 - v0, v0 - v1], dim=-1)
    b = torch.stack([u2 - u1, u0 - u2, u1 - u0], dim=-1)
    c = torch.stack([u1 * v2 - u2 * v1, u2 * v0 - u0 * v2,
                     u0 * v1 - u1 * v0], dim=-1)
    A = c[..., 0] + c[..., 1] + c[..., 2]      # 2x signed area
    valid = torch.abs(A) > 1e-9
    sgn = torch.sign(A)
    a, b, c = a * sgn[..., None], b * sgn[..., None], c * sgn[..., None]
    Ainv = torch.where(valid, 1.0 / torch.where(valid, A, torch.ones_like(A)),
                       torch.zeros_like(A))
    w = sgn * Ainv
    az = (a[..., 0] * z0 + a[..., 1] * z1 + a[..., 2] * z2) * w
    bz = (b[..., 0] * z0 + b[..., 1] * z1 + b[..., 2] * z2) * w
    cz = (c[..., 0] * z0 + c[..., 1] * z1 + c[..., 2] * z2) * w
    return a, b, c, az, bz, cz, valid


def raster_scan(proj, pix_uv, faces, chunk=FACE_CHUNK):
    """Plain raster: proj (B, V, 3), pix_uv (B, P, 2), faces (F, 3) ->
    zbuf (B, P) float32 (0 = background), idx (B, P) int32 (-1)."""
    a, b, c, az, bz, cz, valid = face_coeffs(proj, faces)
    B, P = pix_uv.shape[0], pix_uv.shape[1]
    F = faces.shape[0]
    u = pix_uv[..., 0:1]                       # (B, P, 1)
    v = pix_uv[..., 1:2]
    zmin = torch.full((B, P), INF, dtype=torch.float32, device=proj.device)
    idx = torch.full((B, P), -1, dtype=torch.int64, device=proj.device)
    for s in range(0, F, chunk):
        sl = slice(s, min(s + chunk, F))
        inside = valid[:, None, sl]
        for k in range(3):
            e = (u * a[:, None, sl, k] + v * b[:, None, sl, k]
                 + c[:, None, sl, k])
            inside = inside & (e >= 0)
        z = u * az[:, None, sl] + v * bz[:, None, sl] + cz[:, None, sl]
        z = torch.where(inside & (z > 0), z, torch.full_like(z, INF))
        cmin, carg = torch.min(z, dim=-1)      # first index of the minimum
        better = cmin < zmin
        zmin = torch.where(better, cmin, zmin)
        idx = torch.where(better, carg + s, idx)
    hit = zmin < INF
    zbuf = torch.where(hit, zmin, torch.zeros_like(zmin))
    idx = torch.where(hit, idx, torch.full_like(idx, -1))
    return zbuf, idx.to(torch.int32)


def skip_tables(proj, faces):
    """The K1 kernel's inputs: per-face rows (B, F, 16) = [a0 b0 c0 a1 b1
    c1 a2 b2 c2 az bz cz valid 0 0 0] and per-chunk bboxes (B, nc, 4) =
    [umin umax vmin vmax] over ``raster_kernel.CHUNK`` faces (invalid
    faces widen no bbox; a chunk with none is empty: +inf > -inf)."""
    a, b, c, az, bz, cz, valid = face_coeffs(proj, faces)
    B, F = valid.shape
    z = torch.zeros_like(az)
    rows = torch.stack([a[..., 0], b[..., 0], c[..., 0],
                        a[..., 1], b[..., 1], c[..., 1],
                        a[..., 2], b[..., 2], c[..., 2],
                        az, bz, cz, valid.to(az.dtype), z, z, z], dim=-1)
    tri_uv = proj[:, faces][..., :2]           # (B, F, 3, 2)
    inf = torch.tensor(float("inf"), dtype=proj.dtype, device=proj.device)
    fmin = torch.where(valid[..., None], tri_uv.amin(2), inf)
    fmax = torch.where(valid[..., None], tri_uv.amax(2), -inf)
    fc = raster_kernel.CHUNK
    pad = (-F) % fc
    if pad:
        fmin = torch.cat([fmin, inf.expand(B, pad, 2)], dim=1)
        fmax = torch.cat([fmax, (-inf).expand(B, pad, 2)], dim=1)
    cmin = fmin.reshape(B, -1, fc, 2).amin(2)  # (B, nc, 2)
    cmax = fmax.reshape(B, -1, fc, 2).amax(2)
    cbox = torch.stack([cmin[..., 0], cmax[..., 0],
                        cmin[..., 1], cmax[..., 1]], dim=-1)
    return rows.contiguous(), cbox.contiguous()


def face_moments(idx, upd, num_faces):
    """Per-face sums of the rows upd (B, P, 3) over the pixels of each face
    id in idx (B, P): the plain version for CPU tensors, K2 for GPU
    tensors."""
    if idx.device.type == "cpu":
        return moments_kernel.face_moments_plain(idx, upd, num_faces)
    if idx.device.type == "cuda":
        return moments_kernel.face_moments_cuda(
            idx.to(torch.int32).contiguous(), upd.float().contiguous(),
            num_faces)
    raise ValueError(f"no moments path for device {idx.device}")


def face_sum(proj, faces, mom):
    """sum over faces t of (az_t Su_t + bz_t Sv_t + cz_t S1_t), with the
    depth-plane coefficients of ``face_coeffs`` (already divided by the
    face's doubled area, zero for degenerate faces): the cotangent-weighted
    depth sum of every covered pixel, written through the per-face moments
    mom (B, T, 3) = [S1, Su, Sv].  Its gradient in ``proj`` is the
    raster's (ref: face_sum in rasterize._attach_bwd)."""
    _, _, _, az, bz, cz, _ = face_coeffs(proj, faces)
    return (az * mom[..., 1] + bz * mom[..., 2] + cz * mom[..., 0]).sum()


class AttachRasterGrad(torch.autograd.Function):
    """Identity on zbuf (B, P) that attaches the raster's gradient with
    respect to proj (B, V, 3) (ref: rasterize._attach_raster_grad).

    Backward: the rows [g*hit, g*hit*u, g*hit*v] of every pixel, their
    per-face moments (B, T, 3) keyed by the winning face id, and
    d proj = grad of ``face_sum`` at those moments.  The depth of a face is
    linear in the pixel position, so the three moments carry all of the
    cotangent that reaches it.  pix_uv, idx and faces get no gradient."""

    @staticmethod
    def forward(ctx, proj, zbuf, idx, pix_uv, faces):
        ctx.save_for_backward(proj, idx, pix_uv, faces)
        return zbuf.clone()

    @staticmethod
    def backward(ctx, g):
        proj, idx, pix_uv, faces = ctx.saved_tensors
        gm = g * (idx >= 0).to(g.dtype)
        upd = torch.stack([gm, gm * pix_uv[..., 0], gm * pix_uv[..., 1]],
                          dim=-1)
        mom = face_moments(idx, upd, faces.shape[0])
        with torch.enable_grad():
            p = proj.detach().requires_grad_(True)
            (dproj,) = torch.autograd.grad(face_sum(p, faces, mom), p)
        return dproj, None, None, None, None


def raster_skip(proj, pix_uv, faces, layout_hw):
    """Nearest-face depth and face id at each sample position:
    zbuf (B, P), differentiable in ``proj`` with the hard blur=0 gradient,
    and idx (B, P) int32.

    ``layout_hw`` (H, W): pix_uv is row-major over an H x W pixel grid,
    which the kernel tiles 16 x 16.  CPU tensors take ``raster_scan``;
    CUDA tensors launch the K1 kernel (``raster_kernel.raster_skip_cuda``).
    Both run on the detached vertices."""
    with torch.no_grad():
        p = proj.detach()
        if p.device.type == "cpu":
            zbuf, idx = raster_scan(p, pix_uv, faces)
        elif p.device.type == "cuda":
            rows, cbox = skip_tables(p, faces)
            zbuf, idx = raster_kernel.raster_skip_cuda(
                rows, cbox, pix_uv.contiguous(), layout_hw)
        else:
            raise ValueError(f"no raster path for device {proj.device}")
    if torch.is_grad_enabled() and proj.requires_grad:
        zbuf = AttachRasterGrad.apply(proj, zbuf, idx, pix_uv, faces)
    return zbuf, idx
