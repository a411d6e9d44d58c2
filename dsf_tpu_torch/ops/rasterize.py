"""Depth rasterizer at sample positions (counterpart of
dsf_tpu/ops/rasterize.py).

Each sample position (a crop pixel mapped through M^-1 to its continuous
full-frame position, or a full-frame pixel) is tested against every face
covering it (blur=0, faces_per_pixel=1, screen-space barycentric depth).
Per-face edge and depth functions are linear in (u, v):
``e = a*u + b*v + c`` and ``z = az*u + bz*v + cz``, with the area sign
folded into the edge coefficients (inside test ``e >= 0``) and 1/A into
the depth line.  A face covers a sample where it is valid and its three
rounded edge values are >= 0: the JAX package's coverage, nothing more.

Every raster below skips faces by box: a face whose cover box
(``cover_boxes``) misses a sample covers it nowhere.  The cover box holds
the face's screen box and every sample its rounded edge test can pass,
with a bound on the rounding worked out from the face's own edge
coefficients; near a needle (a face a few thousandths of a pixel wide)
that test passes samples pixels beyond the tip, so no fixed margin would
hold.  So each cull is exact by construction.

``raster_scan`` is the plain dense raster, with the semantics of the JAX
package's ``_scan_minz``: faces in chunks, chunk-major strict ``<``
update, first argmin within a chunk, so the winner is the lowest face
index at the global minimum depth.  Every product and sum is rounded on
its own (no fused multiply-add), in the order written; the CUDA kernels
repeat that order with round-to-nearest intrinsics, so each is
bitwise-equal to its plain version on the same face rows.

``rasterize_depth`` is the public entry, with the JAX package's dispatch
(``_raster_forward``, dsf_tpu/ops/rasterize.py:420-440) over three routes:

- skip (``USE_PALLAS_SKIP`` and a known 16-aligned pixel layout): K1,
  ``raster_kernel.raster_skip_cuda`` (the face set-up on the card, then
  4x16 pixel tiles, each culling per face by bounding box);
- binned (``tile_hw`` given): K10, ``raster_kernel.raster_binned_cuda``
  (per 16x16 tile, the faces whose bbox meets the tile's, at most
  ``BIN_CAP``; the dense answer for every tile when any tile overflows:
  K1's set-up plus the tiles' boxes and counts on the card, then K1's
  body over 4x16 blocks limited to their tile's list);
- dense (otherwise, as for a full frame): K6,
  ``raster_kernel.raster_dense_cuda`` (K1's design over blocks of 128
  consecutive samples).

The route depends on the switches and the shapes alone; the device only
picks the kernel (CUDA tensors) or its plain version (CPU tensors), so
the CPU runs the plain version of the kernel the card would run.  The
skip and binned routes, the serving path's, go through the custom ops
``dsf::raster_skip`` and ``dsf::raster_binned`` (``kernels/custom_ops``),
whose CUDA and CPU implementations are that pair, so that an exported
program holds them.  (JAX's
``_skip_eligible`` also asks for a non-CPU backend; its dense route asks
``USE_PALLAS_RASTER`` whether to take its Pallas kernel or an XLA scan.
The port's only other dense raster is the plain version, so on a card the
dense route is always K6.)

Every route runs on gradient-stopped vertices; ``AttachRasterGrad`` then
attaches the JAX package's hard blur=0 gradient (``_attach_raster_grad``):
through the hit face's depth plane only, from the per-face moments of the
cotangent (K2 on a GPU, ``index_add_`` on the CPU).  The pixel -> face
assignment gets no gradient.
"""

from __future__ import annotations

import torch

from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.kernels import custom_ops
from dsf_tpu_torch.ops import moments_kernel, raster_kernel

INF = 1e10
FACE_CHUNK = 256
SCAN_PAIRS = 1 << 23   # (pixel, face) pairs per step of the plain scan
# the cover box's bounds (``cover_boxes``; csrc/raster_setup.cuh)
COVER_REL = 2.0 ** -22  # > the relative error of fl(fl(u*a) + fl(v*b))
COVER_ABS = 2.0 ** -140  # > its absolute error where a product underflows
COVER_SIN = 2.0 ** -16  # least |sin| of two edges' angle for a finite box
COVER_PAD = 2.0 ** -10  # px, and 2^-20 of the coordinate: float64's error
COVER_PAD_REL = 2.0 ** -20  # and the cast to float32

# the JAX package's switches (dsf_tpu/ops/rasterize.py:253-254, :398-400)
USE_PALLAS_SKIP = True
SKIP_BLOCK = (16, 16)  # K1's pixel tile
SKIP_FC = 64           # the TPU skip kernel's face chunk (_skip_eligible)
BIN_TILE = raster_kernel.BIN_TILE  # K10's pixel tile (16 x 16)
BIN_CAP = raster_kernel.BIN_CAP    # K10's faces per tile (512)


def project_verts(verts, paras, flip=1.0):
    """World mm -> continuous pixel coords (u, v) + depth z."""
    return geo.xyz_to_uvd(verts, paras, flip)


def full_frame_pixel_rays(img_size, device=None):
    """Integer pixel grid (u, v) of a (W, H) full frame -> (H*W, 2),
    row-major."""
    W, H = img_size
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)


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


def face_rows(proj, faces):
    """Per-face rows (B, F, 16) = [a0 b0 c0 a1 b1 c1 a2 b2 c2 az bz cz
    valid 0 0 0] of ``face_coeffs``: the input of every raster kernel and
    of the plain scans."""
    a, b, c, az, bz, cz, valid = face_coeffs(proj, faces)
    z = torch.zeros_like(az)
    return torch.stack([a[..., 0], b[..., 0], c[..., 0],
                        a[..., 1], b[..., 1], c[..., 1],
                        a[..., 2], b[..., 2], c[..., 2],
                        az, bz, cz, valid.to(az.dtype), z, z, z],
                       dim=-1).contiguous()


def _depth_or_inf(u, v, r):
    """u, v (N, p, 1) against rows r (N, 1, f, 16) -> (N, p, f): the depth
    where the sample lies inside a valid face in front of the camera, INF
    elsewhere.  Each product and sum rounded on its own, left to right."""
    inside = r[..., 12] != 0
    for k in range(3):
        e = u * r[..., 3 * k] + v * r[..., 3 * k + 1] + r[..., 3 * k + 2]
        inside = inside & (e >= 0)
    z = u * r[..., 9] + v * r[..., 10] + r[..., 11]
    return torch.where(inside & (z > 0), z, torch.full_like(z, INF))


def scan_rows(rows, pix_uv, chunk=FACE_CHUNK):
    """The plain dense scan over face rows (N, F, 16) at samples pix_uv
    (N, P, 2) -> (zbuf (N, P) float32, 0 = background; idx (N, P) int32,
    -1).  Faces in chunks of ``chunk`` (first minimum within a chunk, a
    strict ``<`` between chunks), samples in chunks that keep each step
    near ``SCAN_PAIRS`` pairs, which changes no sample's arithmetic."""
    N, P = pix_uv.shape[0], pix_uv.shape[1]
    F = rows.shape[1]
    pc = max(1, SCAN_PAIRS // max(1, N * min(chunk, F)))
    zs, ids = [], []
    for p0 in range(0, P, pc):
        u = pix_uv[:, p0:p0 + pc, 0:1]              # (N, p, 1)
        v = pix_uv[:, p0:p0 + pc, 1:2]
        zmin = torch.full(u.shape[:2], INF, dtype=torch.float32,
                          device=rows.device)
        idx = torch.full(u.shape[:2], -1, dtype=torch.int64,
                         device=rows.device)
        for s in range(0, F, chunk):
            z = _depth_or_inf(u, v, rows[:, None, s:s + chunk])
            cmin, carg = torch.min(z, dim=-1)       # first index of the min
            better = cmin < zmin
            zmin = torch.where(better, cmin, zmin)
            idx = torch.where(better, carg + s, idx)
        zs.append(zmin)
        ids.append(idx)
    zmin, idx = torch.cat(zs, 1), torch.cat(ids, 1)
    hit = zmin < INF
    zbuf = torch.where(hit, zmin, torch.zeros_like(zmin))
    idx = torch.where(hit, idx, torch.full_like(idx, -1))
    return zbuf, idx.to(torch.int32)


def raster_scan(proj, pix_uv, faces, chunk=FACE_CHUNK):
    """Plain dense raster, the plain version of K1 and K6: proj (B, V, 3),
    pix_uv (B, P, 2), faces (F, 3) -> zbuf (B, P) float32 (0 =
    background), idx (B, P) int32 (-1).

    Samples that lie outside every image's union of its faces' cover
    boxes (``cover_boxes``) are covered by no face and are background
    without a test.  The others go through ``scan_rows`` (on a full frame,
    a hand covers a few percent of it)."""
    rows, boxes, _ = skip_tables(proj, faces)
    lo = torch.stack([boxes[..., 0].amin(1), boxes[..., 2].amin(1)], -1)
    hi = torch.stack([boxes[..., 1].amax(1), boxes[..., 3].amax(1)], -1)
    near = ((pix_uv >= lo[:, None]) & (pix_uv <= hi[:, None])).all(-1).any(0)
    if bool(near.all()):
        return scan_rows(rows, pix_uv, chunk)
    B, P = pix_uv.shape[0], pix_uv.shape[1]
    zbuf = torch.zeros((B, P), dtype=torch.float32, device=proj.device)
    idx = torch.full((B, P), -1, dtype=torch.int32, device=proj.device)
    sel = torch.nonzero(near).squeeze(1)
    if sel.numel():
        z, i = scan_rows(rows, pix_uv[:, sel], chunk)
        zbuf = zbuf.to(z.dtype)
        zbuf[:, sel] = z
        idx[:, sel] = i
    return zbuf, idx


def _face_bounds(proj, faces, rows):
    """Each face's screen box corners lo, hi (B, F, 2) = (umin, vmin),
    (umax, vmax); +inf, -inf for an invalid face (``rows[..., 12]``)."""
    valid = (rows[..., 12] != 0)[..., None]
    tri_uv = proj[:, faces][..., :2]                      # (B, F, 3, 2)
    inf = torch.full_like(tri_uv[..., 0, :], float("inf"))
    return (torch.where(valid, tri_uv.amin(2), inf),
            torch.where(valid, tri_uv.amax(2), -inf))


def cover_boxes(rows, lo, hi):
    """Each face's cover box (B, F, 4) = [umin umax vmin vmax] from its
    rows (``face_rows``) and screen box lo, hi (``_face_bounds``): a box
    that holds the screen box and every finite sample (u, v) at which the
    face's rounded edge test (``_depth_or_inf``) passes, so that a raster
    may skip a face whose cover box misses its samples.  +inf, -inf for an
    invalid face, which covers nothing.

    fl(s + c) >= 0 exactly when s + c >= 0, and s = fl(fl(u*a) + fl(v*b))
    lies within (2^-23 + 2^-48) (|u*a| + |v*b|) + 2^-149 of u*a + v*b.  So
    an edge passes only where a*u + b*v + c >= -COVER_REL (|a u| + |b v|)
    - COVER_ABS: in the quadrant of the plane where u has the sign su and
    v the sign sv, the half-plane (a + su COVER_REL |a|) u + (b + sv
    COVER_REL |b|) v + c + COVER_ABS >= 0.  A face's three such
    half-planes meet in a triangle (or nothing) whose corners are where
    their lines meet pairwise.  The cover box is the union of the screen
    box and the four quadrants' corners, in float64, each side moved out by
    COVER_PAD + COVER_PAD_REL |x| and rounded to float32.  Where two edges
    are within COVER_SIN of parallel, or the three do not close a
    triangle, or a corner is not finite, the box is the whole plane.  The
    set-up kernel (csrc/raster_setup.cuh:cover_box) repeats every
    operation in this order."""
    f64 = torch.float64
    a, b = rows[..., 0:9:3].to(f64), rows[..., 1:9:3].to(f64)
    c = rows[..., 2:9:3].to(f64) + COVER_ABS
    ga, gb = a.abs() * COVER_REL, b.abs() * COVER_REL
    umin, vmin = lo[..., 0].to(f64), lo[..., 1].to(f64)
    umax, vmax = hi[..., 0].to(f64), hi[..., 1].to(f64)
    ok = torch.ones_like(umin, dtype=torch.bool)
    for su in (-1.0, 1.0):
        ap = a + ga * su
        for sv in (-1.0, 1.0):
            bp = b + gb * sv
            side = []
            for j, k in ((0, 1), (1, 2), (2, 0)):
                p, q = ap[..., j] * bp[..., k], ap[..., k] * bp[..., j]
                det = p - q
                u = (bp[..., j] * c[..., k] - bp[..., k] * c[..., j]) / det
                v = (ap[..., k] * c[..., j] - ap[..., j] * c[..., k]) / det
                ok &= ((det.abs() > (p.abs() + q.abs()) * COVER_SIN)
                       & u.isfinite() & v.isfinite())
                side.append(det > 0)
                umin, umax = torch.minimum(umin, u), torch.maximum(umax, u)
                vmin, vmax = torch.minimum(vmin, v), torch.maximum(vmax, v)
            ok &= (side[0] == side[1]) & (side[1] == side[2])

    def pad(x):
        return COVER_PAD + x.abs() * COVER_PAD_REL

    box = torch.stack([umin - pad(umin), umax + pad(umax),
                       vmin - pad(vmin), vmax + pad(vmax)], -1).float()
    inf = float("inf")
    whole = box.new_tensor([-inf, inf, -inf, inf])
    empty = box.new_tensor([inf, -inf, inf, -inf])
    box = torch.where(ok[..., None], box, whole)
    return torch.where((rows[..., 12] != 0)[..., None], box, empty)


def skip_tables(proj, faces):
    """The plain version of the raster set-up (csrc/raster_setup.cuh), the
    K1, K6 and K10 kernels' inputs: face rows (B, F, 16) (``face_rows``),
    face cover boxes (B, F, 4) = [umin umax vmin vmax] (``cover_boxes``;
    +inf, -inf for an invalid face, which no box test passes) and chunk
    boxes (B, ceil(F / 256), 4), the union of the boxes of each
    ``raster_kernel.CHUNK`` faces."""
    rows = face_rows(proj, faces)
    boxes = cover_boxes(rows, *_face_bounds(proj, faces, rows))
    B, F = boxes.shape[0], boxes.shape[1]
    fc = raster_kernel.CHUNK
    pad = (-F) % fc
    empty = torch.tensor([float("inf"), float("-inf")] * 2,
                         dtype=boxes.dtype, device=boxes.device)
    chunks = torch.cat([boxes, empty.expand(B, pad, 4)], 1).reshape(
        B, -1, fc, 4)
    cbox = torch.stack([chunks[..., 0].amin(2), chunks[..., 1].amax(2),
                        chunks[..., 2].amin(2), chunks[..., 3].amax(2)],
                       dim=-1)
    return rows, boxes.contiguous(), cbox.contiguous()


def _tile_major(x, tile_hw):
    """(B, H*W, ...) row-major -> (B, G, t*t, ...), 16x16 tiles in
    row-major tile order (G = H/t * W/t)."""
    H, W = tile_hw
    t = BIN_TILE
    B = x.shape[0]
    rest = x.shape[2:]
    x = x.reshape((B, H // t, t, W // t, t) + rest)
    x = x.permute((0, 1, 3, 2, 4) + tuple(range(5, x.dim())))
    return x.reshape((B, (H // t) * (W // t), t * t) + rest)


def _untile(x, tile_hw):
    """The inverse of ``_tile_major`` for (B, G, t*t) -> (B, H*W)."""
    H, W = tile_hw
    t = BIN_TILE
    B = x.shape[0]
    return (x.reshape(B, H // t, W // t, t, t).permute(0, 1, 3, 2, 4)
            .reshape(B, H * W))


def binned_tables(proj, pix_uv, faces, tile_hw, rows):
    """K10's inputs (ref: _raster_binned, rasterize.py:257-343): for each
    16x16 pixel tile, the valid faces whose screen bbox meets the bbox of
    the tile's own sample positions (inclusive, no margin), in ascending
    face order (``lax.top_k``'s order for equal scores), at most
    ``BIN_CAP``.  Returns lists (B, G, BIN_CAP) int32 (-1 past the end),
    counts (B, G) int32 (before the cap) and overflow, a one-element int32
    tensor: 1 when any tile of the batch holds more than ``BIN_CAP`` faces,
    and then every tile takes the dense answer (the JAX package's
    whole-batch ``lax.cond``).  Nothing here waits for the device."""
    cap = BIN_CAP
    puv = _tile_major(pix_uv, tile_hw)                 # (B, G, t*t, 2)
    tmin, tmax = puv.amin(2), puv.amax(2)              # (B, G, 2)
    tri_uv = proj[:, faces][..., :2]                   # (B, F, 3, 2)
    fmin, fmax = tri_uv.amin(2), tri_uv.amax(2)        # (B, F, 2)
    inter = ((fmin[:, None, :, 0] <= tmax[:, :, None, 0])
             & (fmax[:, None, :, 0] >= tmin[:, :, None, 0])
             & (fmin[:, None, :, 1] <= tmax[:, :, None, 1])
             & (fmax[:, None, :, 1] >= tmin[:, :, None, 1])
             & (rows[:, None, :, 12] != 0))            # (B, G, F)
    counts = inter.sum(-1)
    overflow = (counts > cap).any().to(torch.int32).reshape(1)
    # the k-th selected face of a tile goes to slot k; the rest to a slot
    # past the end, dropped
    pos = inter.cumsum(-1) - 1
    slot = torch.where(inter & (pos < cap), pos, torch.full_like(pos, cap))
    B, G, F = inter.shape
    fid = torch.arange(F, dtype=torch.int32, device=proj.device)
    lists = torch.full((B, G, cap + 1), -1, dtype=torch.int32,
                       device=proj.device)
    lists.scatter_(2, slot, fid.expand(B, G, F))
    return (lists[..., :cap].contiguous(), counts.to(torch.int32),
            overflow)


def tile_boxes(pix_uv, tile_hw):
    """The box [umin umax vmin vmax] (B, G, 4) of each 16x16 tile's
    samples, pix_uv (B, H*W, 2) row-major over tile_hw = (H, W)."""
    puv = _tile_major(pix_uv, tile_hw)                 # (B, G, t*t, 2)
    lo, hi = puv.amin(2), puv.amax(2)
    return torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1)


def binned_setup_plain(proj, faces, pix_uv, tile_hw):
    """The plain version of K10's set-up (``raster_kernel.
    binned_setup_cuda``): ``skip_tables``' rows, cover boxes and chunk
    boxes, the faces' screen boxes [umin umax vmin vmax] (``_face_bounds``;
    the lists' test), the tiles' sample boxes (``tile_boxes``), and
    ``binned_tables``' counts and overflow flag."""
    rows, boxes, cbox = skip_tables(proj, faces)
    lo, hi = _face_bounds(proj, faces, rows)
    vbox = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1)
    _, counts, overflow = binned_tables(proj, pix_uv, faces, tile_hw, rows)
    return raster_kernel.BinnedTables(rows, boxes, cbox, vbox,
                                      tile_boxes(pix_uv, tile_hw), counts,
                                      overflow)


def raster_binned_plain(rows, pix_uv, tile_hw, lists, counts, overflow):
    """K10's plain version: for each tile, ``scan_rows`` over the face rows
    its list names, the winner mapped back to its face id; the dense scan
    over all faces when ``overflow`` is set.  rows (B, F, 16), pix_uv
    (B, H*W, 2) row-major over tile_hw = (H, W), both multiples of 16."""
    if bool(overflow.item()):
        return scan_rows(rows, pix_uv)
    B, G, cap = lists.shape
    gat = torch.gather(rows[:, None].expand(B, G, -1, 16), 2,
                       lists.clamp_min(0).long()[..., None].expand(B, G, cap,
                                                                  16))
    sel = torch.arange(cap, device=rows.device) < counts[..., None]
    gat = torch.cat([gat[..., :12], torch.where(sel, gat[..., 12],
                                                torch.zeros_like(gat[..., 12])
                                                )[..., None],
                     gat[..., 13:]], dim=-1)
    puv = _tile_major(pix_uv, tile_hw)
    t2 = puv.shape[2]
    zbuf, lidx = scan_rows(gat.reshape(B * G, cap, 16),
                           puv.reshape(B * G, t2, 2))
    gidx = torch.gather(lists.reshape(B * G, cap), 1,
                        lidx.clamp_min(0).long())
    gidx = torch.where(lidx >= 0, gidx, torch.full_like(gidx, -1))
    return (_untile(zbuf.reshape(B, G, t2), tile_hw),
            _untile(gidx.reshape(B, G, t2), tile_hw))


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


def _raster_device(name, proj):
    if proj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} raster path for device {proj.device}")


def skip_forward(proj, pix_uv, faces, layout_hw):
    """The skip route on detached inputs: the op ``dsf::raster_skip``
    (``raster_scan`` on the CPU, K1's set-up and raster on the card)."""
    _raster_device("skip", proj)
    return custom_ops.raster_skip(proj, pix_uv, faces, *layout_hw)


def dense_forward(proj, pix_uv, faces):
    """The dense route on detached inputs: ``raster_scan`` / K6 (its set-up
    and raster)."""
    _raster_device("dense", proj)
    if proj.device.type == "cpu":
        return raster_scan(proj, pix_uv, faces)
    return raster_kernel.raster_dense_cuda(
        proj.float().contiguous(), faces.to(torch.int32).contiguous(),
        pix_uv.contiguous())


def binned_forward(proj, pix_uv, faces, tile_hw):
    """The binned route on detached inputs (ref: _raster_binned): the
    dense route when the layout is not a multiple of ``BIN_TILE`` or the
    mesh has at most ``BIN_CAP`` faces; else the op ``dsf::raster_binned``
    (``raster_binned_plain`` over ``binned_tables`` on the CPU, K10's
    set-up and raster on the card, on the positions and faces as they
    come: no copy, no cast)."""
    H, W = tile_hw
    if H % BIN_TILE or W % BIN_TILE or faces.shape[0] <= BIN_CAP:
        return dense_forward(proj, pix_uv, faces)
    _raster_device("binned", proj)
    return custom_ops.raster_binned(proj, pix_uv, faces, H, W)


def _skip_eligible(layout_hw, faces):
    """The skip route's condition (ref: rasterize._skip_eligible), without
    its "not CPU" term: the device picks K1 or its plain version."""
    if layout_hw is None or not USE_PALLAS_SKIP:
        return False
    H, W = layout_hw
    bh, bw = SKIP_BLOCK
    return (-(-faces.shape[0] // SKIP_FC) <= 31 and H % bh == 0
            and W % bw == 0)


def _raster_forward(tile_hw, proj, pix_uv, faces, layout_hw=None):
    """The route dispatch (ref: rasterize._raster_forward): skip when the
    pixel layout (``layout_hw``, else ``tile_hw``) allows it, binned when
    ``tile_hw`` is given, dense otherwise."""
    if layout_hw is None:
        layout_hw = tile_hw
    if _skip_eligible(layout_hw, faces):
        return skip_forward(proj, pix_uv, faces, layout_hw)
    if tile_hw is not None:
        return binned_forward(proj, pix_uv, faces, tile_hw)
    return dense_forward(proj, pix_uv, faces)


def _with_grad(proj, pix_uv, faces, zbuf, idx):
    if torch.is_grad_enabled() and proj.requires_grad:
        zbuf = AttachRasterGrad.apply(proj, zbuf, idx, pix_uv, faces)
    return zbuf


def raster_skip(proj, pix_uv, faces, layout_hw):
    """The skip route alone: nearest-face depth and face id at each sample
    position, zbuf (B, P) differentiable in ``proj`` with the hard blur=0
    gradient, and idx (B, P) int32.

    ``layout_hw`` (H, W): pix_uv is row-major over an H x W pixel grid,
    which K1 tiles (a ragged edge is masked).  CPU tensors take
    ``raster_scan``; CUDA tensors launch K1.  Both run on the detached
    vertices."""
    with torch.no_grad():
        zbuf, idx = skip_forward(proj.detach(), pix_uv, faces, layout_hw)
    return _with_grad(proj, pix_uv, faces, zbuf, idx), idx


def rasterize_depth(verts, faces, pix_uv, paras, flip=1.0, return_idx=False,
                    tile_hw=None, layout_hw=None):
    """Rasterize (B, V, 3) world-mm verts into depth at sample positions
    (ref: rasterize.rasterize_depth).

    pix_uv (B, P, 2) or (P, 2): continuous full-frame pixel positions
    (``crop_pixel_rays``, ``full_frame_pixel_rays``).  ``tile_hw`` (H, W):
    the row-major pixel layout of pix_uv, which opts into the binned route
    (and the skip route, when allowed); ``layout_hw``: the layout without
    the binned route.  Returns zbuf (B, P), depth in mm of the nearest
    face along each ray, 0 where none covers the pixel, differentiable in
    ``verts`` with the hard (blur=0) gradient through the hit face; with
    ``return_idx``, (zbuf, idx) without a gradient, where the skip route
    reads ``layout_hw`` alone, as the JAX package's does."""
    proj = project_verts(verts, paras, flip)
    if pix_uv.dim() == 2:
        pix_uv = pix_uv.expand((verts.shape[0],) + tuple(pix_uv.shape))
    with torch.no_grad():
        p = proj.detach()
        if return_idx:
            if _skip_eligible(layout_hw, faces):
                return skip_forward(p, pix_uv, faces, layout_hw)
            if tile_hw is not None:
                return binned_forward(p, pix_uv, faces, tile_hw)
            return dense_forward(p, pix_uv, faces)
        zbuf, idx = _raster_forward(tile_hw, p, pix_uv, faces, layout_hw)
    return _with_grad(proj, pix_uv, faces, zbuf, idx)


# ---------------------------------------------------------------------------
# point splatting (scatter-min depth), ref: PCLToDepth / pcl2Img
# (render_loader.py:1015-1033, 1158-1171)
# ---------------------------------------------------------------------------

def splat_points_min(uvd, img_size, background=0.0):
    """Scatter points into an (img_size, img_size) depth image keeping the
    nearest depth per pixel, ``background`` where no point lands.  uvd
    (B, N, 3) in pixel coordinates, clamped to the image -> (B, img_size,
    img_size).  A minimum does not depend on the order of the writes, so
    ``scatter_reduce_`` gives one answer on every device (the JAX package
    computes this outside any Pallas kernel)."""
    B = uvd.shape[0]
    u = torch.clamp(uvd[..., 0], 0, img_size - 0.5)
    v = torch.clamp(uvd[..., 1], 0, img_size - 0.5)
    lin = (torch.floor(v) * img_size + torch.floor(u)).long()
    img = torch.full((B, img_size * img_size), INF, dtype=uvd.dtype,
                     device=uvd.device)
    img.scatter_reduce_(1, lin, uvd[..., 2], "amin")
    img = torch.where(img >= INF, torch.full_like(img, background), img)
    return img.reshape(B, img_size, img_size)
