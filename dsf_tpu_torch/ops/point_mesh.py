"""Exact point -> triangle squared distances (counterpart of
dsf_tpu/ops/point_mesh.py; ref: metric/meshLoss.py:21-269, pytorch3d's
point_face_dist kernels).

Two passes:

1. argmin (no gradient): per point, the nearest face, optionally under a
   factorized admissibility mask — a (T, K) face-to-part table plus a
   per-point part id, so the part-aware loss reuses the same pass without
   a (P x T) mask.  Three variants, picked by the JAX package's switches
   (dsf_tpu/ops/point_mesh.py:218-285), each a kernel on CUDA tensors and
   its plain version on CPU tensors:
   - K3 (the default): every admissible (point, face) pair,
     ``argmin_faces_plain`` / ``point_mesh_kernel.argmin_faces_cuda``,
     which groups each cloud's points by part into tiles and walks each
     tile's part list (``argmin_tables_plain``,
     ``argmin_faces_tiles_plain``);
   - K7 (``USE_V2_KERNEL``, ``DSF_ICP_KERNEL=v2``): over faces sorted by
     part inside (``face_part_perm``), skipping each (128-point tile in the
     caller's order, 128-face chunk) block in which no point admits any
     face (``v2_words``; its tables ``v2_tables_plain``); face ids come
     back in the caller's order;
   - K8 (``USE_CULLED_KERNEL``): K3's design over faces part-sorted
     inside, points grouped by (part, nearest chunk), and a chunk skipped
     for a tile when the chunks' bounding spheres prove that no point of
     the tile has its nearest admissible face there (``culled_tables``);
     face ids come back in the caller's order.
2. differentiable: gather the winning triangle of each point and
   evaluate the exact distance on it, so gradients flow through the
   closest face only (pytorch3d's hard backward).

Distances are squared and per point: the reference's
point_mesh_face_distance returns them early (meshLoss.py:266-269), a quirk
that is kept.
"""

from __future__ import annotations

import os

import torch

from dsf_tpu_torch.ops import point_mesh_kernel

INF = 1e10
CHUNK = 128          # faces per step of the plain argmin
TILE = point_mesh_kernel.V2_TILE  # points a skip word of K7 covers
MAX_CHUNKS = point_mesh_kernel.V2_MAX_CHUNKS  # K7: one bit per face chunk
CULL_MARGIN = 1e-4   # slack on K8's sphere bounds, in the caller's units

# dsf_tpu/ops/point_mesh.py:218 and :244: K7 by the environment, K8 off
USE_V2_KERNEL = os.environ.get("DSF_ICP_KERNEL", "v1") == "v2"
USE_CULLED_KERNEL = False


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


def _part_of_face(part_mask):
    """(T,) each face's first admissible part, K for a face of none."""
    K = part_mask.shape[1]
    first = part_mask.to(torch.uint8).argmax(1)
    return torch.where(part_mask.any(1), first, torch.full_like(first, K))


def face_part_perm(part_mask):
    """(T,) int64: the stable order of faces by their first admissible part
    (ref: pallas_point_mesh._face_part_perm), so that a 128-face chunk
    holds one part or few."""
    return torch.argsort(_part_of_face(part_mask.bool()), stable=True)


def _tiles(x, P, fill):
    """(B, P, ...) -> (B, NT, TILE, ...), padded along P with ``fill``."""
    B = x.shape[0]
    NT = -(-P // TILE)
    pad = NT * TILE - P
    if pad:
        x = torch.cat([x, x.new_full((B, pad) + x.shape[2:], fill)], dim=1)
    return x.reshape((B, NT, TILE) + x.shape[2:])


def v2_words(part_mask, point_part, B, P, T, device):
    """K7's skip words (B, NT) int32, one per (cloud, 128-point tile): bit
    ci is set when some point of the tile admits some face of 128-face
    chunk ci (ref: argmin_faces_pallas_v2, pallas_point_mesh.py:554-566).
    A clear bit is a block of pairs that are all inadmissible.  Without a
    mask every bit of the ceil(T / 128) chunks is set."""
    nc = -(-T // CHUNK)
    if nc > MAX_CHUNKS:
        raise ValueError(f"K7 takes at most {MAX_CHUNKS} face chunks of "
                         f"{CHUNK}, got {T} faces")
    NT = -(-P // TILE)
    if part_mask is None:
        return torch.full((B, NT), (1 << nc) - 1, dtype=torch.int32,
                          device=device)
    ext, pp = _extend_part_tables(part_mask.bool(), point_part)
    Kp = ext.shape[1]
    chunk_u = torch.cat([ext, ext.new_zeros(nc * CHUNK - T, Kp)]
                        ).reshape(nc, CHUNK, Kp).any(1)        # (nc, Kp)
    # pad points take the extra part, which admits nothing
    tile_u = torch.zeros((B, NT, Kp), dtype=torch.bool, device=device)
    tile_u.scatter_(2, _tiles(pp, P, Kp - 1), True)
    need = (tile_u[:, :, None, :] & chunk_u[None, None]).any(-1)  # (B,NT,nc)
    bits = torch.ones(nc, dtype=torch.int64, device=device) << \
        torch.arange(nc, device=device)
    return (need.long() * bits).sum(-1).to(torch.int32)


def _block_argmin(pts_t, pp_t, ext, T, run, sqdist):
    """The plain block loop of K7.  pts_t (B, NT, TILE, 3) points
    in 128-point tiles, pp_t (B, NT, TILE) their parts in [0, K] and ext
    (T, K + 1) the extended table (``_extend_part_tables``), or both None
    for no mask; run (B, NT, nc) says which (tile, 128-face chunk) blocks
    to evaluate; ``sqdist(bi, ti, s)`` gives the distances (n, TILE, c) of
    the blocks' points to the chunk's faces from face s on.  As
    ``argmin_faces_plain`` within and across chunks; a point keeps (1e10,
    0) where no block of its tile holds an admissible face.  Returns dmin,
    imin (B, NT * TILE)."""
    B, NT = pts_t.shape[0], pts_t.shape[1]
    dmin = torch.full((B, NT, TILE), INF, dtype=pts_t.dtype,
                      device=pts_t.device)
    imin = torch.zeros((B, NT, TILE), dtype=torch.int32, device=pts_t.device)
    for ci, s in enumerate(range(0, T, CHUNK)):
        bi, ti = torch.nonzero(run[..., ci], as_tuple=True)
        if bi.numel() == 0:
            continue
        d = sqdist(bi, ti, s)
        if ext is not None:
            d = torch.where(ext[s:s + CHUNK].T[pp_t[bi, ti]], d,
                            torch.full_like(d, INF))
        cmin = d.min(-1).values
        carg = torch.argmin(d, -1).to(torch.int32) + s
        cur_d, cur_i = dmin[bi, ti], imin[bi, ti]
        better = cmin < cur_d
        dmin[bi, ti] = torch.where(better, cmin, cur_d)
        imin[bi, ti] = torch.where(better, carg, cur_i)
    return dmin.reshape(B, -1), imin.reshape(B, -1)


def argmin_faces_v2_plain(points, tris, part_mask, point_part, words):
    """K7's plain version: ``argmin_faces_plain`` over the (tile, chunk)
    blocks whose bit is set in ``words`` (``v2_words``), and nothing else.
    A point keeps (1e10, 0) when no block of its tile holds an admissible
    face."""
    B, P, _ = points.shape
    T = tris.shape[1]
    points, tris = points.detach(), tris.detach()
    ext = pp_t = None
    if part_mask is not None:
        ext, pp = _extend_part_tables(part_mask.bool(), point_part)
        pp_t = _tiles(pp, P, ext.shape[1] - 1)
    pts_t = _tiles(points, P, 0.0)                       # (B, NT, TILE, 3)
    nc = -(-T // CHUNK)
    run = (words[..., None] >> torch.arange(nc, device=words.device)) & 1
    dmin, imin = _block_argmin(
        pts_t, pp_t, ext, T, run,
        lambda bi, ti, s: point_tri_sqdist(pts_t[bi, ti][:, :, None],
                                           tris[bi, s:s + CHUNK][:, None]))
    return dmin[:, :P], imin[:, :P]


def _v2_order(part_mask, T, device):
    """K7's face order: ``face_part_perm`` of the table, or the identity
    (int64) without one."""
    if part_mask is None:
        return torch.arange(T, device=device)
    return face_part_perm(part_mask)


def _words_and_parts(part_mask, point_part, B, P, T, device):
    """The plain version of K7's face words and point parts: (T,) int32
    words of the part table in its own face order (``part_words``; -1
    without a table) and (B, P) int32 parts, where parts outside [0, K) get
    K, a bit no word sets (0 without a table)."""
    if part_mask is None:
        return (torch.full((T,), -1, dtype=torch.int32, device=device),
                torch.zeros((B, P), dtype=torch.int32, device=device))
    K = part_mask.shape[1]
    parts = torch.where((point_part >= 0) & (point_part < K), point_part,
                        torch.full_like(point_part, K)).to(torch.int32)
    words = point_mesh_kernel.part_words(part_mask.bool())
    return words.contiguous(), parts.contiguous()


def _chunk_ors(words):
    """(T,) int32 face words -> (ceil(T / 128),) int32, each 128-face
    chunk's OR of them."""
    T = words.shape[0]
    G = -(-T // CHUNK)
    w = torch.cat([words.long() & 0xFFFFFFFF,
                   words.new_zeros(G * CHUNK - T, dtype=torch.long)])
    bits = ((w.reshape(G, CHUNK, 1) >> torch.arange(32, device=w.device))
            & 1).amax(1)                                          # (G, 32)
    o = (bits << torch.arange(32, device=w.device)).sum(-1)
    return torch.where(o >= 2 ** 31, o - 2 ** 32, o).to(torch.int32)


def v2_tables_plain(points, tris, part_mask=None, point_part=None):
    """The plain version of K7's set-up kernel
    (``point_mesh_kernel.v2_setup_cuda``): the same
    ``point_mesh_kernel.V2Tables`` from PyTorch, on faces in the caller's
    order: the order ``face_part_perm`` (the identity without a table),
    ``face_constants`` rows, ``_words_and_parts`` words and parts and
    ``v2_words`` skip words in that order, and the chunks' ORs."""
    points, tris = points.detach().float(), tris.detach().float()
    B, P = points.shape[0], points.shape[1]
    T = tris.shape[1]
    fperm = _v2_order(part_mask, T, points.device)
    mask = None if part_mask is None else part_mask.bool()[fperm]
    words, parts = _words_and_parts(mask, point_part, B, P, T, points.device)
    rows = point_mesh_kernel.face_constants(tris[:, fperm])
    return point_mesh_kernel.V2Tables(
        fperm.to(torch.int32), rows, words, _chunk_ors(words), parts,
        v2_words(mask, point_part, B, P, T, points.device))


def argmin_faces_v2(points, tris, part_mask=None, point_part=None):
    """K7 over faces in the caller's order, sorted by part inside
    (``face_part_perm``): its plain version for CPU tensors, the kernel
    (set-up and argmin) for CUDA tensors.  Returns (dmin, imin) as
    ``argmin_faces_plain`` does, with the caller's face ids, so a point
    that admits no face gets (1e10, fperm[0]), the first face in the part
    order."""
    points, tris = points.detach(), tris.detach()
    if points.device.type == "cuda":
        return point_mesh_kernel.argmin_faces_v2_cuda(points, tris, part_mask,
                                                      point_part)
    if points.device.type != "cpu":
        raise ValueError(f"no point-mesh path for device {points.device}")
    B, P = points.shape[0], points.shape[1]
    T = tris.shape[1]
    fperm = _v2_order(part_mask, T, points.device)
    mask = None if part_mask is None else part_mask.bool()[fperm]
    words = v2_words(mask, point_part, B, P, T, points.device)
    dmin, imin = argmin_faces_v2_plain(points, tris[:, fperm], mask,
                                       point_part, words)
    return dmin, fperm[imin.long()].to(torch.int32)


def face_constants16(tris):
    """(B, T, 3, 3) -> (B, T, 16) rows a(3) ab(3) ac(3) ab.a ac.a ab.b
    ac.b ab.c ac.c a.a: K8's constants (ref: _face_constants), for the
    Ericson closest point with divides; ``point_mesh_kernel.face_terms``'
    rounding, as the set-up kernel writes them."""
    v, dots = point_mesh_kernel.face_terms(tris)
    return torch.cat([v[..., 0, :], v[..., 3, :], v[..., 4, :],
                      dots[..., :7]], dim=-1).contiguous()


def culled_sqdist(fc, p):
    """K8's squared distance from points p (..., 3) to faces of rows fc
    (..., 16), broadcast against each other, in the order of
    ``_kernel_culled``'s arithmetic (pallas_point_mesh.py:223-290): the
    barycentric closest point by region, then |p|^2 - 2 p.q + |q|^2."""
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    s1 = px * fc[..., 3] + py * fc[..., 4] + pz * fc[..., 5]
    s2 = px * fc[..., 6] + py * fc[..., 7] + pz * fc[..., 8]
    pa = px * fc[..., 0] + py * fc[..., 1] + pz * fc[..., 2]
    pp = px * px + py * py + pz * pz
    ab_a, ac_a, ab_b, ac_b, ab_c, ac_c, aa = (fc[..., k] for k in range(9, 16))
    abab, acac, abac = ab_b - ab_a, ac_c - ac_a, ac_b - ac_a
    d1, d2, d3 = s1 - ab_a, s2 - ac_a, s1 - ab_b
    d4, d5, d6 = s2 - ac_b, s1 - ab_c, s2 - ac_c
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    den = va + vb + vc
    eps = 1e-12

    def safe_div(n, d):
        return n / torch.where(torch.abs(d) < eps, torch.full_like(d, eps), d)

    zero, one = torch.zeros_like(den), torch.ones_like(den)
    v = safe_div(vb, den)
    w = safe_div(vc, den)
    t_bc = torch.clamp(safe_div(d4 - d3, (d4 - d3) + (d5 - d6)), 0.0, 1.0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    v = torch.where(on_bc, 1.0 - t_bc, v)
    w = torch.where(on_bc, t_bc, w)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    v = torch.where(on_ac, zero, v)
    w = torch.where(on_ac, torch.clamp(safe_div(d2, d2 - d6), 0.0, 1.0), w)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v = torch.where(on_ab, torch.clamp(safe_div(d1, d1 - d3), 0.0, 1.0), v)
    w = torch.where(on_ab, zero, w)
    in_c = (d6 >= 0) & (d5 <= d6)
    v = torch.where(in_c, zero, v)
    w = torch.where(in_c, one, w)
    in_b = (d3 >= 0) & (d4 <= d3)
    v = torch.where(in_b, one, v)
    w = torch.where(in_b, zero, w)
    in_a = (d1 <= 0) & (d2 <= 0)
    v = torch.where(in_a, zero, v)
    w = torch.where(in_a, zero, w)
    qq = (aa + v * (2.0 * ab_a + v * abab) + w * (2.0 * ac_a + w * acac)
          + 2.0 * v * w * abac)
    d = pp - 2.0 * (pa + v * s1 + w * s2) + qq
    return torch.clamp_min(d, 0.0)


def _culled_bounds(points, tris, part_mask, point_part):
    """``culled_needed``'s chunk bounds in the points' float dtype: (lb,
    ub, adm, dpc, pp, masked, G) with lb, adm, dpc (B, P, G), ub (B, P)."""
    B, P, _ = points.shape
    T = tris.shape[1]
    G = -(-T // CHUNK)
    pad_f = G * CHUNK - T
    dev = points.device
    pts = points.detach()
    tris = tris.detach().to(pts.dtype)
    cent = tris.mean(2)                                          # (B, T, 3)
    face_r = torch.sqrt(((tris - cent[:, :, None]) ** 2).sum(-1).amax(-1)
                        + 1e-20)                                 # (B, T)
    real = torch.arange(G * CHUNK, device=dev) < T
    cent_g = torch.cat([cent, cent.new_zeros(B, pad_f, 3)], 1
                       ).reshape(B, G, CHUNK, 3)
    face_r = torch.cat([face_r, face_r.new_zeros(B, pad_f)], 1
                       ).reshape(B, G, CHUNK)
    real = real.reshape(G, CHUNK)
    n_real = real.sum(-1).clamp_min(1)[None, :, None]
    c_g = (cent_g * real[None, :, :, None]).sum(2) / n_real      # (B, G, 3)
    r_g = torch.where(real[None], torch.sqrt(
        ((cent_g - c_g[:, :, None]) ** 2).sum(-1) + 1e-20) + face_r,
        torch.zeros_like(face_r)).amax(-1)                       # (B, G)

    masked = part_mask is not None
    if masked:
        ext, pp = _extend_part_tables(part_mask.bool(), point_part)
        Kp = ext.shape[1]
        chunk_part = torch.cat([ext, ext.new_zeros(pad_f, Kp)]
                               ).reshape(G, CHUNK, Kp).any(1)    # (G, Kp)
        adm = chunk_part.T[pp]                                   # (B, P, G)
    else:
        pp = torch.zeros((B, P), dtype=torch.int64, device=dev)
        adm = torch.ones((B, P, G), dtype=torch.bool, device=dev)
    dpc = torch.sqrt(((pts[:, :, None] - c_g[:, None]) ** 2).sum(-1)
                     + 1e-20)                                    # (B, P, G)
    lb = torch.clamp_min(dpc - r_g[:, None] - CULL_MARGIN, 0.0) ** 2
    ub_g = (dpc + r_g[:, None] + CULL_MARGIN) ** 2
    ub = torch.where(adm, ub_g, torch.full_like(ub_g, INF)).amin(-1)
    return lb, ub, adm, dpc, pp, masked, G


def culled_needed(points, tris, part_mask=None, point_part=None):
    """K8's rule per point (ref: argmin_faces_pallas_culled,
    pallas_point_mesh.py:671-713), on faces already in part order, in
    float32.

    Per 128-face chunk g, a bounding sphere (c_g, r_g) about the mean of
    its faces' centroids.  Point p needs chunk g when g holds a face p
    admits and lb_g(p) = (max(0, |p - c_g| - r_g - m))^2 is at most
    ub(p) = min over admissible g' of (|p - c_g'| + r_g' + m)^2, with
    m = ``CULL_MARGIN``: the chunk of p's nearest admissible face always
    does.  Returns (needed (B, P, G) bool, the sort key (B, P) int64:
    part * G + nearest admissible chunk, parts (B, P) int64 in [0, K],
    with K "admits nothing")."""
    lb, ub, adm, dpc, pp, masked, G = _culled_bounds(
        points.float(), tris, part_mask, point_part)
    needed = adm & (lb <= ub[..., None])
    near_g = torch.argmin(torch.where(adm, dpc, torch.full_like(dpc, INF)),
                          -1)
    return needed, (pp * G + near_g if masked else near_g), pp


def cull_within_rounding(points, tris, part_mask, point_part, key, need,
                         eps=1e-5):
    """Hold K8's per-point tables, key and need (B, P) int32 built in
    float32 on faces in part order, to ``culled_needed``'s rule in float64:
    each need bit must lie between the rule with the bound test lb <= ub
    moved by -eps and +eps of (1 + ub), and each key must name the point's
    part and an admissible chunk whose centre lies within eps of the
    nearest admissible one's (chunk 0 where none is admissible).  Returns
    (need bits outside, keys outside): both 0 when every difference from
    the float32 rule lies within rounding."""
    lb, ub, adm, dpc, pp, masked, G = _culled_bounds(
        points.double(), tris, part_mask, point_part)
    slack = eps * (1.0 + ub[..., None])
    lo = adm & (lb <= ub[..., None] - slack)
    hi = adm & (lb <= ub[..., None] + slack)
    bits = ((need.long()[..., None] >> torch.arange(G, device=need.device))
            & 1).bool()
    bad_need = int(((lo & ~bits) | (bits & ~hi)).sum())
    g = key.long() % G
    nearest = torch.where(adm, dpc, torch.full_like(dpc, INF)).amin(-1)
    ok = ((key.long() // G == (pp if masked else torch.zeros_like(pp)))
          & (torch.gather(dpc, 2, g[..., None])[..., 0] <= nearest + eps)
          & torch.where(adm.any(-1), torch.gather(adm, 2, g[..., None])[..., 0],
                        g == 0))
    return bad_need, int((~ok).sum())


def _ext_and_parts(part_mask, point_part, B, P, T, device):
    """The extended part table (T, K + 1) and the points' parts (B, P) int64
    in [0, K] (``_extend_part_tables``); without a mask one part, 0, that
    admits every face."""
    if part_mask is None:
        ext = torch.zeros((T, 2), dtype=torch.bool, device=device)
        ext[:, 0] = True
        return ext, torch.zeros((B, P), dtype=torch.int64, device=device)
    return _extend_part_tables(part_mask.bool(), point_part)


def part_face_lists(ext):
    """The set-up's part lists in PyTorch: ext (T, Kp) bool -> lists (Kp,
    T) int32, the ascending face indices each column admits, -1 after
    them; lens (Kp,) int32; choff (Kp, G + 1) int32, the list position at
    which 128-face chunk g begins (G = ceil(T / 128), choff[:, G] = lens)."""
    T, Kp = ext.shape
    e = ext.T
    lens = e.sum(1)
    first = torch.argsort((~e).to(torch.uint8), dim=1, stable=True)
    pos = torch.arange(T, device=ext.device)
    lists = torch.where(pos[None] < lens[:, None], first,
                        torch.full_like(first, -1))
    G = -(-T // CHUNK)
    csum = torch.cat([e.new_zeros((Kp, 1), dtype=torch.int64),
                      e.long().cumsum(1)], 1)
    bounds = torch.clamp(torch.arange(G + 1, device=ext.device) * CHUNK,
                         max=T)
    return (lists.to(torch.int32), lens.to(torch.int32),
            csum[:, bounds].to(torch.int32))


def group_points_by_part(key, G, K, tile, need=None):
    """The set-up's grouping in PyTorch: key (B, P) int in [0, (K + 1) G),
    whose part is key // G (part K admits nothing) -> perm (B, P) int32,
    the points stably sorted by key; tiles (B, maxT, 4) int32 (part,
    first, count, run): each part's run of perm cut into tiles of at most
    ``tile`` points, none for part K, run the OR of the tile's ``need``
    words (B, P) (-1 without), zeros after the last tile; tcount (B, 2)
    int32: the number of tiles and the first position of part K."""
    B, P = key.shape
    dev = key.device
    key = key.long()
    maxT = point_mesh_kernel.max_tiles(P, K, tile)
    perm = torch.argsort(key, dim=1, stable=True)
    part = key // G
    cnt = torch.zeros((B, K + 1), dtype=torch.int64, device=dev)
    cnt.scatter_add_(1, part, torch.ones_like(part))
    pstart = torch.cumsum(cnt, 1) - cnt                          # (B, K + 1)
    nt = (cnt[:, :K] + tile - 1) // tile
    tcum = torch.cumsum(nt, 1)
    ntiles = tcum[:, -1]
    j = torch.arange(maxT, device=dev)
    tpart = torch.clamp((j[None, :, None] >= tcum[:, None, :]).sum(-1),
                        max=K - 1)                               # (B, maxT)
    within = j[None] - torch.gather(tcum - nt, 1, tpart)
    first = torch.gather(pstart, 1, tpart) + within * tile
    count = torch.clamp(torch.gather(cnt, 1, tpart) - within * tile,
                        max=tile)
    if need is None:
        run = torch.full_like(first, -1)
    else:
        # each sorted point's tile; points of part K go to a spare row
        part_s = torch.gather(part, 1, perm)
        pc = torch.clamp(part_s, max=K - 1)
        tid = torch.where(
            part_s < K, torch.gather(tcum - nt, 1, pc)
            + (torch.arange(P, device=dev)[None]
               - torch.gather(pstart, 1, pc)) // tile,
            torch.full_like(part_s, maxT))
        bits = (torch.gather(need.long(), 1, perm)[..., None]
                >> torch.arange(32, device=dev)) & 1            # (B, P, 32)
        hit = torch.zeros((B, maxT + 1, 32), dtype=torch.int64, device=dev)
        hit.scatter_add_(1, tid[..., None].expand(B, P, 32), bits)
        run = ((hit[:, :maxT] > 0).long()
               << torch.arange(32, device=dev)).sum(-1)
        run = torch.where(run >= 2 ** 31, run - 2 ** 32, run)
    valid = j[None] < ntiles[:, None]
    tiles = torch.stack([tpart, first, count, run], -1)
    tiles = torch.where(valid[..., None], tiles, torch.zeros_like(tiles))
    tcount = torch.stack([ntiles, pstart[:, K]], -1)
    return (perm.to(torch.int32), tiles.to(torch.int32),
            tcount.to(torch.int32))


def need_words(needed):
    """(B, P, G <= 32) bool -> (B, P) int32 whose bit g is needed[..., g]."""
    G = needed.shape[-1]
    bits = torch.ones(G, dtype=torch.int64, device=needed.device) << \
        torch.arange(G, device=needed.device)
    w = (needed.long() * bits).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def culled_tables(points, tris, part_mask=None, point_part=None,
                  tile=point_mesh_kernel.TILE_POINTS):
    """K8's point tables in PyTorch, on faces already in part order:
    ``culled_needed``, its need words, and the points grouped by its key
    (part x G + nearest admissible chunk) into tiles of one part that are
    coherent in place, each with its run word: the chunks any point of the
    tile needs (``group_points_by_part``).  Returns (perm, key, need, tiles,
    tcount), int32."""
    needed, key, _ = culled_needed(points, tris, part_mask, point_part)
    need = need_words(needed)
    K = 1 if part_mask is None else part_mask.shape[1]
    perm, tiles, tcount = group_points_by_part(key, needed.shape[-1], K,
                                               tile, need)
    return perm, key.to(torch.int32), need, tiles, tcount


def argmin_tables_plain(points, tris, part_mask=None, point_part=None,
                        culled=False, tile=point_mesh_kernel.TILE_POINTS):
    """The plain version of the set-up kernel
    (``point_mesh_kernel.argmin_setup_cuda``): the same
    ``point_mesh_kernel.ArgminTables`` from PyTorch, K3's or, with
    ``culled``, K8's (faces sorted by ``face_part_perm``, rows
    ``face_constants16`` in that order, ``culled_tables``)."""
    points, tris = points.detach().float(), tris.detach().float()
    B, P = points.shape[0], points.shape[1]
    T = tris.shape[1]
    ext, pp = _ext_and_parts(part_mask, point_part, B, P, T, points.device)
    K = ext.shape[1] - 1
    if not culled:
        perm, tiles, tcount = group_points_by_part(pp, 1, K, tile)
        return point_mesh_kernel.ArgminTables(
            point_mesh_kernel.face_constants(tris), *part_face_lists(ext),
            pp.to(torch.int32), perm, tiles, tcount, None, None, tile)
    fperm = face_part_perm(ext[:, :K])
    tris_s, ext_s = tris[:, fperm], ext[fperm]
    perm, key, need, tiles, tcount = culled_tables(
        points, tris_s, None if part_mask is None else ext_s[:, :K],
        point_part, tile)
    return point_mesh_kernel.ArgminTables(
        face_constants16(tris_s), *part_face_lists(ext_s), key, perm, tiles,
        tcount, fperm.to(torch.int32), need, tile)


def _walk_tiles(points, tables, sqdist, culled):
    """The plain walk over ``tables``' tiles and part lists: for each tile,
    its points against the faces of its part's list (K8: those in chunks
    its run word keeps), in ascending list order with a strict '<', so the
    lowest index of the least distance wins; ``sqdist(bi, pts, f)`` gives
    the distances (n, TILE, c) of the points pts (n, TILE, 3) of clouds bi
    (n,) to faces f (c,).  Returns (dmin, imin) in the points' order and
    the lists' face ids; (1e10, 0) where a point's tile holds nothing."""
    B, P = points.shape[0], points.shape[1]
    dev = points.device
    tiles, perm = tables.tiles.long(), tables.perm.long()
    TP = tables.tile_points
    dmin = torch.full((B, P), INF, dtype=points.dtype, device=dev)
    imin = torch.zeros((B, P), dtype=torch.int32, device=dev)
    valid = (torch.arange(tiles.shape[1], device=dev)[None]
             < tables.tcount[:, :1].long())
    i = torch.arange(TP, device=dev)
    for k in range(tables.lists.shape[0]):
        bi, ti = torch.nonzero(valid & (tiles[..., 0] == k), as_tuple=True)
        if bi.numel() == 0:
            continue
        t = tiles[bi, ti]                                        # (n, 4)
        live = i[None] < t[:, 2:3]
        pid = perm[bi[:, None], torch.clamp(t[:, 1:2] + i[None], max=P - 1)]
        pts = points[bi[:, None], pid]                           # (n, TP, 3)
        best = torch.full(pid.shape, INF, dtype=points.dtype, device=dev)
        arg = torch.zeros(pid.shape, dtype=torch.int64, device=dev)
        flist = tables.lists[k, :int(tables.lens[k])].long()
        for s in range(0, flist.numel(), CHUNK):
            f = flist[s:s + CHUNK]
            d = sqdist(bi, pts, f)
            if culled:
                keep = ((t[:, 3:4] >> (f // CHUNK)[None]) & 1).bool()
                d = torch.where(keep[:, None, :], d, torch.full_like(d, INF))
            cmin = d.min(-1).values
            better = cmin < best
            best = torch.where(better, cmin, best)
            arg = torch.where(better, f[torch.argmin(d, -1)], arg)
        bl = bi[:, None].expand_as(pid)
        dmin[bl[live], pid[live]] = best[live]
        imin[bl[live], pid[live]] = arg[live].to(torch.int32)
    return dmin, imin


def argmin_faces_tiles_plain(points, tris, tables):
    """K3's argmin as its kernel walks it, in PyTorch: the exact distance
    (``point_tri_sqdist``) of each tile's points to its part's faces, on
    K3's ``tables`` (``argmin_tables_plain`` or the set-up kernel's).
    Equal, dmin and imin bit for bit, to ``argmin_faces_plain`` on the same
    inputs."""
    points, tris = points.detach(), tris.detach()
    return _walk_tiles(
        points, tables,
        lambda bi, pts, f: point_tri_sqdist(
            pts[:, :, None], tris[bi[:, None], f[None]][:, None]),
        False)


def argmin_faces_culled_plain(points, tables):
    """K8's plain version on its ``tables`` (``argmin_tables_plain(...,
    culled=True)`` or the set-up kernel's): ``culled_sqdist`` on the rows
    of the faces each tile's part admits in the chunks its run word keeps.
    Returns (dmin, imin) in the points' order with face ids in the part
    order (``tables.fperm`` maps them back); (1e10, 0) where nothing is
    run."""
    fc = tables.rows
    return _walk_tiles(
        points.detach().float(), tables,
        lambda bi, pts, f: culled_sqdist(fc[bi[:, None], f[None]][:, None],
                                         pts[:, :, None]),
        True)


def argmin_faces_culled(points, tris, part_mask=None, point_part=None):
    """K8: the nearest admissible face per point with (tile, chunk)
    culling, the kernel for CUDA tensors and its plain version for CPU
    tensors, on the same tables: faces sorted by part, points by
    ``culled_tables``' key.  Results come back in the caller's point order
    with the caller's face ids (ref: pallas_point_mesh.py:772-781), so a
    point that admits no face gets (1e10, perm[0]) as the JAX kernel gives
    it.  dmin is the 16-constant form's distance."""
    points, tris = points.detach(), tris.detach()
    if points.device.type == "cuda":
        return point_mesh_kernel.argmin_faces_culled_cuda(points, tris,
                                                          part_mask,
                                                          point_part)
    if points.device.type != "cpu":
        raise ValueError(f"no point-mesh path for device {points.device}")
    tables = argmin_tables_plain(points, tris, part_mask, point_part,
                                 culled=True)
    dmin, imin = argmin_faces_culled_plain(points, tables)
    return dmin, tables.fperm[imin.long()]


def argmin_faces(points, tris, part_mask=None, point_part=None):
    """The argmin pass, by the switches: K7 (``USE_V2_KERNEL``), K8
    (``USE_CULLED_KERNEL``) or K3, each its plain version for CPU tensors
    and its kernel for CUDA tensors.  Returns (dmin, imin) as
    ``argmin_faces_plain`` does; a kernel's dmin is its own distance form
    (see csrc/)."""
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no point-mesh path for device {points.device}")
    if USE_V2_KERNEL:
        return argmin_faces_v2(points, tris, part_mask, point_part)
    if USE_CULLED_KERNEL:
        return argmin_faces_culled(points, tris, part_mask, point_part)
    if points.device.type == "cpu":
        return argmin_faces_plain(points, tris, part_mask, point_part)
    return point_mesh_kernel.argmin_faces_cuda(points, tris, part_mask,
                                               point_part)


def point_face_distance(points, verts, faces, part_mask=None,
                        point_part=None):
    """Per-point squared distance to the nearest (admissible) face.

    points (B, P, 3); verts (B, V, 3); faces (T, 3) int; optional
    part_mask (T, K) bool + point_part (B, P) int.  Differentiable in
    points and verts through the winning face only: the argmin runs
    without gradient, the winner is gathered and its distance evaluated
    again with ``point_tri_sqdist``.  Every argmin returns the caller's
    face ids (K7 and K8 sort the faces by part inside), so the gather is
    in the caller's order."""
    tris = verts[:, faces]                                   # (B, T, 3, 3)
    with torch.no_grad():
        _, imin = argmin_faces(points.detach(), tris.detach(), part_mask,
                               point_part)
    B, P = imin.shape
    win = torch.gather(tris, 1, imin.long()[..., None, None].expand(B, P, 3, 3))
    return point_tri_sqdist(points, win)
