"""The point -> mesh nearest-face argmin kernels: K3 (csrc/point_mesh.cu),
replacing the Pallas ``dsf_tpu/ops/pallas_point_mesh.py:argmin_faces_pallas``;
K7 (csrc/point_mesh_v2.cu), replacing ``argmin_faces_pallas_v2``; K8
(csrc/point_mesh_culled.cu), replacing ``argmin_faces_pallas_culled``.

All three build their tables on the card (csrc/argmin_setup.cuh) and run
an argmin body of csrc/argmin_body.cuh on them.  K3 and K8 are one design:
``argmin_setup_cuda`` builds their tables (``ArgminTables``: the face
rows, each part's face list, each cloud's points grouped by part into
tiles, and for K8 the face order and the cull), and
``argmin_faces_launch`` (K3) or ``argmin_faces_culled_launch`` (K8) runs
the argmin on them; ``argmin_faces_cuda`` and ``argmin_faces_culled_cuda``
are the two launches together.  The plain versions of the tables are
``point_mesh.argmin_tables_plain`` (rows by ``face_constants`` and
``point_mesh.face_constants16``), of the argmin
``point_mesh.argmin_faces_plain`` and, on the tables,
``point_mesh.argmin_faces_tiles_plain`` and
``point_mesh.argmin_faces_culled_plain``.

K7 keeps the caller's point order: ``v2_setup_cuda`` builds its tables
(``V2Tables``: the face order by part, the 28-float rows and the face
words in that order, the chunk ORs, the points' parts and one skip word
per (cloud, 128-point tile)), whose plain version is
``point_mesh.v2_tables_plain``; ``argmin_faces_v2_launch`` runs its argmin
on them and ``argmin_faces_v2_cuda`` is the two together.

Only the argmin launches count.  Each wrapper launches its kernel or
raises; there is no fallback.  No gradient passes the argmin, so there is
no backward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dsf_tpu_torch.kernels import LAUNCHES, build

ROW = 28            # floats per face row: 27 constants + 1 pad (7 float4)
ROW16 = 16          # floats per face row of K8 (4 float4)
MAX_PARTS = 31      # one bit per part, bit 31 never set: "admits nothing"
MAX_CHUNKS = 32     # K8's 128-face chunks: one bit each in a need word
MAX_TILES = 256     # tiles per cloud (csrc kMaxTiles)
CHUNK = 128         # faces per chunk (csrc kChunk)
THREADS = 64        # threads of a group of K3's and K8's argmin, each group
                    # a segment of the face list (csrc kThreads, kGroups)
POINTS_PER_THREAD = 3  # points a thread owns (csrc kR)
TILE_POINTS = THREADS * POINTS_PER_THREAD
V2_TILE = 128       # K7's points a skip word (csrc kV2Tile)
V2_MAX_CHUNKS = 31  # K7's 128-face chunks: one bit each in a skip word
V2_THREADS = 32     # threads of a group of K7's argmin (csrc point_mesh_v2.cu)
V2_POINTS_PER_THREAD = 4  # points a thread of K7 owns (csrc kR)


def face_terms(tris):
    """The vectors and dot products of the face rows, each product and sum
    rounded on its own, left to right, as csrc/argmin_setup.cuh writes
    them: tris (B, T, 3, 3) -> V (B, T, 7, 3) = a b c ab ac bc n (n = ab x
    ac) and dots (B, T, 15) = ab.a ac.a ab.b ac.b ab.c ac.c a.a b.b c.c
    ab.ab ac.ac bc.bc bc.b n.a n.n."""
    tris = tris.float()
    e = tris[..., [1, 2, 2], :] - tris[..., [0, 0, 1], :]       # ab ac bc
    ab, ac = e[..., 0, :], e[..., 1, :]
    n = (ab[..., [1, 2, 0]] * ac[..., [2, 0, 1]]
         - ab[..., [2, 0, 1]] * ac[..., [1, 2, 0]])
    v = torch.cat([tris, e, n[..., None, :]], dim=-2)
    prod = (v[..., [3, 4, 3, 4, 3, 4, 0, 1, 2, 3, 4, 5, 5, 6, 6], :]
            * v[..., [0, 0, 1, 1, 2, 2, 0, 1, 2, 3, 4, 5, 1, 0, 6], :])
    return v, prod[..., 0] + prod[..., 1] + prod[..., 2]


def face_constants(tris):
    """(B, T, 3, 3) -> (B, T, 28) float32 rows: a(3) ab(3) ac(3) n(3) |
    ab.a ac.a ab.b ac.b ab.c ac.c | a.a b.b c.c | 1/ab.ab 1/ac.ac 1/bc.bc |
    bc.b n.a 1/max(n.n, 1e-12) | 0 (the Pallas kernel's ``_face_constants27``
    rows, face-major; ``face_terms``' rounding).  Needs non-degenerate faces
    (nonzero edges and area)."""
    v, dots = face_terms(tris)
    return torch.cat([
        v[..., 0, :], v[..., 3, :], v[..., 4, :], v[..., 6, :], dots[..., :9],
        torch.reciprocal(dots[..., 9:12]), dots[..., 12:14],
        torch.reciprocal(torch.clamp_min(dots[..., 14:], 1e-12)),
        torch.zeros_like(dots[..., :1])], dim=-1).contiguous()


def part_words(part_mask):
    """(T, K) bool, K <= 31 -> (T,) int32 whose bit k is part_mask[:, k]."""
    T, K = part_mask.shape
    if K > MAX_PARTS:
        raise ValueError(f"at most {MAX_PARTS} parts, got {K}")
    bits = torch.ones(K, dtype=torch.int64, device=part_mask.device) << \
        torch.arange(K, device=part_mask.device)
    return (part_mask.long() * bits).sum(-1).to(torch.int32)


class ArgminTables(NamedTuple):
    """K3's and K8's tables over N clouds of P points and T faces, with Kp
    = K + 1 columns of the extended part table (column K admits nothing)
    and G = ceil(T / 128) chunks; all int32 but rows."""
    rows: torch.Tensor      # (N, T, 28) K3, (N, T, 16) K8 in fperm's order
    lists: torch.Tensor     # (Kp, T) ascending faces each part admits, -1 after
    lens: torch.Tensor      # (Kp,)
    choff: torch.Tensor     # (Kp, G + 1) list position of chunk g's first face
    key: torch.Tensor       # (N, P) part (K3), part * G + nearest chunk (K8)
    perm: torch.Tensor      # (N, P) the points stably sorted by key
    tiles: torch.Tensor     # (N, maxT, 4) (part, first, count, run)
    tcount: torch.Tensor    # (N, 2) tiles, first position of part K
    fperm: Optional[torch.Tensor]  # (T,) K8's face order by first part
    need: Optional[torch.Tensor]   # (N, P) K8's chunks each point needs
    tile_points: int        # points a tile holds at most


def max_tiles(P, K, tile):
    """Tiles a cloud of P points in K parts can need, plus one."""
    return P // tile + K + 1


def _mask_and_parts(part_mask, point_part, N, P, T, device):
    """The set-up's form of the factorized mask: (T, K) bool and (N, P)
    int64, or None and None (one part that admits every face)."""
    if part_mask is None:
        return None, 1, None
    mask = part_mask.bool().contiguous()
    K = mask.shape[1]
    if K > MAX_PARTS or tuple(mask.shape) != (T, K):
        raise ValueError(f"need a (T={T}, K <= {MAX_PARTS}) part table, got "
                         f"{tuple(mask.shape)}")
    parts = point_part.to(device=device, dtype=torch.int64).contiguous()
    build.check_tensors((("part_mask", mask, (T, K), torch.bool, 1),
                         ("point_part", parts, (N, P), torch.int64, 8)))
    return mask, K, parts


def argmin_setup_cuda(points, tris, part_mask=None, point_part=None,
                      culled=False, tile=TILE_POINTS):
    """The set-up kernel (csrc/argmin_setup.cuh) of K3, or of K8 with
    ``culled``: points (N, P, 3), tris (N, T, 3, 3) float32 and the
    optional factorized mask part_mask (T, K <= 31) bool + point_part (N,
    P) int (parts outside [0, K) admit no face), on one GPU ->
    ``ArgminTables`` with tiles of at most ``tile`` points.  K8 needs T <=
    32 * 128.  Does not count as a launch of K3 or K8."""
    if points.device.type != "cuda":
        raise ValueError(f"points: need a CUDA tensor, got {points.device}")
    N, P = points.shape[0], points.shape[1]
    T = tris.shape[1]
    dev = points.device
    build.check_tensors((("points", points, (N, P, 3), torch.float32, 4),
                         ("tris", tris, (N, T, 3, 3), torch.float32, 4)))
    mask, K, parts = _mask_and_parts(part_mask, point_part, N, P, T, dev)
    G = -(-T // CHUNK)
    maxT = max_tiles(P, K, tile)
    if N == 0 or P == 0 or T == 0:
        raise ValueError(f"empty argmin: N={N}, P={P}, T={T}")
    if maxT > MAX_TILES or (culled and G > MAX_CHUNKS):
        raise ValueError(f"too many tiles or chunks: P={P}, K={K}, T={T}")
    i32 = dict(dtype=torch.int32, device=dev)
    rows = torch.empty((N, T, ROW16 if culled else ROW), dtype=torch.float32,
                       device=dev)
    fword = torch.empty((T,), **i32)
    lists = torch.empty((K + 1, T), **i32)
    lens = torch.empty((K + 1,), **i32)
    choff = torch.empty((K + 1, G + 1), **i32)
    key = torch.empty((N, P), **i32)
    perm = torch.empty((N, P), **i32)
    tiles = torch.empty((N, maxT, 4), **i32)
    tcount = torch.empty((N, 2), **i32)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    with build.on_device(points, tris, mask, parts) as stream:
        if culled:
            fkey = torch.empty((T,), **i32)
            fperm = torch.empty((T,), **i32)
            need = torch.empty((N, P), **i32)
            fn = build.function("point_mesh_culled",
                                "dsf_point_mesh_culled_setup", 16, 6)
            err = fn(points.data_ptr(), tris.data_ptr(), ptr(mask),
                     ptr(parts), rows.data_ptr(), fword.data_ptr(),
                     fkey.data_ptr(), fperm.data_ptr(), lists.data_ptr(),
                     lens.data_ptr(), choff.data_ptr(), key.data_ptr(),
                     need.data_ptr(), perm.data_ptr(), tiles.data_ptr(),
                     tcount.data_ptr(), N, P, T, K, tile, maxT, stream)
        else:
            fperm = need = None
            fn = build.function("point_mesh", "dsf_point_mesh_setup", 13, 6)
            err = fn(points.data_ptr(), tris.data_ptr(), ptr(mask),
                     ptr(parts), rows.data_ptr(), fword.data_ptr(),
                     lists.data_ptr(), lens.data_ptr(), choff.data_ptr(),
                     key.data_ptr(), perm.data_ptr(), tiles.data_ptr(),
                     tcount.data_ptr(), N, P, T, K, tile, maxT, stream)
    build.check(err, "icp_argmin_culled set-up" if culled
                else "point_mesh_argmin set-up")
    return ArgminTables(rows, lists, lens, choff, key, perm, tiles, tcount,
                        fperm, need, tile)


def _check_tables(points, tb, row):
    """The argmin launches' checks: the shapes of ``tb`` against points
    (N, P, 3) float32, rows of ``row`` floats, tiles of TILE_POINTS."""
    N, P = points.shape[0], points.shape[1]
    T = tb.rows.shape[1]
    Kp, G = tb.lists.shape[0], -(-T // CHUNK)
    maxT = tb.tiles.shape[1]
    if tb.tile_points != TILE_POINTS:
        raise ValueError(f"tables of {tb.tile_points}-point tiles, the "
                         f"kernel takes {TILE_POINTS}")
    i32 = torch.int32
    build.check_tensors((("points", points, (N, P, 3), torch.float32, 4),
                         ("rows", tb.rows, (N, T, row), torch.float32, 16),
                         ("lists", tb.lists, (Kp, T), i32, 4),
                         ("lens", tb.lens, (Kp,), i32, 4),
                         ("choff", tb.choff, (Kp, G + 1), i32, 4),
                         ("perm", tb.perm, (N, P), i32, 4),
                         ("tiles", tb.tiles, (N, maxT, 4), i32, 16),
                         ("tcount", tb.tcount, (N, 2), i32, 4)))
    if N == 0 or P == 0 or T == 0:
        raise ValueError(f"empty argmin: N={N}, P={P}, T={T}")
    return N, P, T, maxT


def argmin_faces_launch(points, tables):
    """The K3 argmin on ``argmin_setup_cuda``'s tables (without
    ``culled``) and points (N, P, 3) float32 on one GPU.  Returns (dmin (N,
    P) float32, imin (N, P) int32) in the points' order; a point that
    admits no face gets (1e10, 0)."""
    if points.device.type != "cuda":
        raise ValueError(f"points: need a CUDA tensor, got {points.device}")
    N, P, T, maxT = _check_tables(points, tables, ROW)
    dmin = torch.empty((N, P), dtype=torch.float32, device=points.device)
    imin = torch.empty((N, P), dtype=torch.int32, device=points.device)
    fn = build.function("point_mesh", "dsf_point_mesh_argmin", 9, 4)
    with build.on_device(points, tables.rows, tables.lists, tables.lens,
                         tables.perm, tables.tiles, tables.tcount) as stream:
        err = fn(points.data_ptr(), tables.rows.data_ptr(),
                 tables.lists.data_ptr(), tables.lens.data_ptr(),
                 tables.perm.data_ptr(), tables.tiles.data_ptr(),
                 tables.tcount.data_ptr(), dmin.data_ptr(), imin.data_ptr(),
                 N, P, T, maxT, stream)
    build.check(err, "point_mesh_argmin")
    LAUNCHES["point_mesh_argmin"] += 1
    return dmin, imin


def argmin_faces_cuda(points, tris, part_mask=None, point_part=None):
    """K3: points (N, P, 3), tris (N, T, 3, 3) on one GPU and the optional
    factorized mask part_mask (T, K <= 31) bool + point_part (N, P) int,
    where parts outside [0, K) admit no face.  Returns (dmin, imin) as
    ``point_mesh.argmin_faces_plain`` does, with dmin the kernel's
    divide-free distance: the set-up, then the argmin."""
    points = points.float().contiguous()
    tables = argmin_setup_cuda(points, tris.float().contiguous(), part_mask,
                               point_part)
    return argmin_faces_launch(points, tables)


def argmin_faces_culled_launch(points, tables):
    """The K8 argmin on ``argmin_setup_cuda(..., culled=True)``'s tables and
    points (N, P, 3) float32 on one GPU.  Returns (dmin, imin) in the
    points' order with the caller's face ids; a point that admits no face
    gets (1e10, fperm[0])."""
    if points.device.type != "cuda":
        raise ValueError(f"points: need a CUDA tensor, got {points.device}")
    N, P, T, maxT = _check_tables(points, tables, ROW16)
    build.check_tensors((("fperm", tables.fperm, (T,), torch.int32, 4),))
    if -(-T // CHUNK) > MAX_CHUNKS:
        raise ValueError(f"K8 takes at most {MAX_CHUNKS * CHUNK} faces, got "
                         f"{T}")
    dmin = torch.empty((N, P), dtype=torch.float32, device=points.device)
    imin = torch.empty((N, P), dtype=torch.int32, device=points.device)
    fn = build.function("point_mesh_culled", "dsf_point_mesh_argmin_culled",
                        10, 4)
    with build.on_device(points, tables.rows, tables.lists, tables.choff,
                         tables.fperm, tables.perm, tables.tiles,
                         tables.tcount) as stream:
        err = fn(points.data_ptr(), tables.rows.data_ptr(),
                 tables.lists.data_ptr(), tables.choff.data_ptr(),
                 tables.fperm.data_ptr(), tables.perm.data_ptr(),
                 tables.tiles.data_ptr(), tables.tcount.data_ptr(),
                 dmin.data_ptr(), imin.data_ptr(), N, P, T, maxT, stream)
    build.check(err, "icp_argmin_culled")
    LAUNCHES["icp_argmin_culled"] += 1
    return dmin, imin


def argmin_faces_culled_cuda(points, tris, part_mask=None, point_part=None):
    """K8 on K3's inputs (see ``argmin_faces_cuda``): the set-up with the
    cull, then the argmin.  Returns (dmin, imin) in the caller's point order
    and face ids, dmin the 16-constant form's distance."""
    points = points.float().contiguous()
    tables = argmin_setup_cuda(points, tris.float().contiguous(), part_mask,
                               point_part, culled=True)
    return argmin_faces_culled_launch(points, tables)


class V2Tables(NamedTuple):
    """K7's tables over N clouds of P points and T faces (caller's order),
    G = ceil(T / 128) chunks and NT = ceil(P / 128) tiles; all int32 but
    rows."""
    fperm: torch.Tensor     # (T,) the faces in the stable order of first part
    rows: torch.Tensor      # (N, T, 28) face_constants in fperm's order
    words: torch.Tensor     # (T,) admissible parts as bits, fperm's order
    chunk_or: torch.Tensor  # (G,) each 128-face chunk's OR of words
    parts: torch.Tensor     # (N, P) each point's part in [0, K]
    skip: torch.Tensor      # (N, NT) the chunks each tile runs


def v2_setup_cuda(points, tris, part_mask=None, point_part=None):
    """K7's set-up kernel (csrc/argmin_setup.cuh, two launches): points (N,
    P, 3), tris (N, T, 3, 3) float32 in the caller's face order and the
    optional factorized mask part_mask (T, K <= 31) bool + point_part (N,
    P) int (parts outside [0, K) admit no face), on one GPU ->
    ``V2Tables``.  Needs T <= 31 * 128.  Does not count as a launch of
    K7."""
    if points.device.type != "cuda":
        raise ValueError(f"points: need a CUDA tensor, got {points.device}")
    N, P = points.shape[0], points.shape[1]
    T = tris.shape[1]
    dev = points.device
    build.check_tensors((("points", points, (N, P, 3), torch.float32, 4),
                         ("tris", tris, (N, T, 3, 3), torch.float32, 4)))
    mask, K, parts = _mask_and_parts(part_mask, point_part, N, P, T, dev)
    G = -(-T // CHUNK)
    if N == 0 or P == 0 or T == 0 or G > V2_MAX_CHUNKS:
        raise ValueError(f"K7 takes 1..{V2_MAX_CHUNKS * CHUNK} faces and a "
                         f"nonempty cloud: N={N}, P={P}, T={T}")
    i32 = dict(dtype=torch.int32, device=dev)
    rows = torch.empty((N, T, ROW), dtype=torch.float32, device=dev)
    fword, fkey, fperm, words = (torch.empty((T,), **i32) for _ in range(4))
    cor = torch.empty((G,), **i32)
    parts32 = torch.empty((N, P), **i32)
    skip = torch.empty((N, -(-P // V2_TILE)), **i32)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    fn = build.function("point_mesh_v2", "dsf_point_mesh_v2_setup", 11, 4)
    with build.on_device(points, tris, mask, parts) as stream:
        err = fn(tris.data_ptr(), ptr(mask), ptr(parts), rows.data_ptr(),
                 fword.data_ptr(), fkey.data_ptr(), fperm.data_ptr(),
                 words.data_ptr(), cor.data_ptr(), parts32.data_ptr(),
                 skip.data_ptr(), N, P, T, K, stream)
    build.check(err, "icp_argmin_v2 set-up")
    return V2Tables(fperm, rows, words, cor, parts32, skip)


def argmin_faces_v2_launch(points, tables):
    """The K7 argmin on ``v2_setup_cuda``'s tables and points (N, P, 3)
    float32 on one GPU: over the (128-point tile, 128-face chunk) blocks
    whose skip bit is set.  Returns (dmin (N, P) float32, imin (N, P)
    int32) with the caller's face ids; a point that admits no face in
    those blocks gets (1e10, fperm[0])."""
    if points.device.type != "cuda":
        raise ValueError(f"points: need a CUDA tensor, got {points.device}")
    N, P = points.shape[0], points.shape[1]
    T = tables.rows.shape[1]
    G, NT = -(-T // CHUNK), -(-P // V2_TILE)
    i32 = torch.int32
    build.check_tensors((("points", points, (N, P, 3), torch.float32, 4),
                         ("rows", tables.rows, (N, T, ROW), torch.float32,
                          16),
                         ("words", tables.words, (T,), i32, 4),
                         ("parts", tables.parts, (N, P), i32, 4),
                         ("skip", tables.skip, (N, NT), i32, 4),
                         ("fperm", tables.fperm, (T,), i32, 4)))
    if N == 0 or P == 0 or T == 0 or G > V2_MAX_CHUNKS:
        raise ValueError(f"K7 takes 1..{V2_MAX_CHUNKS * CHUNK} faces and a "
                         f"nonempty cloud: N={N}, P={P}, T={T}")
    dmin = torch.empty((N, P), dtype=torch.float32, device=points.device)
    imin = torch.empty((N, P), dtype=i32, device=points.device)
    fn = build.function("point_mesh_v2", "dsf_point_mesh_argmin_v2", 8, 3)
    with build.on_device(points, tables.rows, tables.words, tables.parts,
                         tables.skip, tables.fperm) as stream:
        err = fn(points.data_ptr(), tables.rows.data_ptr(),
                 tables.words.data_ptr(), tables.parts.data_ptr(),
                 tables.skip.data_ptr(), tables.fperm.data_ptr(),
                 dmin.data_ptr(), imin.data_ptr(), N, P, T, stream)
    build.check(err, "icp_argmin_v2")
    LAUNCHES["icp_argmin_v2"] += 1
    return dmin, imin


def argmin_faces_v2_cuda(points, tris, part_mask=None, point_part=None):
    """K7 on K3's inputs (see ``argmin_faces_cuda``), faces in the caller's
    order: the set-up, then the argmin.  Returns (dmin, imin) with the
    caller's face ids, dmin the divide-free form's distance."""
    points = points.float().contiguous()
    tables = v2_setup_cuda(points, tris.float().contiguous(), part_mask,
                           point_part)
    return argmin_faces_v2_launch(points, tables)
