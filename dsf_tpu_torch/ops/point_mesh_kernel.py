"""The point -> mesh nearest-face argmin kernels: K3 (csrc/point_mesh.cu),
replacing the Pallas ``dsf_tpu/ops/pallas_point_mesh.py:argmin_faces_pallas``;
K7 (csrc/point_mesh_v2.cu), replacing ``argmin_faces_pallas_v2``; K8
(csrc/point_mesh_culled.cu), replacing ``argmin_faces_pallas_culled``.

``argmin_faces_cuda`` builds the kernel's inputs in PyTorch, as XLA builds
the Pallas call's before it: 27 constants per face (``face_constants``),
one 32-bit word of admissible parts per face (``part_words``) and each
point's part as a bit index.  ``argmin_faces_launch`` launches the kernel
on them or raises; there is no fallback.  The plain version is
``point_mesh.argmin_faces_plain``.  K7 takes the same inputs and one skip
word per (cloud, 128-point tile) (``point_mesh.v2_words``; plain version
``point_mesh.argmin_faces_v2_plain``).  K8 takes 16 constants per face
(``point_mesh.face_constants16``), the points sorted, and a run table
(``point_mesh.culled_tables``; plain version
``point_mesh.argmin_faces_culled_plain``).  No gradient passes the argmin,
so there is no backward.
"""

from __future__ import annotations

import torch

from dsf_tpu_torch.kernels import LAUNCHES, build

ROW = 28            # floats per face row: 27 constants + 1 pad (7 float4)
MAX_PARTS = 31      # one bit per part, bit 31 never set: "admits nothing"
_EPS = 1e-12

ROW16 = 16          # floats per face row of K8 (4 float4)

def face_constants(tris):
    """(B, T, 3, 3) -> (B, T, 28) float32 rows: a(3) ab(3) ac(3) n(3) |
    ab.a ac.a ab.b ac.b ab.c ac.c | a.a b.b c.c | 1/ab.ab 1/ac.ac 1/bc.bc |
    bc.b n.a 1/n.n | 0 (the Pallas kernel's ``_face_constants27`` rows,
    face-major).  Needs non-degenerate faces (nonzero edges and area)."""
    tris = tris.float()
    a, b, c = tris[..., 0, :], tris[..., 1, :], tris[..., 2, :]
    ab, ac, bc = b - a, c - a, c - b
    n = torch.cross(ab, ac, dim=-1)

    def dot(x, y):
        return (x * y).sum(-1, keepdim=True)

    return torch.cat([
        a, ab, ac, n,
        dot(ab, a), dot(ac, a), dot(ab, b), dot(ac, b), dot(ab, c), dot(ac, c),
        dot(a, a), dot(b, b), dot(c, c),
        1.0 / dot(ab, ab), 1.0 / dot(ac, ac), 1.0 / dot(bc, bc),
        dot(bc, b), dot(n, a), 1.0 / torch.clamp_min(dot(n, n), _EPS),
        torch.zeros_like(a[..., :1])], dim=-1).contiguous()


def part_words(part_mask):
    """(T, K) bool, K <= 31 -> (T,) int32 whose bit k is part_mask[:, k]."""
    T, K = part_mask.shape
    if K > MAX_PARTS:
        raise ValueError(f"at most {MAX_PARTS} parts, got {K}")
    bits = torch.ones(K, dtype=torch.int64, device=part_mask.device) << \
        torch.arange(K, device=part_mask.device)
    return (part_mask.long() * bits).sum(-1).to(torch.int32)


def argmin_faces_launch(points, fc, words, parts):
    """The K3 kernel.  points (B, P, 3) float32, fc (B, T, 28) float32
    from ``face_constants``, words (T,) int32 from ``part_words``, parts
    (B, P) int32 in [0, 31]; all contiguous on one GPU.  Face t is
    admissible for point p iff bit parts[p] of words[t] is set.  Returns
    (dmin (B, P) float32, imin (B, P) int32); a point that admits no face
    gets (1e10, 0)."""
    B, P = points.shape[0], points.shape[1]
    T = fc.shape[1]
    # fc is read as float4
    build.check_tensors((("points", points, (B, P, 3), torch.float32, 4),
                         ("fc", fc, (B, T, ROW), torch.float32, 16),
                         ("words", words, (T,), torch.int32, 4),
                         ("parts", parts, (B, P), torch.int32, 4)))
    if B == 0 or P == 0 or T == 0:
        raise ValueError(f"empty argmin: B={B}, P={P}, T={T}")
    dmin = torch.empty((B, P), dtype=torch.float32, device=points.device)
    imin = torch.empty((B, P), dtype=torch.int32, device=points.device)
    fn = build.function("point_mesh", "dsf_point_mesh_argmin", 6, 3)
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), fc.data_ptr(), words.data_ptr(),
                 parts.data_ptr(), dmin.data_ptr(), imin.data_ptr(), B, P, T,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "point_mesh_argmin")
    LAUNCHES["point_mesh_argmin"] += 1
    return dmin, imin


def _words_and_parts(part_mask, point_part, B, P, T, device):
    """The kernels' form of the factorized mask: (T,) int32 words and (B,
    P) int32 bit indices, where parts outside [0, K) get K, a bit no word
    sets.  Without a mask every face admits part 0."""
    if part_mask is None:
        return (torch.full((T,), -1, dtype=torch.int32, device=device),
                torch.zeros((B, P), dtype=torch.int32, device=device))
    K = part_mask.shape[1]
    parts = torch.where((point_part >= 0) & (point_part < K), point_part,
                        torch.full_like(point_part, K)).to(torch.int32)
    return part_words(part_mask.bool()).contiguous(), parts.contiguous()


def argmin_faces_cuda(points, tris, part_mask=None, point_part=None):
    """points (B, P, 3), tris (B, T, 3, 3) on one GPU; optional factorized
    mask part_mask (T, K <= 31) bool + point_part (B, P) int, where parts
    outside [0, K) admit no face.  Returns (dmin, imin) as
    ``point_mesh.argmin_faces_plain`` does, with dmin the kernel's
    divide-free distance."""
    if points.device.type != "cuda":
        raise ValueError(f"points: need a CUDA tensor, got {points.device}")
    B, P = points.shape[0], points.shape[1]
    words, parts = _words_and_parts(part_mask, point_part, B, P,
                                    tris.shape[1], points.device)
    return argmin_faces_launch(points.float().contiguous(),
                               face_constants(tris), words, parts)


def argmin_faces_v2_launch(points, fc, words, parts, skip):
    """The K7 kernel: K3's inputs (see ``argmin_faces_launch``) and skip
    (B, ceil(P / 128)) int32 from ``point_mesh.v2_words``, whose bit ci
    lets the block of 128 points run face chunk ci (faces 128 ci ...).
    Returns (dmin, imin) as K3 does over the blocks it runs."""
    B, P = points.shape[0], points.shape[1]
    T = fc.shape[1]
    NT = -(-P // 128)
    build.check_tensors((("points", points, (B, P, 3), torch.float32, 4),
                         ("fc", fc, (B, T, ROW), torch.float32, 16),
                         ("words", words, (T,), torch.int32, 4),
                         ("parts", parts, (B, P), torch.int32, 4),
                         ("skip", skip, (B, NT), torch.int32, 4)))
    if B == 0 or P == 0 or T == 0 or T > 31 * 128:
        raise ValueError(f"K7 takes 1..{31 * 128} faces and a nonempty "
                         f"cloud: B={B}, P={P}, T={T}")
    dmin = torch.empty((B, P), dtype=torch.float32, device=points.device)
    imin = torch.empty((B, P), dtype=torch.int32, device=points.device)
    fn = build.function("point_mesh_v2", "dsf_point_mesh_argmin_v2", 7, 3)
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), fc.data_ptr(), words.data_ptr(),
                 parts.data_ptr(), skip.data_ptr(), dmin.data_ptr(),
                 imin.data_ptr(), B, P, T,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "icp_argmin_v2")
    LAUNCHES["icp_argmin_v2"] += 1
    return dmin, imin


def argmin_faces_v2_cuda(points, tris, part_mask, point_part, skip):
    """K7 on points (B, P, 3) and tris (B, T, 3, 3) in the caller's (part
    sorted) face order, the optional factorized mask as K3's and the skip
    words of ``point_mesh.v2_words``."""
    if points.device.type != "cuda":
        raise ValueError(f"points: need a CUDA tensor, got {points.device}")
    B, P = points.shape[0], points.shape[1]
    words, parts = _words_and_parts(part_mask, point_part, B, P,
                                    tris.shape[1], points.device)
    return argmin_faces_v2_launch(points.float().contiguous(),
                                  face_constants(tris), words, parts,
                                  skip.contiguous())


def argmin_faces_culled_cuda(pts_s, fc, ext, parts_s, run):
    """The K8 kernel, on ``point_mesh.argmin_faces_culled_plain``'s inputs:
    sorted points pts_s (B, P, 3) float32, face rows fc (B, T, 16) float32
    from ``point_mesh.face_constants16``, the extended part table ext (T,
    K + 1 <= 31) bool, the points' parts parts_s (B, P) in [0, K] and the
    run table (B, ceil(P / 128), ceil(T / 128)) int32.  Returns (dmin,
    imin) in the sorted point order; (1e10, 0) where nothing is run."""
    if pts_s.device.type != "cuda":
        raise ValueError(f"points: need a CUDA tensor, got {pts_s.device}")
    B, P = pts_s.shape[0], pts_s.shape[1]
    T = fc.shape[1]
    NT, G = -(-P // 128), -(-T // 128)
    words = part_words(ext.bool()).contiguous()
    parts = parts_s.to(torch.int32).contiguous()
    build.check_tensors((("points", pts_s, (B, P, 3), torch.float32, 4),
                         ("fc", fc, (B, T, ROW16), torch.float32, 16),
                         ("words", words, (T,), torch.int32, 4),
                         ("parts", parts, (B, P), torch.int32, 4),
                         ("run", run, (B, NT, G), torch.int32, 4)))
    if B == 0 or P == 0 or T == 0:
        raise ValueError(f"empty argmin: B={B}, P={P}, T={T}")
    dmin = torch.empty((B, P), dtype=torch.float32, device=pts_s.device)
    imin = torch.empty((B, P), dtype=torch.int32, device=pts_s.device)
    fn = build.function("point_mesh_culled",
                        "dsf_point_mesh_argmin_culled", 7, 3)
    with torch.cuda.device(pts_s.device):
        err = fn(pts_s.data_ptr(), fc.data_ptr(), words.data_ptr(),
                 parts.data_ptr(), run.data_ptr(), dmin.data_ptr(),
                 imin.data_ptr(), B, P, T,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "icp_argmin_culled")
    LAUNCHES["icp_argmin_culled"] += 1
    return dmin, imin
