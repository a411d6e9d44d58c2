"""K3 — the point -> mesh nearest-face argmin (csrc/point_mesh.cu),
replacing the Pallas ``dsf_tpu/ops/pallas_point_mesh.py:argmin_faces_pallas``.

``argmin_faces_cuda`` builds the kernel's inputs in PyTorch, as XLA builds
the Pallas call's before it: 27 constants per face (``face_constants``),
one 32-bit word of admissible parts per face (``part_words``) and each
point's part as a bit index.  ``argmin_faces_launch`` launches the kernel
on them or raises; there is no fallback.  The plain version is
``point_mesh.argmin_faces_plain``.  No gradient passes the argmin, so
there is no backward.
"""

from __future__ import annotations

import ctypes

import torch

from dsf_tpu_torch.kernels import LAUNCHES, build

ROW = 28            # floats per face row: 27 constants + 1 pad (7 float4)
MAX_PARTS = 31      # one bit per part, bit 31 never set: "admits nothing"
_EPS = 1e-12

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("point_mesh").dsf_point_mesh_argmin
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    for name, t, shape, dtype in (("points", points, (B, P, 3), torch.float32),
                                  ("fc", fc, (B, T, ROW), torch.float32),
                                  ("words", words, (T,), torch.int32),
                                  ("parts", parts, (B, P), torch.int32)):
        if t.device.type != "cuda" or t.dtype != dtype:
            raise ValueError(f"{name}: need a {dtype} CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    if any(t.device != points.device for t in (fc, words, parts)):
        raise ValueError("points, fc, words and parts must be on one device")
    if fc.data_ptr() % 16:
        raise ValueError("fc: need a 16-byte aligned start (float4 reads)")
    if B == 0 or P == 0 or T == 0:
        raise ValueError(f"empty argmin: B={B}, P={P}, T={T}")
    dmin = torch.empty((B, P), dtype=torch.float32, device=points.device)
    imin = torch.empty((B, P), dtype=torch.int32, device=points.device)
    fn = _launcher()
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), fc.data_ptr(), words.data_ptr(),
                 parts.data_ptr(), dmin.data_ptr(), imin.data_ptr(), B, P, T,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "point_mesh_argmin")
    LAUNCHES["point_mesh_argmin"] += 1
    return dmin, imin


def argmin_faces_cuda(points, tris, part_mask=None, point_part=None):
    """points (B, P, 3), tris (B, T, 3, 3) on one GPU; optional factorized
    mask part_mask (T, K <= 31) bool + point_part (B, P) int, where parts
    outside [0, K) admit no face.  Returns (dmin, imin) as
    ``point_mesh.argmin_faces_plain`` does, with dmin the kernel's
    divide-free distance."""
    if points.device.type != "cuda":
        raise ValueError(f"points: need a CUDA tensor, got {points.device}")
    B, P = points.shape[0], points.shape[1]
    T = tris.shape[1]
    if part_mask is None:
        words = torch.full((T,), -1, dtype=torch.int32, device=points.device)
        parts = torch.zeros((B, P), dtype=torch.int32, device=points.device)
    else:
        K = part_mask.shape[1]
        words = part_words(part_mask.bool())
        parts = torch.where((point_part >= 0) & (point_part < K), point_part,
                            torch.full_like(point_part, K)).to(torch.int32)
    return argmin_faces_launch(points.float().contiguous(),
                               face_constants(tris), words.contiguous(),
                               parts.contiguous())
