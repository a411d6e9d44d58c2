"""K5 / K4 — the offset-codec kernels (csrc/codec.cu), replacing the Pallas
``dsf_tpu/ops/pallas_codec.py:_encode_fwd_call`` / ``_encode_bwd`` (K5)
and ``_decode_fwd_call`` / ``_decode_bwd`` (K4).

``*_cuda`` launch or raise.  ``EncodeFn`` and ``DecodeFn`` are the
``torch.autograd.Function``s the codec's CUDA path goes through where a
gradient is asked: forward and backward are each one wrapper call, as
``encode_pallas`` / ``decode_pallas`` are ``jax.custom_vjp``s over Pallas
kernels; their forwards call the custom ops ``dsf::encode`` /
``dsf::decode`` (``kernels/custom_ops.py``), whose CUDA implementations
are ``encode_cuda`` / ``decode_cuda``.  K4's
forward also returns its softmax statistics, which its VJP takes with
the joints instead of a second pass over the pixels (plain versions:
``offset_codec.decode_fwd_plain`` / ``decode_bwd_plain``).  The dispatch
that takes the plain versions for CPU tensors is in ``offset_codec``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dsf_tpu_torch.kernels import LAUNCHES, build

# K4 forward: a (image, joint) row's pixels are split over 1 to
# MAX_SPLIT CTAs (one cluster) while the grid holds fewer than FILL_CTAS
# (B=1, J=21: 4 a row, scripts/codec_shapes_gpu.py's fastest there; from
# B=3 on, one CTA a row and no cluster)
MAX_SPLIT = 8
FILL_CTAS = 84
# K5 bwd: an image's units are split over 1 to MAX_SPLIT CTAs (one
# cluster) so that the grid holds about ENC_FILL_CTAS, two a streaming
# multiprocessor (scripts/codec_shapes_gpu.py: 8 at B=32, 4 at B=64)
ENC_FILL_CTAS = 256

# the numbers of pointer, int and float arguments, then the stream
_SIGNATURES = {
    "dsf_codec_encode": (3, 3, 1),
    "dsf_codec_decode": (4, 4, 2),
    "dsf_codec_encode_bwd": (5, 4, 1),
    "dsf_codec_decode_bwd": (7, 3, 2),
}
_fns = {}


def _launcher(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library("codec"), name)
        n_ptr, n_int, n_float = _SIGNATURES[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(name, t, shape):
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{name}: need a float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: need contiguous {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _same_device(*ts):
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("codec inputs must be on one device")


def _launch(name, tensors, ints, floats):
    fn = _launcher(name)
    with build.on_device(*tensors) as stream:
        err = fn(*[t.data_ptr() for t in tensors], *ints,
                 *[float(f) for f in floats], stream)
    build.check(err, name)


def encode_cuda(joint, img_s, kernel_size):
    """joint (B, J, 3) normalized uvd + img_s (B, 1, S, S) at the feature
    size -> (B, 4J, S, S): [3J unit offsets | J cone heatmaps]."""
    B, J, _ = joint.shape
    S = img_s.shape[-1]
    _check("joint", joint, (B, J, 3))
    _check("img_s", img_s, (B, 1, S, S))
    _same_device(joint, img_s)
    out = torch.empty((B, 4 * J, S, S), dtype=torch.float32,
                      device=joint.device)
    _launch("dsf_codec_encode", (joint, img_s, out), (B, J, S),
            (kernel_size,))
    LAUNCHES["codec_encode"] += 1
    return out


@functools.lru_cache(maxsize=None)
def encode_bwd_max_joints():
    """The most joints the encode VJP's layout takes (csrc kEncJL x
    kEncJPT)."""
    fn = build.library("codec").dsf_codec_encode_bwd_max_joints
    fn.restype = ctypes.c_int
    return fn()


def encode_bwd_split(B):
    """CTAs an image of the K5 VJP: as many as fill ENC_FILL_CTAS, 1 to
    MAX_SPLIT."""
    return max(1, min(MAX_SPLIT, ENC_FILL_CTAS // B))


def encode_bwd_cuda(joint, img_s, g, kernel_size):
    """VJP of ``encode_cuda`` for the cotangent g (B, 4J, S, S) ->
    (d joint (B, J, 3), d img_s (B, 1, S, S)), one launch.  The cone and
    foreground masks are not differentiated, as in the JAX package; every
    element of g is read, so a non-finite one reaches its joint's d joint
    and its pixel's d img_s, as in autograd."""
    B, J, _ = joint.shape
    S = img_s.shape[-1]
    _check("joint", joint, (B, J, 3))
    _check("img_s", img_s, (B, 1, S, S))
    _check("g", g, (B, 4 * J, S, S))
    _same_device(joint, img_s, g)
    if J > encode_bwd_max_joints():
        raise ValueError(f"encode VJP: at most {encode_bwd_max_joints()} "
                         f"joints, got {J}")
    dj = torch.empty((B, J, 3), dtype=torch.float32, device=joint.device)
    dd = _empty_in_phase(img_s)
    _launch("dsf_codec_encode_bwd", (joint, img_s, g, dj, dd),
            (B, J, S, encode_bwd_split(B)), (kernel_size,))
    LAUNCHES["codec_encode_bwd"] += 1
    return dj, dd


def _decode_shapes(offset):
    B, C, S, _ = offset.shape
    J = C // 4
    if C != 4 * J:
        raise ValueError(f"offset: need 4J channels, got {C}")
    return B, C, J, S


def decode_split(B, J):
    """CTAs a (image, joint) row of the K4 forward: as many as B * J rows
    fit into FILL_CTAS, 1 to MAX_SPLIT."""
    return max(1, min(MAX_SPLIT, FILL_CTAS // (B * J)))


def decode_cuda(offset, depth_s, kernel_size, scale):
    """offset (B, 4J, S, S) + depth_s (B, 1, S, S) at the feature size ->
    (joints (B, J, 3): softmax(scale * heat * mask)-weighted votes, the
    softmax's statistics (B, J, 2): its max m and mass Z).  Any S and any
    start address (the kernel reads single pixels up to a 16-byte
    boundary)."""
    B, C, J, S = _decode_shapes(offset)
    _check("offset", offset, (B, C, S, S))
    _check("depth_s", depth_s, (B, 1, S, S))
    _same_device(offset, depth_s)
    y = torch.empty((B, J, 3), dtype=torch.float32, device=offset.device)
    stats = torch.empty((B, J, 2), dtype=torch.float32, device=offset.device)
    _launch("dsf_codec_decode", (offset, depth_s, y, stats),
            (B, J, S, decode_split(B, J)), (kernel_size, scale))
    LAUNCHES["codec_decode"] += 1
    return y, stats


def _empty_in_phase(t):
    """An empty contiguous float32 tensor shaped as ``t`` whose start lies
    as far past a 16-byte boundary as ``t``'s, so that the kernel's 16-byte
    loads of ``t`` and stores into it go together."""
    n = t.numel()
    buf = torch.empty(n + 3, dtype=torch.float32, device=t.device)
    skip = (t.data_ptr() - buf.data_ptr()) % 16 // 4
    return buf[skip:skip + n].view(t.shape)


def decode_bwd_cuda(offset, depth_s, g, y, stats, kernel_size, scale):
    """VJP of ``decode_cuda`` for the cotangent g (B, J, 3), from its
    joints y and statistics -> (d offset (B, 4J, S, S), d depth_s
    (B, 1, S, S)), one elementwise pass.  The mask comparison is not
    differentiated, as in the JAX package."""
    B, C, J, S = _decode_shapes(offset)
    _check("offset", offset, (B, C, S, S))
    _check("depth_s", depth_s, (B, 1, S, S))
    _check("g", g, (B, J, 3))
    _check("y", y, (B, J, 3))
    _check("stats", stats, (B, J, 2))
    _same_device(offset, depth_s, g, y, stats)
    dx = _empty_in_phase(offset)
    dd = _empty_in_phase(depth_s)
    _launch("dsf_codec_decode_bwd", (offset, depth_s, g, y, stats, dx, dd),
            (B, J, S), (kernel_size, scale))
    LAUNCHES["codec_decode_bwd"] += 1
    return dx, dd


class EncodeFn(torch.autograd.Function):
    """K5: forward the op ``dsf::encode`` (``encode_cuda`` on the card),
    backward ``encode_bwd_cuda``."""

    @staticmethod
    def forward(ctx, joint, img_s, kernel_size):
        from dsf_tpu_torch.kernels import custom_ops
        ctx.save_for_backward(joint, img_s)
        ctx.kernel_size = kernel_size
        return custom_ops.encode(joint, img_s, kernel_size)

    @staticmethod
    def backward(ctx, g):
        joint, img_s = ctx.saved_tensors
        dj, dd = encode_bwd_cuda(joint, img_s, g.contiguous(),
                                 ctx.kernel_size)
        return dj, dd, None


class DecodeFn(torch.autograd.Function):
    """K4: forward the op ``dsf::decode`` (``decode_cuda`` on the card),
    backward ``decode_bwd_cuda`` from the forward's joints and
    statistics."""

    @staticmethod
    def forward(ctx, offset, depth_s, kernel_size, scale):
        from dsf_tpu_torch.kernels import custom_ops
        y, stats = custom_ops.decode(offset, depth_s, kernel_size, scale)
        ctx.save_for_backward(offset, depth_s, y, stats)
        ctx.kernel_size, ctx.scale = kernel_size, scale
        return y

    @staticmethod
    def backward(ctx, g):
        offset, depth_s, y, stats = ctx.saved_tensors
        dx, dd = decode_bwd_cuda(offset, depth_s, g.contiguous(), y, stats,
                                 ctx.kernel_size, ctx.scale)
        return dx, dd, None, None
