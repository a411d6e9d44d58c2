"""K5 / K4 — the offset-codec kernels (csrc/codec.cu), replacing the Pallas
``dsf_tpu/ops/pallas_codec.py:_encode_fwd_call`` / ``_encode_bwd`` (K5)
and ``_decode_fwd_call`` / ``_decode_bwd`` (K4).

``*_cuda`` launch or raise.  ``EncodeFn`` and ``DecodeFn`` are the
``torch.autograd.Function``s the codec's CUDA path goes through: forward
and backward are each one kernel launch, as ``encode_pallas`` /
``decode_pallas`` are ``jax.custom_vjp``s over Pallas kernels.  The
dispatch that takes the plain versions for CPU tensors is in
``offset_codec``.
"""

from __future__ import annotations

import ctypes

import torch

from dsf_tpu_torch.kernels import LAUNCHES, build

ENC_THREADS = 256       # csrc kEncThreads: pixels per encode-VJP block

# pointer arguments, then B, J, S, then float arguments, then the stream
_SIGNATURES = {
    "dsf_codec_encode": (3, 1),
    "dsf_codec_decode": (3, 2),
    "dsf_codec_encode_bwd": (6, 1),
    "dsf_codec_decode_bwd": (6, 2),
}
_fns = {}


def _launcher(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library("codec"), name)
        n_ptr, n_float = _SIGNATURES[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
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


def _launch(name, tensors, B, J, S, floats):
    fn = _launcher(name)
    with torch.cuda.device(tensors[0].device):
        err = fn(*[t.data_ptr() for t in tensors], B, J, S,
                 *[float(f) for f in floats],
                 torch.cuda.current_stream().cuda_stream)
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
    _launch("dsf_codec_encode", (joint, img_s, out), B, J, S, (kernel_size,))
    LAUNCHES["codec_encode"] += 1
    return out


def encode_bwd_cuda(joint, img_s, g, kernel_size):
    """VJP of ``encode_cuda`` for the cotangent g (B, 4J, S, S) ->
    (d joint (B, J, 3), d img_s (B, 1, S, S)).  The cone and foreground
    masks are not differentiated, as in the JAX package."""
    B, J, _ = joint.shape
    S = img_s.shape[-1]
    _check("joint", joint, (B, J, 3))
    _check("img_s", img_s, (B, 1, S, S))
    _check("g", g, (B, 4 * J, S, S))
    _same_device(joint, img_s, g)
    nblk = -(-(S * S) // ENC_THREADS)
    dj = torch.empty((B, J, 3), dtype=torch.float32, device=joint.device)
    dd = torch.empty((B, 1, S, S), dtype=torch.float32, device=joint.device)
    part = torch.empty((B, nblk, 3 * J), dtype=torch.float32,
                       device=joint.device)
    _launch("dsf_codec_encode_bwd", (joint, img_s, g, dj, dd, part), B, J, S,
            (kernel_size,))
    LAUNCHES["codec_encode_bwd"] += 1
    return dj, dd


def _decode_shapes(offset):
    B, C, S, _ = offset.shape
    J = C // 4
    if C != 4 * J:
        raise ValueError(f"offset: need 4J channels, got {C}")
    return B, C, J, S


def decode_cuda(offset, depth_s, kernel_size, scale):
    """offset (B, 4J, S, S) + depth_s (B, 1, S, S) at the feature size ->
    joints (B, J, 3): softmax(scale * heat * mask)-weighted votes."""
    B, C, J, S = _decode_shapes(offset)
    _check("offset", offset, (B, C, S, S))
    _check("depth_s", depth_s, (B, 1, S, S))
    _same_device(offset, depth_s)
    out = torch.empty((B, J, 3), dtype=torch.float32, device=offset.device)
    _launch("dsf_codec_decode", (offset, depth_s, out), B, J, S,
            (kernel_size, scale))
    LAUNCHES["codec_decode"] += 1
    return out


def decode_bwd_cuda(offset, depth_s, g, kernel_size, scale):
    """VJP of ``decode_cuda`` for the cotangent g (B, J, 3) ->
    (d offset (B, 4J, S, S), d depth_s (B, 1, S, S)).  The mask comparison
    is not differentiated, as in the JAX package."""
    B, C, J, S = _decode_shapes(offset)
    _check("offset", offset, (B, C, S, S))
    _check("depth_s", depth_s, (B, 1, S, S))
    _check("g", g, (B, J, 3))
    _same_device(offset, depth_s, g)
    dx = torch.empty_like(offset)
    dd = torch.empty_like(depth_s)
    stats = torch.empty((B, J, 2), dtype=torch.float32, device=offset.device)
    _launch("dsf_codec_decode_bwd", (offset, depth_s, g, dx, dd, stats), B, J,
            S, (kernel_size, scale))
    LAUNCHES["codec_decode_bwd"] += 1
    return dx, dd


class EncodeFn(torch.autograd.Function):
    """K5: forward ``encode_cuda``, backward ``encode_bwd_cuda``."""

    @staticmethod
    def forward(ctx, joint, img_s, kernel_size):
        ctx.save_for_backward(joint, img_s)
        ctx.kernel_size = kernel_size
        return encode_cuda(joint, img_s, kernel_size)

    @staticmethod
    def backward(ctx, g):
        joint, img_s = ctx.saved_tensors
        dj, dd = encode_bwd_cuda(joint, img_s, g.contiguous(),
                                 ctx.kernel_size)
        return dj, dd, None


class DecodeFn(torch.autograd.Function):
    """K4: forward ``decode_cuda``, backward ``decode_bwd_cuda``."""

    @staticmethod
    def forward(ctx, offset, depth_s, kernel_size, scale):
        ctx.save_for_backward(offset, depth_s)
        ctx.kernel_size, ctx.scale = kernel_size, scale
        return decode_cuda(offset, depth_s, kernel_size, scale)

    @staticmethod
    def backward(ctx, g):
        offset, depth_s = ctx.saved_tensors
        dx, dd = decode_bwd_cuda(offset, depth_s, g.contiguous(),
                                 ctx.kernel_size, ctx.scale)
        return dx, dd, None, None
