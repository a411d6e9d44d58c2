"""K9 — the CycleGAN generator's tail convolution + tanh
(csrc/tail_conv.cu), replacing the Pallas
``dsf_tpu/ops/pallas_tapsum.py:tail_conv_tanh`` (its TPU path
``_fast_tail``).

``tail_conv_cuda`` launches the kernel or raises.  ``TailConvFn`` is the
``torch.autograd.Function`` the GPU path goes through: its forward is the
kernel, and its backward recomputes through autograd of the plain version,
as the JAX package's ``_tail_bwd`` does (it has no backward kernel).  The
dispatch that takes the plain version for CPU tensors is in ``tapsum``.
"""

from __future__ import annotations

import ctypes

import torch

from dsf_tpu_torch.kernels import LAUNCHES, build

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("tail_conv").dsf_tail_conv_tanh
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def tail_conv_cuda(x, w, b):
    """The K9 kernel: x (B, C, H+6, W+6), w (1, C, 7, 7), b (1,) float32,
    contiguous on one GPU -> tanh(conv + b) (B, 1, H, W) float32."""
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{name}: need a float32 CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: need a contiguous tensor on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x: need (B, C, H+6, W+6), got {tuple(x.shape)}")
    B, C, Hp, Wp = x.shape
    if tuple(w.shape) != (1, C, 7, 7) or tuple(b.shape) != (1,):
        raise ValueError(f"need w (1, {C}, 7, 7) and b (1,), got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    H, W = Hp - 6, Wp - 6
    if B == 0 or C == 0 or H <= 0 or W <= 0:
        raise ValueError(f"empty tail conv: x {tuple(x.shape)}")
    out = torch.empty((B, 1, H, W), dtype=torch.float32, device=x.device)
    fn = _launcher()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 B, C, H, W, torch.cuda.current_stream().cuda_stream)
    build.check(err, "tail_conv")
    LAUNCHES["tail_conv"] += 1
    return out


class TailConvFn(torch.autograd.Function):
    """K9: forward ``tail_conv_cuda``; backward through autograd of the
    plain version (``_tail_bwd`` of the JAX package)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return tail_conv_cuda(x, w, b)

    @staticmethod
    def backward(ctx, g):
        from dsf_tpu_torch.ops.tapsum import tail_conv_tanh_plain
        xs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            return torch.autograd.grad(tail_conv_tanh_plain(*xs), xs, g)
