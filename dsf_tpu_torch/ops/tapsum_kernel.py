"""K9 — the CycleGAN generator's tail convolution + tanh
(csrc/tail_conv.cu), replacing the Pallas
``dsf_tpu/ops/pallas_tapsum.py:tail_conv_tanh`` (its TPU path
``_fast_tail``).

``tail_conv_cuda`` launches the kernel or raises: float32 inputs take the
float32 kernel (``LAUNCHES["tail_conv"]``), bfloat16 inputs its bfloat16
variant (``LAUNCHES["tail_conv_bf16"]``: float32 sums rounded to bfloat16,
the bias added in bfloat16, a bfloat16 output).  ``TailConvFn`` is the
``torch.autograd.Function`` the GPU path goes through: its forward is the
kernel, and its backward recomputes through autograd of the plain version
in the inputs' type, as the JAX package's ``_tail_bwd`` does with its
``dtype`` (it has no backward kernel).  The
dispatch that takes the plain version for CPU tensors is in ``tapsum``.
"""

from __future__ import annotations

import torch

from dsf_tpu_torch.kernels import LAUNCHES, build

# the exported function and the launch count of each input type
VARIANTS = {torch.float32: ("dsf_tail_conv_tanh", "tail_conv"),
            torch.bfloat16: ("dsf_tail_conv_tanh_bf16", "tail_conv_bf16")}


def tail_conv_cuda(x, w, b):
    """The K9 kernel: x (B, C, H+6, W+6), w (1, C, 7, 7), b (1,), all
    float32 or all bfloat16, contiguous on one GPU -> tanh(conv + b)
    (B, 1, H, W) in their type."""
    if x.dtype not in VARIANTS:
        raise ValueError(f"x: need a float32 or bfloat16 CUDA tensor, got "
                         f"{x.dtype}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device.type != "cuda" or t.dtype != x.dtype:
            raise ValueError(f"{name}: need a {x.dtype} CUDA tensor (x's "
                             f"type), got {t.dtype} on {t.device}")
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
    symbol, count = VARIANTS[x.dtype]
    out = torch.empty((B, 1, H, W), dtype=x.dtype, device=x.device)
    fn = build.function("tail_conv", symbol, 4, 4)
    with build.on_device(x, w, b, out) as stream:
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 B, C, H, W, stream)
    build.check(err, count)
    LAUNCHES[count] += 1
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
