"""The CycleGAN generator's tail: tanh(7x7 convolution C -> 1 + bias)
(counterpart of dsf_tpu/ops/pallas_tapsum.py:tail_conv_tanh, K9).

NCHW, the layout of the port's generator: x (B, C, H+6, W+6) already
reflect-padded, w (1, C, 7, 7), b (1,) -> (B, 1, H, W), VALID padding.

``tail_conv_tanh_plain`` is the plain version, the exact semantics of the
JAX package's ``_reference_tail`` (:57-65).  ``tail_conv_tanh`` takes it
for CPU tensors and, for GPU tensors, ``tapsum_kernel.TailConvFn``, whose
forward is the CUDA kernel (csrc/tail_conv.cu).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dsf_tpu_torch.ops import tapsum_kernel


def tail_conv_tanh_plain(x, w, b):
    """tanh(conv2d(x, w) + b), VALID: x (B, C, Hp, Wp), w (1, C, K, K),
    b (1,) -> (B, 1, Hp-K+1, Wp-K+1)."""
    return torch.tanh(F.conv2d(x, w) + b.reshape(1, -1, 1, 1))


def tail_conv_tanh(x, w, b):
    """The generator's head on padded x: the plain version on the CPU, K9
    on a GPU."""
    if x.device.type == "cpu":
        return tail_conv_tanh_plain(x, w, b)
    if x.device.type == "cuda":
        return tapsum_kernel.TailConvFn.apply(x.contiguous(), w.contiguous(),
                                              b.contiguous())
    raise ValueError(f"no tail-conv path for device {x.device}")
