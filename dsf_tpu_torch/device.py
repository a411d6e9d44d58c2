"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller names another device.  A
missing card is an error, never a quiet move to the CPU: the CPU runs the
plain versions of the kernels, which is a different program.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for and absent,
    and for device types the port has no path for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg) -> torch.dtype:
    """The torch type of ``cfg.compute_dtype``: the type the pose net and
    the generator compute in (their parameters stay float32).  Raises for
    any other name than "float32" or "bfloat16"."""
    dt = COMPUTE_DTYPES.get(cfg.compute_dtype)
    if dt is None:
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r}: the port computes in "
            f"{' or '.join(COMPUTE_DTYPES)}")
    return dt


def widen(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32 if it is bfloat16, else ``t`` itself: where the JAX
    package casts a compute-dtype output to float32 (the losses, the
    renders, the codec), a float32 run gets no new op and a float64
    witness run keeps float64."""
    return t.float() if t.dtype == torch.bfloat16 else t


@contextlib.contextmanager
def exact_float32():
    """Run float32 matmuls and cuDNN convolutions in full float32 (no TF32),
    and sum bfloat16 matmuls in float32, for the duration, restoring the
    caller's settings after.  The stage-2 raster is discontinuous in the
    stage-1 parameters, so TF32's ~1e-3 relative rounding would move pixel
    coverage; a bfloat16 matmul rounds once, after a float32 sum, as on
    the CPU and in XLA (cuBLAS may otherwise reduce split sums in
    bfloat16)."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    bf16 = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            bf16)
