"""The card's division by a Python number against the CPU's, on the CCSSL
warps' grid (``ops/image.affine_grid``).

CUDA takes ``x / c`` for a Python number ``c`` as ``x * fl(1 / c)``;
the CPU divides.  Where 1 / c is inexact (c not a power of two) the two
differ in the last bit of some elements, and a nearest sample that
follows moves.  For crops of 96^2 and 128^2 and five test-time thetas
(``tools.ccssl.ref_tta_draws``), this prints the nearest warp's pixels
that differ card against CPU (all, and those away from a tie), with the
grid divided by Python numbers (the old ``affine_grid``) and by device
tensors (``geometry.div``, the repair).  Needs one card; ~15 s.

    python3 scripts/divide_gpu.py
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dsf_tpu_torch.ops import image  # noqa: E402
from dsf_tpu_torch.tools.ccssl import _ref_theta, ref_tta_draws  # noqa: E402


def old_affine_grid(theta, H, W):
    """``affine_grid`` as it was: divided by Python ``H`` and ``W``."""
    dev, dt = theta.device, theta.dtype
    ys = (torch.arange(H, device=dev, dtype=dt) + 0.5) / H * 2.0 - 1.0
    xs = (torch.arange(W, device=dev, dtype=dt) + 0.5) / W * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    t = theta[:, :, None, None, :]
    return (t[..., 0] * gx + t[..., 1] * gy + t[..., 2]).permute(0, 2, 3, 1)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    gen = torch.Generator().manual_seed(7)
    img = torch.rand(4, 1, 128, 128, generator=gen) * 2 - 1
    s, rot = ref_tta_draws(torch.Generator().manual_seed(8), 4, 5)
    out = {}
    for size in (96, 128):
        x = img[..., :size, :size].contiguous()
        for name, grid_fn in (("python", old_affine_grid),
                              ("device", image.affine_grid)):
            differ = away = 0
            for i in range(5):
                theta, _ = _ref_theta(s[i], rot[i])
                warp = lambda im, th: image.grid_sample(
                    im, grid_fn(th, size, size), "nearest")
                a, c = warp(x.cuda(), theta.cuda()).cpu(), warp(x, theta)
                g = image.unnormalize(grid_fn(theta.double(), size, size),
                                      size)
                tie = ((g - torch.floor(g) - 0.5).abs() < 1e-4).any(-1)
                differ += int((a != c).sum())
                away += int(((a != c)[:, 0] & ~tie).sum())
            out[f"{size}^2, {name} divisor"] = [differ, away]
    print("nearest-warp pixels that differ card against CPU, [all, away "
          "from a tie (1e-4 px)] of 5 warps of 4 crops: " + json.dumps(out))
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
