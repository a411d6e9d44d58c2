"""Normalize raw Kinect-v2 depth PNGs for display (counterpart of
dsf_tpu/tools/kinect_preview.py; ref: vis_kinect.py).

Reads a 16-bit (or 8-bit) grayscale depth PNG with
``data.readers.read_gray_png`` and writes the depth between ``lo`` and
``hi`` mm as an 8-bit grayscale PNG (``tools.prerender.write_png8``):
the pixels the JAX package's PIL round trip gives.

Usage: python -m dsf_tpu_torch.tools.kinect_preview in.png out.png
"""

from __future__ import annotations

import sys

import numpy as np

from dsf_tpu_torch.data.readers import read_gray_png
from dsf_tpu_torch.tools.prerender import write_png8


def normalize_kinect_png(in_path, out_path, lo=500, hi=1500):
    depth = read_gray_png(in_path)
    vis = np.clip((depth - lo) / (hi - lo), 0, 1)
    write_png8(out_path, (vis * 255).astype(np.uint8))
    return out_path


if __name__ == "__main__":
    normalize_kinect_png(sys.argv[1], sys.argv[2])
