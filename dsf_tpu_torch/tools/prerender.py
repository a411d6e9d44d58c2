"""Offline dataset pre-rendering: full-frame synth depth for whole
datasets (counterpart of dsf_tpu/tools/prerender.py; ref: render_msra /
render_nyu, render_loader.py:3205-3255).

Per-frame MANO parameters are rendered in batches into full-frame depth
images (mm) and written as 16-bit grayscale PNGs, the ``synthdepth_*`` /
``render/`` inputs the loaders read.  The raster takes the dense route
(no pixel layout): K6 on a card, once per batch.

The PNGs are written with the standard library (``zlib``, ``struct``):
16-bit big-endian grayscale (``write_png16``; ``write_png8`` writes 8-bit
ones, for ``tools/kinect_preview``), the pixels ``cv2.imwrite`` stores for a
``uint16`` array, so the files read back the same with OpenCV or PIL.
``read_png16`` reads such a file back without either, whatever its row
filters (``readers.read_gray_png``).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from dsf_tpu_torch.config import CAMERA
from dsf_tpu_torch.data.readers import PNG_SIGNATURE, png_chunk, read_gray_png
from dsf_tpu_torch.device import exact_float32, resolve_device
from dsf_tpu_torch.mano import model as mano_model
from dsf_tpu_torch.ops import rasterize as ras


def _write_gray_png(path: str, img: np.ndarray, dtype) -> None:
    """Write a (H, W) array of ``dtype`` (uint8 or uint16) as a grayscale
    PNG of its bits (every row with filter 0, samples big-endian)."""
    if img.dtype != dtype or img.ndim != 2:
        raise ValueError(f"need a (H, W) {np.dtype(dtype)} array, got "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape
    nb = img.dtype.itemsize
    rows = np.zeros((H, 1 + nb * W), np.uint8)
    rows[:, 1:] = img.astype(img.dtype.newbyteorder(">")).view(
        np.uint8).reshape(H, nb * W)
    ihdr = struct.pack(">IIBBBBB", W, H, 8 * nb, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + png_chunk(b"IHDR", ihdr)
                + png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + png_chunk(b"IEND", b""))


def write_png16(path: str, img: np.ndarray) -> None:
    """Write a (H, W) uint16 array as a 16-bit grayscale PNG (every row
    with filter 0)."""
    _write_gray_png(path, img, np.uint16)


def write_png8(path: str, img: np.ndarray) -> None:
    """Write a (H, W) uint8 array as an 8-bit grayscale PNG (every row
    with filter 0)."""
    _write_gray_png(path, img, np.uint8)


def read_png16(path: str) -> np.ndarray:
    """Read back a 16-bit grayscale PNG -> (H, W) uint16."""
    return read_gray_png(path, bits=(16,)).astype(np.uint16)


def prerender_dataset(mano_npz, params_62d, out_dir, dataset="nyu",
                      batch_size=32, scale=1.0, prefix="render",
                      device=None):
    """params_62d: (N, 62) parameter bank -> N 16-bit PNGs of the rendered
    full-frame depth (mm, times ``scale``), ``{prefix}_{i:07d}.png`` from
    1, in ``out_dir``.  Runs on ``cuda`` unless ``device`` says otherwise.
    Returns N."""
    dev = resolve_device(device)
    paras, (W, H) = CAMERA[dataset]
    m = mano_model.load_model(mano_npz, device=dev)
    rays = ras.full_frame_pixel_rays((W, H), device=dev)
    os.makedirs(out_dir, exist_ok=True)
    N = len(params_62d)
    with torch.no_grad(), exact_float32():
        for s in range(0, N, batch_size):
            params = torch.from_numpy(
                np.asarray(params_62d[s:s + batch_size], np.float32)).to(dev)
            verts, _ = mano_model.get_mano_vertices(
                m, *mano_model.split_params(params))
            depth = ras.rasterize_depth(verts, m.faces, rays, paras)
            depth = depth.reshape(-1, H, W).cpu().numpy()
            for i, img in enumerate(depth):
                write_png16(os.path.join(out_dir, f"{prefix}_{s + i + 1:07d}.png"),
                            (img * scale).astype(np.uint16))
    return N
