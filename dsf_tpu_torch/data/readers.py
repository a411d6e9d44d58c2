"""Depth-file readers and the NYU PNG writer (counterpart of
dsf_tpu/data/readers.py; ref: render_loader.py:201-273), without OpenCV.

NYU stores depth as an 8-bit colour PNG with depth = G * 256 + B
(``cv2.imread`` returns it as BGR: ``[:, :, 0] + [:, :, 1] * 256``).  The
reader inflates the IDAT stream with ``zlib`` and undoes the row filters
in the host library (``native.png_nyu_depth``): files written by libpng,
as ``cv2.imwrite`` writes them, use all five filter types.
``write_nyu_png`` writes such a file (every row with filter 0).

ICVL, SHREC and DHG store depth as a single-band PNG, which the JAX
package reads with PIL (``np.asarray(Image.open(p), np.float32)`` after
``assert len(img.getbands()) == 1``): ``read_gray_png`` reads 8- and
16-bit grayscale the same way through the host library
(``native.png_gray``), and raises on any other PNG (colour, palette, 1-,
2- or 4-bit gray, interlaced).  MSRA's ``.bin`` frames are read with
numpy (``msra_reader``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from dsf_tpu_torch.data import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}        # PNG colour type -> 8-bit channels


def png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def read_png_chunks(path: str):
    """(IHDR fields (W, H, depth, colour, compression, filter, interlace),
    the concatenated IDAT bytes) of a PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = len(PNG_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    return hdr, b"".join(idat)


def nyu_reader(img_path: str) -> np.ndarray:
    """NYU packed PNG -> (H, W) float32 depth G * 256 + B (ref:
    nyu_reader, render_loader.py:208-211)."""
    (W, H, depth, colour, _, _, interlace), idat = read_png_chunks(img_path)
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"{img_path}: need an 8-bit RGB or RGBA PNG without "
                         f"interlace, got depth {depth} colour type {colour} "
                         f"interlace {interlace}")
    C = _CHANNELS[colour]
    # the inflated size as the buffer: one allocation, no regrowth
    return native.png_nyu_depth(zlib.decompress(idat, bufsize=H * (1 + W * C)),
                                H, W, C)


def read_gray_png(img_path: str, bits=(8, 16)) -> np.ndarray:
    """A single-band PNG of one of ``bits`` (8 or 16) bits a sample ->
    (H, W) float32 samples (16-bit samples big-endian in the file)."""
    (W, H, depth, colour, _, _, interlace), idat = read_png_chunks(img_path)
    if colour != 0 or depth not in bits or interlace:
        raise ValueError(f"{img_path}: need an 8- or 16-bit grayscale PNG "
                         f"without interlace, got depth {depth} colour type "
                         f"{colour} interlace {interlace}")
    nb = depth // 8
    return native.png_gray(zlib.decompress(idat, bufsize=H * (1 + W * nb)),
                           H, W, nb)


def icvl_reader(img_path: str) -> np.ndarray:
    """ICVL's depth PNG -> (H, W) float32 mm (ref: icvl_reader)."""
    return read_gray_png(img_path)


def shrec_reader(img_path: str) -> np.ndarray:
    """SHREC's and DHG's depth PNG -> (H, W) float32 mm (ref:
    shrec_reader)."""
    return read_gray_png(img_path)


def msra_reader(image_name: str, paras):
    """MSRA binary: a uint32 header (w, h, left, top, right, bottom), then
    the float32 depth patch from byte 24 (ref: msra_reader,
    render_loader.py:221-241).  Returns (the (h, w) float32 depth image,
    the patch's non-zero points in world mm, (N, 3) float64, with the
    module's y flip)."""
    with open(image_name, "rb") as f:
        data = np.fromfile(f, dtype=np.uint32, count=6)
        width, height, left, top, right, bottom = data
        f.seek(4 * 6)
        patch = np.fromfile(f, dtype=np.float32)
    depth = np.zeros((height, width), dtype=np.float32)
    patch = patch.reshape(bottom - top, right - left)
    depth[top:bottom, left:right] = patch

    fx, fy, fu, fv = paras
    h, w = patch.shape
    us = (np.tile(np.arange(w), (h, 1)).astype(np.float64) + left).ravel()
    vs = (np.repeat(np.arange(h), w).astype(np.float64) + top).ravel()
    z = patch.ravel()
    # pixel2world with the module-level y flip (ref render_loader.py:70-74)
    x = (us - fu) * z / fx
    y = (fv - vs) * z / fy
    pts = np.stack([x, y, z], axis=0)
    valid = (pts != 0).any(axis=0)
    return depth, pts[:, valid].T


def write_msra_bin(path: str, depth: np.ndarray) -> None:
    """Write a (H, W) depth image as an MSRA ``.bin``: the header, then
    the float32 patch of the non-zero pixels' bounding box (an empty box
    at (0, 0) when every pixel is zero)."""
    depth = np.asarray(depth, np.float32)
    if depth.ndim != 2:
        raise ValueError(f"need a (H, W) depth image, got {depth.shape}")
    H, W = depth.shape
    rows, cols = np.nonzero(depth.any(1))[0], np.nonzero(depth.any(0))[0]
    top, bottom = (rows[0], rows[-1] + 1) if len(rows) else (0, 0)
    left, right = (cols[0], cols[-1] + 1) if len(cols) else (0, 0)
    with open(path, "wb") as f:
        np.asarray([W, H, left, top, right, bottom], np.uint32).tofile(f)
        np.ascontiguousarray(depth[top:bottom, left:right]).tofile(f)


def write_nyu_png(path: str, depth: np.ndarray) -> None:
    """Write (H, W) depth in mm (integers 0-65535) as NYU's packed PNG:
    RGB with R = 0, G = the high byte, B = the low byte."""
    d16 = np.asarray(depth).astype(np.uint16)
    if d16.ndim != 2:
        raise ValueError(f"need a (H, W) depth image, got {d16.shape}")
    H, W = d16.shape
    rows = np.zeros((H, 1 + 3 * W), np.uint8)
    rgb = rows[:, 1:].reshape(H, W, 3)
    rgb[:, :, 1] = d16 >> 8
    rgb[:, :, 2] = d16 & 0xFF
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + png_chunk(b"IHDR", ihdr)
                + png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + png_chunk(b"IEND", b""))
