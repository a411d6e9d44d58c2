"""Depth-file readers and the NYU PNG writer (counterpart of
dsf_tpu/data/readers.py; ref: render_loader.py:201-273), without OpenCV.

NYU stores depth as an 8-bit colour PNG with depth = G * 256 + B
(``cv2.imread`` returns it as BGR: ``[:, :, 0] + [:, :, 1] * 256``).  The
reader inflates the IDAT stream with ``zlib`` and undoes the row filters
in the host library (``native.png_nyu_depth``): files written by libpng,
as ``cv2.imwrite`` writes them, use all five filter types.
``write_nyu_png`` writes such a file (every row with filter 0).
ICVL, MSRA and SHREC readers are not ported yet (ROADMAP Queue 1).
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
