"""The raster kernels, each launching or raising (there is no fallback):

- K1, the skip raster (csrc/raster_skip.cu), replacing the Pallas
  ``dsf_tpu/ops/pallas_raster.py:raster_pallas_skip``: ``raster_skip_cuda``
  takes the projected vertices and the faces, builds the face rows, face
  boxes and chunk boxes with the set-up kernel (``face_setup_cuda``,
  csrc/raster_setup.cuh) and launches the raster on them
  (``raster_skip_launch``);
- K6, the dense raster (csrc/raster_dense.cu), replacing
  ``raster_pallas``: ``raster_dense_cuda``, the same two launches with no
  pixel layout (``raster_dense_launch``);
- K10, the binned raster (csrc/raster_binned.cu), replacing
  ``raster_pallas_tiles``: ``raster_binned_cuda``, the same face set-up
  plus each 16x16 tile's sample box and face count and the overflow flag
  (``binned_setup_cuda``), then the raster (``raster_binned_launch``).

Each returns (zbuf, idx) bitwise-equal to its plain version on the same
inputs: ``rasterize.raster_scan`` (K1, K6), ``rasterize.raster_binned_plain``
over ``rasterize.binned_tables`` (K10).  The set-up's outputs are
``rasterize.skip_tables``'s, the rows bitwise, and K10's
``rasterize.binned_setup_plain``'s.  Each count goes up by one per route
call, in the raster's launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsf_tpu_torch.kernels import LAUNCHES, build

CHUNK = 256         # faces a chunk box covers (csrc kCull)
SKIP_TILE = (16, 4)  # K1's pixel tile per block, rows x columns
                     # (csrc raster_skip.cu kTileY, kTileX)
DENSE_BLOCK = 128   # K6's consecutive samples per block (csrc raster_dense.cu
                    # kThreads x kSamples)
BIN_TILE = 16       # K10's tiles of 16 x 16 pixels (csrc kBin)
BIN_CAP = 512       # K10's faces per tile (rasterize.BIN_CAP)
BINNED_BLOCK = (16, 4)  # K10's pixel block inside a tile, rows x columns
                        # (csrc raster_binned.cu kTileY, kTileX)


class BinnedTables(NamedTuple):
    """K10's set-up (``binned_setup_cuda``; plain version
    ``rasterize.binned_setup_plain``): ``face_setup_cuda``'s rows, boxes
    (the cover boxes) and cbox; vbox (B, F, 4) = [umin umax vmin vmax] of
    each face's screen box (+inf, -inf for an invalid face); tbox (B, G, 4)
    the same of each 16x16 tile's samples (G tiles in row-major order);
    counts (B, G) int32, the faces whose screen box meets the tile's
    (inclusive, no margin); overflow (1,) int32, 1 when a count exceeds
    ``BIN_CAP``."""
    rows: torch.Tensor
    boxes: torch.Tensor
    cbox: torch.Tensor
    vbox: torch.Tensor
    tbox: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


def face_setup_cuda(proj, faces, lib="raster_skip"):
    """The set-up kernel: proj (B, V, 3) f32 and faces (F, 3) int32,
    contiguous on one GPU -> rows (B, F, 16) (bitwise
    ``rasterize.face_rows``), boxes (B, F, 4) = [umin umax vmin vmax], each
    face's cover box (``rasterize.cover_boxes``; +inf, -inf for an invalid
    one) and cbox (B, ceil(F / 256), 4), the union of each chunk's face
    boxes.  ``lib`` names the raster library
    whose copy of it runs (each carries one, so that a route loads one
    library)."""
    B, V = proj.shape[0], proj.shape[1]
    F = faces.shape[0]
    build.check_tensors((("proj", proj, (B, V, 3), torch.float32, 4),
                         ("faces", faces, (F, 3), torch.int32, 4)))
    if B == 0 or F == 0:
        raise ValueError(f"empty raster set-up: B={B}, F={F}")
    dev = proj.device
    rows = torch.empty((B, F, 16), dtype=torch.float32, device=dev)
    boxes = torch.empty((B, F, 4), dtype=torch.float32, device=dev)
    cbox = torch.empty((B, -(-F // CHUNK), 4), dtype=torch.float32,
                       device=dev)
    fn = build.function(lib, f"dsf_{lib}_setup", 5, 3)
    with build.on_device(proj, faces, rows) as stream:
        err = fn(proj.data_ptr(), faces.data_ptr(), rows.data_ptr(),
                 boxes.data_ptr(), cbox.data_ptr(), B, V, F, stream)
    build.check(err, f"{lib} set-up")
    return rows, boxes, cbox


def _tables(rows, boxes, cbox):
    """The check of the set-up's outputs, (B, F) from rows; read as float4."""
    B, F = rows.shape[0], rows.shape[1]
    return (("rows", rows, (B, F, 16), torch.float32, 16),
            ("boxes", boxes, (B, F, 4), torch.float32, 16),
            ("cbox", cbox, (B, -(-F // CHUNK), 4), torch.float32, 16))


def raster_skip_launch(rows, boxes, cbox, pix_uv, layout_hw):
    """The K1 raster on the set-up's rows, boxes and cbox (see
    ``face_setup_cuda``) and pix_uv (B, H*W, 2) f32 row-major over
    ``layout_hw`` = (H, W), contiguous on one GPU -> zbuf (B, H*W) f32 (0 =
    background), idx (B, H*W) int32 (-1)."""
    H, W = layout_hw
    B, F = rows.shape[0], rows.shape[1]
    build.check_tensors(_tables(rows, boxes, cbox)
                        + (("pix_uv", pix_uv, (B, H * W, 2), torch.float32,
                            8),))
    if B == 0 or F == 0 or H * W == 0:
        raise ValueError(f"empty raster: B={B}, F={F}, {H}x{W}")
    zbuf = torch.empty((B, H * W), dtype=torch.float32, device=rows.device)
    idx = torch.empty((B, H * W), dtype=torch.int32, device=rows.device)
    fn = build.function("raster_skip", "dsf_raster_skip", 6, 4)
    with build.on_device(rows, boxes, cbox, pix_uv) as stream:
        err = fn(rows.data_ptr(), boxes.data_ptr(), cbox.data_ptr(),
                 pix_uv.data_ptr(), zbuf.data_ptr(), idx.data_ptr(), B, F, H,
                 W, stream)
    build.check(err, "raster_skip")
    LAUNCHES["raster_skip"] += 1
    return zbuf, idx


def raster_skip_cuda(proj, faces, pix_uv, layout_hw):
    """K1: proj (B, V, 3) f32, faces (F, 3) int32 and pix_uv (B, H*W, 2)
    f32 row-major over ``layout_hw`` = (H, W), contiguous on one GPU ->
    (zbuf, idx): the set-up, then the raster."""
    tables = face_setup_cuda(proj, faces, "raster_skip")
    return raster_skip_launch(*tables, pix_uv, layout_hw)


def raster_dense_launch(rows, boxes, cbox, pix_uv):
    """The K6 raster on the set-up's rows, boxes and cbox and pix_uv (B, P,
    2) f32 in any order, contiguous on one GPU -> zbuf (B, P) f32 (0 =
    background), idx (B, P) int32 (-1)."""
    B, F = rows.shape[0], rows.shape[1]
    P = pix_uv.shape[1]
    build.check_tensors(_tables(rows, boxes, cbox)
                        + (("pix_uv", pix_uv, (B, P, 2), torch.float32, 8),))
    if B == 0 or F == 0 or P == 0:
        raise ValueError(f"empty raster: B={B}, F={F}, P={P}")
    zbuf = torch.empty((B, P), dtype=torch.float32, device=rows.device)
    idx = torch.empty((B, P), dtype=torch.int32, device=rows.device)
    fn = build.function("raster_dense", "dsf_raster_dense", 6, 3)
    with build.on_device(rows, boxes, cbox, pix_uv) as stream:
        err = fn(rows.data_ptr(), boxes.data_ptr(), cbox.data_ptr(),
                 pix_uv.data_ptr(), zbuf.data_ptr(), idx.data_ptr(), B, F, P,
                 stream)
    build.check(err, "raster_dense")
    LAUNCHES["raster_dense"] += 1
    return zbuf, idx


def raster_dense_cuda(proj, faces, pix_uv):
    """K6: proj (B, V, 3) f32, faces (F, 3) int32 and pix_uv (B, P, 2) f32,
    contiguous on one GPU -> (zbuf, idx): the set-up, then the raster."""
    tables = face_setup_cuda(proj, faces, "raster_dense")
    return raster_dense_launch(*tables, pix_uv)


def _bin_layout(tile_hw):
    H, W = tile_hw
    if H % BIN_TILE or W % BIN_TILE or H == 0 or W == 0:
        raise ValueError(f"K10 needs a layout of 16x16 tiles, got {H}x{W}")
    return H, W, (H // BIN_TILE) * (W // BIN_TILE)


def _sample_strides(pix_uv, B, P):
    """pix_uv (B, P, 2) f32 on a GPU, read through its strides (the crop
    rays are a slice of (B, P, 3) rows, a shared grid is expanded): ->
    (batch stride, sample stride) in floats."""
    if pix_uv.device.type != "cuda" or pix_uv.dtype != torch.float32:
        raise ValueError(f"pix_uv: need a torch.float32 CUDA tensor, got "
                         f"{pix_uv.dtype} on {pix_uv.device}")
    if tuple(pix_uv.shape) != (B, P, 2) or pix_uv.stride(2) != 1 \
            or min(pix_uv.stride()) < 0:
        raise ValueError(f"pix_uv: need ({B}, {P}, 2) with (u, v) adjacent, "
                         f"got {tuple(pix_uv.shape)} strides "
                         f"{pix_uv.stride()}")
    return pix_uv.stride(0), pix_uv.stride(1)


def binned_setup_cuda(proj, faces, pix_uv, tile_hw):
    """K10's set-up, two launches: proj (B, V, 3) f32 and faces (F, 3)
    int32 or int64, contiguous on one GPU, and pix_uv (B, H*W, 2) f32
    row-major over tile_hw = (H, W) (multiples of 16; any strides with u,
    v adjacent) -> ``BinnedTables``.  Counts no launch: the raster does."""
    B, V = proj.shape[0], proj.shape[1]
    F = faces.shape[0]
    H, W, G = _bin_layout(tile_hw)
    if faces.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"faces: need int32 or int64, got {faces.dtype}")
    build.check_tensors((("proj", proj, (B, V, 3), torch.float32, 4),
                         ("faces", faces, (F, 3), faces.dtype, 4)))
    sb, sp = _sample_strides(pix_uv, B, H * W)
    if B == 0 or F == 0:
        raise ValueError(f"empty raster set-up: B={B}, F={F}")
    dev = proj.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = BinnedTables(
        torch.empty((B, F, 16), **f32), torch.empty((B, F, 4), **f32),
        torch.empty((B, -(-F // CHUNK), 4), **f32),
        torch.empty((B, F, 4), **f32), torch.empty((B, G, 4), **f32),
        torch.empty((B, G), dtype=torch.int32, device=dev),
        torch.empty(1, dtype=torch.int32, device=dev))
    fn = build.function("raster_binned", "dsf_raster_binned_setup", 10, 9)
    with build.on_device(proj, faces, pix_uv) as stream:
        err = fn(proj.data_ptr(), faces.data_ptr(), pix_uv.data_ptr(),
                 *[t.data_ptr() for t in out],
                 int(faces.dtype == torch.int64), B, V, F, H, W, sb, sp,
                 BIN_CAP, stream)
    build.check(err, "raster_binned set-up")
    return out


def raster_binned_launch(rows, boxes, cbox, vbox, tbox, pix_uv, overflow,
                         tile_hw):
    """The K10 raster on ``binned_setup_cuda``'s rows, boxes, cbox, vbox and
    tbox, pix_uv (B, H*W, 2) f32 row-major over tile_hw (strided as the
    set-up takes it) and an overflow flag (1,) int32 (the set-up's, or one
    set to force every tile's dense answer) -> zbuf (B, H*W) f32 (0 =
    background), idx (B, H*W) int32 (-1)."""
    B, F = rows.shape[0], rows.shape[1]
    H, W, G = _bin_layout(tile_hw)
    build.check_tensors(_tables(rows, boxes, cbox)
                        + (("vbox", vbox, (B, F, 4), torch.float32, 16),
                           ("tbox", tbox, (B, G, 4), torch.float32, 16),
                           ("overflow", overflow, (1,), torch.int32, 4)))
    sb, sp = _sample_strides(pix_uv, B, H * W)
    if B == 0 or F == 0:
        raise ValueError(f"empty raster: B={B}, F={F}")
    zbuf = torch.empty((B, H * W), dtype=torch.float32, device=rows.device)
    idx = torch.empty((B, H * W), dtype=torch.int32, device=rows.device)
    fn = build.function("raster_binned", "dsf_raster_binned", 9, 6)
    with build.on_device(rows, boxes, cbox, vbox, tbox, pix_uv,
                         overflow) as stream:
        err = fn(rows.data_ptr(), boxes.data_ptr(), cbox.data_ptr(),
                 vbox.data_ptr(), tbox.data_ptr(), pix_uv.data_ptr(),
                 overflow.data_ptr(), zbuf.data_ptr(), idx.data_ptr(), B, F,
                 H, W, sb, sp, stream)
    build.check(err, "raster_binned")
    LAUNCHES["raster_binned"] += 1
    return zbuf, idx


def raster_binned_cuda(proj, faces, pix_uv, tile_hw):
    """K10: proj (B, V, 3) f32, faces (F, 3) int32 or int64 and pix_uv
    (B, H*W, 2) f32 row-major over tile_hw = (H, W) (multiples of 16) ->
    (zbuf, idx): the set-up, then the raster, three launches."""
    t = binned_setup_cuda(proj, faces, pix_uv, tile_hw)
    return raster_binned_launch(t.rows, t.boxes, t.cbox, t.vbox, t.tbox,
                                pix_uv, t.overflow, tile_hw)
