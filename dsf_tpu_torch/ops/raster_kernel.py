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
  ``raster_pallas_tiles``: ``raster_binned_cuda`` takes the face rows and
  the per-tile face lists of ``rasterize.binned_tables``.

Each returns (zbuf, idx) bitwise-equal to its plain version on the same
inputs: ``rasterize.raster_scan`` (K1, K6), ``rasterize.raster_binned_plain``
(K10).  The set-up's outputs are ``rasterize.skip_tables``'s, the rows
bitwise.  K1's and K6's counts go up by one per route call, in the raster's
launch.
"""

from __future__ import annotations

import torch

from dsf_tpu_torch.kernels import LAUNCHES, build

CHUNK = 256         # faces a chunk box covers (csrc kCull)
SKIP_TILE = (16, 4)  # K1's pixel tile per block, rows x columns
                     # (csrc raster_skip.cu kTileY, kTileX)
DENSE_BLOCK = 128   # K6's consecutive samples per block (csrc raster_dense.cu
                    # kThreads x kSamples)
TILE = 16           # 16 x 16 pixel tile per block of K10 (csrc kTile)


def face_setup_cuda(proj, faces, lib="raster_skip"):
    """The set-up kernel: proj (B, V, 3) f32 and faces (F, 3) int32,
    contiguous on one GPU -> rows (B, F, 16) (bitwise
    ``rasterize.face_rows``), boxes (B, F, 4) = [umin umax vmin vmax] of
    each face (+inf, -inf for an invalid one) and cbox (B, ceil(F / 256), 4),
    the union of each chunk's face boxes.  ``lib`` names the raster library
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
    with torch.cuda.device(dev):
        err = fn(proj.data_ptr(), faces.data_ptr(), rows.data_ptr(),
                 boxes.data_ptr(), cbox.data_ptr(), B, V, F,
                 torch.cuda.current_stream().cuda_stream)
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
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
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
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
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


def raster_binned_cuda(rows, pix_uv, lists, counts, overflow, tile_hw):
    """K10: rows (B, F, 16) f32, pix_uv (B, H*W, 2) f32 row-major over
    tile_hw = (H, W) (multiples of 16), and ``rasterize.binned_tables``'s
    lists (B, G, cap) int32, counts (B, G) int32 and overflow (1,) int32,
    contiguous on one GPU -> zbuf (B, H*W) f32, idx (B, H*W) int32.  Each
    16x16 tile scans its own list, or every face when overflow is set."""
    H, W = tile_hw
    B, F = rows.shape[0], rows.shape[1]
    if H % TILE or W % TILE or H == 0 or W == 0:
        raise ValueError(f"K10 needs a layout of 16x16 tiles, got {H}x{W}")
    G = (H // TILE) * (W // TILE)
    cap = lists.shape[-1]
    build.check_tensors((("rows", rows, (B, F, 16), torch.float32, 16),
                         ("pix_uv", pix_uv, (B, H * W, 2), torch.float32, 8),
                         ("lists", lists, (B, G, cap), torch.int32, 4),
                         ("counts", counts, (B, G), torch.int32, 4),
                         ("overflow", overflow, (1,), torch.int32, 4)))
    zbuf = torch.empty((B, H * W), dtype=torch.float32, device=rows.device)
    idx = torch.empty((B, H * W), dtype=torch.int32, device=rows.device)
    fn = build.function("raster_binned", "dsf_raster_binned", 7, 5)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), pix_uv.data_ptr(), lists.data_ptr(),
                 counts.data_ptr(), overflow.data_ptr(), zbuf.data_ptr(),
                 idx.data_ptr(), B, F, H, W, cap, stream)
    build.check(err, "raster_binned")
    LAUNCHES["raster_binned"] += 1
    return zbuf, idx
