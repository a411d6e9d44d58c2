"""The raster kernels, each launching or raising (there is no fallback):

- K1, the skip raster (csrc/raster_skip.cu), replacing the Pallas
  ``dsf_tpu/ops/pallas_raster.py:raster_pallas_skip``: ``raster_skip_cuda``
  takes the tables that ``rasterize.skip_tables`` builds in PyTorch
  (per-face rows and per-chunk bboxes) and the sample positions;
- K6, the dense raster (csrc/raster_dense.cu), replacing
  ``raster_pallas``: ``raster_dense_cuda`` takes the face rows alone;
- K10, the binned raster (csrc/raster_binned.cu), replacing
  ``raster_pallas_tiles``: ``raster_binned_cuda`` takes the face rows and
  the per-tile face lists of ``rasterize.binned_tables``.

Each returns (zbuf, idx) bitwise-equal to its plain version on the same
inputs: ``rasterize.raster_scan`` (K1, K6), ``rasterize.raster_binned_plain``
(K10).
"""

from __future__ import annotations

import torch

from dsf_tpu_torch.kernels import LAUNCHES, build

CHUNK = 64          # faces per shared-memory chunk (csrc kChunk)
TILE = 16           # 16 x 16 pixel tile per block (csrc kTile)


def raster_skip_cuda(rows, cbox, pix_uv, layout_hw):
    """rows (B, F, 16) f32, cbox (B, ceil(F/64), 4) f32, pix_uv (B, H*W, 2)
    f32 row-major over ``layout_hw`` = (H, W), all contiguous on one GPU
    -> zbuf (B, H*W) f32 (0 = background), idx (B, H*W) int32 (-1)."""
    H, W = layout_hw
    B, F = rows.shape[0], rows.shape[1]
    nc = -(-F // CHUNK)
    # the kernel reads rows and cbox as float4 and pix_uv as float2
    build.check_tensors((("rows", rows, (B, F, 16), torch.float32, 16),
                         ("cbox", cbox, (B, nc, 4), torch.float32, 16),
                         ("pix_uv", pix_uv, (B, H * W, 2), torch.float32, 8)))
    zbuf = torch.empty((B, H * W), dtype=torch.float32, device=rows.device)
    idx = torch.empty((B, H * W), dtype=torch.int32, device=rows.device)
    fn = build.function("raster_skip", "dsf_raster_skip", 5, 4)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), cbox.data_ptr(), pix_uv.data_ptr(),
                 zbuf.data_ptr(), idx.data_ptr(), B, F, H, W, stream)
    build.check(err, "raster_skip")
    LAUNCHES["raster_skip"] += 1
    return zbuf, idx


def raster_dense_cuda(rows, pix_uv):
    """K6: rows (B, F, 16) f32 (``rasterize.face_rows``) and pix_uv (B, P,
    2) f32, contiguous on one GPU -> zbuf (B, P) f32 (0 = background), idx
    (B, P) int32 (-1): every face against every sample."""
    B, F = rows.shape[0], rows.shape[1]
    P = pix_uv.shape[1]
    build.check_tensors((("rows", rows, (B, F, 16), torch.float32, 16),
                         ("pix_uv", pix_uv, (B, P, 2), torch.float32, 8)))
    if B == 0 or F == 0 or P == 0:
        raise ValueError(f"empty raster: B={B}, F={F}, P={P}")
    zbuf = torch.empty((B, P), dtype=torch.float32, device=rows.device)
    idx = torch.empty((B, P), dtype=torch.int32, device=rows.device)
    fn = build.function("raster_dense", "dsf_raster_dense", 4, 3)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), pix_uv.data_ptr(), zbuf.data_ptr(),
                 idx.data_ptr(), B, F, P, stream)
    build.check(err, "raster_dense")
    LAUNCHES["raster_dense"] += 1
    return zbuf, idx


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
