// K1 — skip-raster: nearest-face depth and face id per crop pixel.
//
// Replaces: dsf_tpu/ops/pallas_raster.py:raster_pallas_skip (body
// _kernel_skip_impl), dispatched from dsf_tpu/ops/rasterize.py:426-430.
//
// Function: rasterize.raster_scan's.  Per pixel, the least depth z > 0 of
// the valid faces whose three edge functions are >= 0 there, and the
// lowest face index at that depth; (0, -1) where no face covers it.
//
// What bounds it on this card: at the serving shape (B=32, 64x64 pixels,
// 1554 faces) the bytes (face rows, positions, outputs: ~4.6 MB) over the
// memory rate; the operations (~16 per pixel in a face's box, ~4e6) take
// less.  What the design has to keep small is everything else: (pixel,
// face) pairs that cannot hit, the face set-up (in PyTorch, ~25 launches
// taking longer than the raster), and the tiles where many faces pile
// up, which set the time of a grid that fills the card about once.
//
// Design (two launches):
//  * dsf_raster_skip_setup, raster_setup.cuh: one thread per (image,
//    face) builds the face rows bitwise as rasterize.face_rows does, each
//    face's cover box (its screen box widened to every pixel its rounded
//    edge test can pass), and each 256-face chunk's box;
//  * dsf_raster_skip: one block per (image, 4 x 16 pixel tile), one thread
//    per pixel, a ragged edge masked.  raster_rows.cuh:scan_culled bins the
//    faces inside the block: it reduces the tile's box, culls chunks and
//    then faces whose cover boxes miss it (they cover none of its pixels),
//    lists the rest in ascending face order (ballot, popc, a prefix over
//    the warps),
//    stages their rows in shared memory and walks them with a strict '<',
//    so zbuf and ids are bitwise raster_scan's.  The 4 x 16 tile (4
//    columns, 16 rows; rather than 16 x 16) quarters each block's box and
//    quadruples the blocks, so the tiles where the hand's faces pile up
//    spread over more SMs; of the shapes scripts/raster_shapes_gpu.py
//    times, it takes the least time summed over the 64x64 and 128x128
//    crops.  The TPU version's 31-chunk bitmask and 4e9
//    pixel padding were scalar-prefetch devices; the block finds its faces
//    itself.

#include <cuda_runtime.h>
#include <cstdint>

#include "raster_rows.cuh"
#include "raster_setup.cuh"

namespace {

// the tile: kTileX columns x kTileY rows of pixels, one thread each
constexpr int kTileX = 4;
constexpr int kTileY = 16;
using dsf_raster::kRow;

template <int TX, int TY>
__global__ void __launch_bounds__(TX * TY)
raster_skip_kernel(const float* __restrict__ rows,   // (B, F, 16)
                   const float* __restrict__ boxes,  // (B, F, 4)
                   const float* __restrict__ cbox,   // (B, nc, 4)
                   const float* __restrict__ pix,    // (B, H*W, 2)
                   float* __restrict__ zbuf,         // (B, H*W)
                   int32_t* __restrict__ idx,        // (B, H*W)
                   int F, int H, int W) {
  __shared__ dsf_raster::CullShared<TX * TY> s;
  const int b = blockIdx.z;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  const bool active[1] = {x < W && y < H};
  const long long at = b * ((long long)H * W) + (long long)y * W + x;
  const int nc = (F + dsf_raster::kCull - 1) / dsf_raster::kCull;

  float u[1] = {0.f}, v[1] = {0.f}, best[1] = {dsf_raster::kInf};
  int best_i[1] = {-1};
  if (active[0]) {
    const float2 uv = reinterpret_cast<const float2*>(pix)[at];
    u[0] = uv.x;
    v[0] = uv.y;
  }
  dsf_raster::scan_culled<TX * TY, 1>(
      rows + (size_t)b * F * kRow,
      reinterpret_cast<const float4*>(boxes) + (size_t)b * F,
      reinterpret_cast<const float4*>(cbox) + (size_t)b * nc, F, u, v,
      active, tid, s, best, best_i);
  if (active[0]) dsf_raster::store(best[0], best_i[0], zbuf, idx, at);
}

template <int TX, int TY>
int launch_raster_skip(const float* rows, const float* boxes,
                       const float* cbox, const float* pix, float* zbuf,
                       int32_t* idx, int B, int F, int H, int W,
                       void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  raster_skip_kernel<TX, TY>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          rows, boxes, cbox, pix, zbuf, idx, F, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsf_raster_skip_setup(const float* proj, const int32_t* faces,
                                     float* rows, float* boxes, float* cbox,
                                     int B, int V, int F, void* stream) {
  return dsf_raster::launch_face_setup(proj, faces, rows, boxes, cbox, B, V,
                                       F, stream);
}

extern "C" int dsf_raster_skip(const float* rows, const float* boxes,
                               const float* cbox, const float* pix,
                               float* zbuf, int32_t* idx, int B, int F, int H,
                               int W, void* stream) {
  return launch_raster_skip<kTileX, kTileY>(rows, boxes, cbox, pix, zbuf,
                                            idx, B, F, H, W, stream);
}
