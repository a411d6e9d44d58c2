// K1 — skip-raster: nearest-face depth and face id per crop pixel.
//
// Replaces: dsf_tpu/ops/pallas_raster.py:raster_pallas_skip (body
// _kernel_skip_impl), dispatched from dsf_tpu/ops/rasterize.py:426-430.
//
// What bounds it on this card: arithmetic.  The inputs are small (at the
// serving shape B=32, 64x64 pixels, 1554 faces: 3.2 MB of face rows, 1 MB
// of positions, 1 MB out), while the dense work is B * P * F * ~16 float
// operations (3.3 GFLOP), of which the bbox skip keeps only the
// (tile, chunk) blocks whose screen boxes overlap.  CUDA cores at the
// float32 non-tensor rate do it: the edge/depth dot products have depth 3,
// nothing a tensor core would take.
//
// Design:
//  * one block per (image, 16x16 pixel tile), one thread per pixel; the
//    block reduces its own tile bbox from its 256 sample positions;
//  * faces are walked in chunks of 64.  A chunk whose bbox (precomputed by
//    the wrapper) misses the tile bbox is skipped by the whole block with
//    one uniform branch; otherwise its 64 rows (16 floats each: 12
//    coefficients, the valid flag, padding) are staged in shared memory
//    with one float4 load per thread, and every thread walks them in index
//    order with a strict `<`.  That picks the lowest face index at the
//    global minimum, the choice rasterize._scan_minz makes;
//  * the TPU version's 31-chunk int32 bitmask and 4e9 pixel padding were
//    scalar-prefetch devices; here the block tests the boxes itself and
//    masks its ragged edge;
//  * nvcc would contract a*u + b*v + c into an FMA; the plain PyTorch
//    version rounds each product and sum on its own.  The edge and depth
//    expressions use __fmul_rn / __fadd_rn in the plain version's order,
//    so zbuf is bitwise-equal to it (raster_rows.cuh, shared with K6 and
//    K10);
//  * the tile bbox is widened by one pixel before the overlap test, so a
//    sample that rounding puts "inside" a face just outside that face's
//    box is never lost to the skip.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "raster_rows.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
using dsf_raster::kChunk;
using dsf_raster::kInf;
using dsf_raster::kRow;
constexpr float kMargin = 1.0f;

__global__ void __launch_bounds__(kThreads)
raster_skip_kernel(const float* __restrict__ rows,   // (B, F, 16)
                   const float* __restrict__ cbox,   // (B, nc, 4)
                   const float* __restrict__ pix,    // (B, H*W, 2)
                   float* __restrict__ zbuf,         // (B, H*W)
                   int32_t* __restrict__ idx,        // (B, H*W)
                   int F, int H, int W) {
  __shared__ __align__(16) float s_rows[kChunk * kRow];
  __shared__ float s_part[4][kThreads / 32];
  __shared__ float s_tile[4];

  const int b = blockIdx.z;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  const bool active = x < W && y < H;
  const long long P = (long long)H * W;
  const long long p = (long long)y * W + x;
  const int nc = (F + kChunk - 1) / kChunk;

  float u = 0.f, v = 0.f;
  if (active) {
    const float2 uv = reinterpret_cast<const float2*>(pix)[b * P + p];
    u = uv.x;
    v = uv.y;
  }

  // tile bbox from the block's own sample positions
  float r0 = active ? u : INFINITY, r1 = active ? u : -INFINITY;
  float r2 = active ? v : INFINITY, r3 = active ? v : -INFINITY;
  for (int off = 16; off > 0; off >>= 1) {
    r0 = fminf(r0, __shfl_xor_sync(0xffffffffu, r0, off));
    r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, off));
    r2 = fminf(r2, __shfl_xor_sync(0xffffffffu, r2, off));
    r3 = fmaxf(r3, __shfl_xor_sync(0xffffffffu, r3, off));
  }
  if ((tid & 31) == 0) {
    s_part[0][tid >> 5] = r0;
    s_part[1][tid >> 5] = r1;
    s_part[2][tid >> 5] = r2;
    s_part[3][tid >> 5] = r3;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      r0 = fminf(r0, s_part[0][w]);
      r1 = fmaxf(r1, s_part[1][w]);
      r2 = fminf(r2, s_part[2][w]);
      r3 = fmaxf(r3, s_part[3][w]);
    }
    s_tile[0] = r0 - kMargin;
    s_tile[1] = r1 + kMargin;
    s_tile[2] = r2 - kMargin;
    s_tile[3] = r3 + kMargin;
  }
  __syncthreads();
  const float tumin = s_tile[0], tumax = s_tile[1];
  const float tvmin = s_tile[2], tvmax = s_tile[3];

  const float* rows_b = rows + (size_t)b * F * kRow;
  const float4* cbox_b = reinterpret_cast<const float4*>(cbox) + (size_t)b * nc;
  float best = kInf;
  int best_i = -1;

  for (int ci = 0; ci < nc; ++ci) {
    const float4 cb = cbox_b[ci];   // umin, umax, vmin, vmax
    // uniform over the block: every thread reads the same box
    if (!(cb.x <= tumax && cb.y >= tumin && cb.z <= tvmax && cb.w >= tvmin))
      continue;
    const int f0 = ci * kChunk;
    const int nf = min(kChunk, F - f0);
    __syncthreads();                // previous chunk fully consumed
    dsf_raster::stage_rows(s_rows, rows_b, f0, nf, tid);
    __syncthreads();
    if (active) {
      for (int k = 0; k < nf; ++k) {
        dsf_raster::nearer(s_rows + k * kRow, u, v, f0 + k, best, best_i);
      }
    }
  }
  if (active) {
    dsf_raster::store(best, best_i, zbuf, idx, b * P + p);
  }
}

}  // namespace

extern "C" int dsf_raster_skip(const float* rows, const float* cbox,
                               const float* pix, float* zbuf, int32_t* idx,
                               int B, int F, int H, int W, void* stream) {
  const dim3 block(kTile, kTile);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  raster_skip_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, cbox, pix, zbuf, idx, F, H, W);
  return static_cast<int>(cudaGetLastError());
}
