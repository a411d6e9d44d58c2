// K10 — binned raster: nearest-face depth and face id per pixel, each
// 16x16 pixel tile against its own list of faces.
//
// Replaces: dsf_tpu/ops/pallas_raster.py:raster_pallas_tiles, the binned
// route of dsf_tpu/ops/rasterize.py:_raster_forward (a pixel layout given
// as tile_hw, with the skip raster switched off).  Its body _kernel_binned
// and its caller's face_coeff_rows are defined nowhere in the JAX package,
// so this kernel follows the CPU semantics of rasterize._raster_binned
// (rasterize.py:257-343).
//
// Function: rasterize.raster_binned_plain's.  lists[b, g] holds, in
// ascending order, the valid faces whose screen bbox meets the bbox of
// tile g's sample positions (at most cap of them; counts[b, g] before the
// cap; rasterize.binned_tables).  Per pixel, the least depth z > 0 over
// the tile's list and the lowest face id at that depth; (0, -1) where none
// covers it.  When any tile of the batch overflows its cap (overflow[0]),
// every tile scans all faces: the dense answer, as the JAX package's
// whole-batch lax.cond gives it, read from the device so that nothing
// waits on the host.
//
// What bounds it on this card: arithmetic over the listed (pixel, face)
// pairs, ~16 float operations each, and at a crop's size the launch.
//
// Design: K1's (csrc/raster_skip.cu) with the bounding-box test moved into
// the list.  One block per (image, 16x16 tile), one thread per pixel; the
// block walks its list 64 faces at a time, gathering the 64 rows (16
// floats each) into shared memory with one float4 load per thread, and
// every thread walks them in list order with a strict '<', so the first
// face of the least depth wins.  Products and sums are rounded on their
// own in the plain version's order, so zbuf is bitwise-equal to it; the
// per-face test is raster_rows.cuh's, shared with K1 and K6.

#include <cuda_runtime.h>
#include <cstdint>

#include "raster_rows.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
using dsf_raster::kChunk;
using dsf_raster::kInf;
using dsf_raster::kRow;

__global__ void __launch_bounds__(kThreads)
raster_binned_kernel(const float* __restrict__ rows,       // (B, F, 16)
                     const float* __restrict__ pix,        // (B, H*W, 2)
                     const int32_t* __restrict__ lists,    // (B, G, cap)
                     const int32_t* __restrict__ counts,   // (B, G)
                     const int32_t* __restrict__ overflow, // (1,)
                     float* __restrict__ zbuf,             // (B, H*W)
                     int32_t* __restrict__ idx,            // (B, H*W)
                     int F, int H, int W, int cap) {
  __shared__ __align__(16) float s_rows[kChunk * kRow];
  __shared__ int32_t s_fid[kChunk];

  const int b = blockIdx.z;
  const int G = gridDim.x * gridDim.y;
  const int g = blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  const long long P = (long long)H * W;
  const long long p = (long long)y * W + x;

  const float2 uv = reinterpret_cast<const float2*>(pix)[b * P + p];
  const float u = uv.x, v = uv.y;

  const bool dense = overflow[0] != 0;
  const int n = dense ? F : min(counts[(size_t)b * G + g], cap);
  const int32_t* list = lists + ((size_t)b * G + g) * cap;
  const float4* rows_b = reinterpret_cast<const float4*>(rows) + (size_t)b * F * 4;
  float best = kInf;
  int best_i = -1;

  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int nf = min(kChunk, n - k0);
    __syncthreads();                // previous chunk fully consumed
    {
      // 64 rows x 4 float4: one float4 per thread
      const int f = tid >> 2, q = tid & 3;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      int fid = -1;
      if (f < nf) {
        fid = dense ? k0 + f : list[k0 + f];
        val = rows_b[(size_t)fid * 4 + q];
      }
      reinterpret_cast<float4*>(s_rows)[tid] = val;
      if (q == 0) s_fid[f] = fid;
    }
    __syncthreads();
    for (int k = 0; k < nf; ++k) {
      dsf_raster::nearer(s_rows + k * kRow, u, v, s_fid[k], best, best_i);
    }
  }
  dsf_raster::store(best, best_i, zbuf, idx, b * P + p);
}

}  // namespace

extern "C" int dsf_raster_binned(const float* rows, const float* pix,
                                 const int32_t* lists, const int32_t* counts,
                                 const int32_t* overflow, float* zbuf,
                                 int32_t* idx, int B, int F, int H, int W,
                                 int cap, void* stream) {
  const dim3 block(kTile, kTile);
  const dim3 grid(W / kTile, H / kTile, B);
  raster_binned_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, pix, lists, counts, overflow, zbuf, idx, F, H, W, cap);
  return static_cast<int>(cudaGetLastError());
}
