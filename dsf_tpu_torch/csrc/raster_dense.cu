// K6 — dense raster: nearest-face depth and face id per sample position,
// every face against every sample.
//
// Replaces: dsf_tpu/ops/pallas_raster.py:raster_pallas (body _kernel_impl),
// the dense route of dsf_tpu/ops/rasterize.py:_raster_forward (no pixel
// layout: the full-frame pre-render, dsf_tpu/tools/prerender.py).
//
// Function: rasterize.raster_scan's.  Per sample, the least depth z > 0 of
// the valid faces whose three edge functions are >= 0 there, and the
// lowest face index at that depth; (0, -1) where no face covers it.  The
// TPU kernel disabled invalid faces by folding -1e10 into c0; here the
// rows carry K1's valid flag (rasterize.face_rows).
//
// What bounds it on this card: arithmetic.  At the pre-render's shape (B=32
// NYU frames of 640x480, 1554 faces) the bytes are ~80 MB of positions and
// outputs and 3 MB of face rows, while the work is B * P * F pairs of ~16
// float operations (2.4e11, ~3.6 ms at the float32 rate).  The depth
// products have depth 3, nothing a tensor core would take.
//
// Design: K1's inner loop without its bounding-box skip.  One thread per
// sample, 256 samples a block; faces are staged 64 rows (16 floats each)
// at a time in shared memory with one float4 load per thread, and every
// thread walks them in index order with a strict '<'.  Products and sums
// are rounded on their own (__fmul_rn / __fadd_rn) in the plain version's
// order, so zbuf is bitwise-equal to it; the test and the staging are
// raster_rows.cuh's, shared with K1 and K10.

#include <cuda_runtime.h>
#include <cstdint>

#include "raster_rows.cuh"

namespace {

constexpr int kThreads = 256;
using dsf_raster::kChunk;
using dsf_raster::kInf;
using dsf_raster::kRow;

__global__ void __launch_bounds__(kThreads)
raster_dense_kernel(const float* __restrict__ rows,   // (B, F, 16)
                    const float* __restrict__ pix,    // (B, P, 2)
                    float* __restrict__ zbuf,         // (B, P)
                    int32_t* __restrict__ idx,        // (B, P)
                    int F, int P) {
  __shared__ __align__(16) float s_rows[kChunk * kRow];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const long long p = (long long)blockIdx.x * kThreads + tid;
  const bool active = p < P;

  float u = 0.f, v = 0.f;
  if (active) {
    const float2 uv = reinterpret_cast<const float2*>(pix)[(long long)b * P + p];
    u = uv.x;
    v = uv.y;
  }
  const float* rows_b = rows + (size_t)b * F * kRow;
  float best = kInf;
  int best_i = -1;

  for (int f0 = 0; f0 < F; f0 += kChunk) {
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
    dsf_raster::store(best, best_i, zbuf, idx, (long long)b * P + p);
  }
}

}  // namespace

extern "C" int dsf_raster_dense(const float* rows, const float* pix,
                                float* zbuf, int32_t* idx, int B, int F,
                                int P, void* stream) {
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  raster_dense_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      rows, pix, zbuf, idx, F, P);
  return static_cast<int>(cudaGetLastError());
}
