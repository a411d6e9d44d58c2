// The per-face depth test of the raster kernels K1 (raster_skip.cu), K6
// (raster_dense.cu) and K10 (raster_binned.cu), in one place so that the
// three stay bitwise-equal to their common plain version
// (ops/rasterize.py:_depth_or_inf and scan_rows).
//
// A face row is 16 floats (rasterize.face_rows): the three edge lines
// a*u + b*v + c (0-8), the depth line (9-11), the valid flag (12) and
// padding.  nvcc would contract a*u + b*v + c into an FMA; the plain
// version rounds each product and sum on its own, so the lines are
// evaluated with __fmul_rn / __fadd_rn in its order.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace dsf_raster {

constexpr int kRow = 16;             // floats per face row
constexpr int kChunk = 64;           // face rows per shared-memory stage
constexpr float kInf = 1e10f;

__device__ __forceinline__ float lin(float u, float v, float a, float b,
                                     float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(u, a), __fmul_rn(v, b)), c);
}

// Face row r against the sample (u, v): when the sample lies inside the
// valid face (every edge >= 0) at a depth z > 0 below best, (z, id) become
// the best.  A strict '<' over faces taken in index order keeps the lowest
// id at the least depth.
__device__ __forceinline__ void nearer(const float* r, float u, float v,
                                       int id, float& best, int& best_i) {
  if (r[12] == 0.f) return;                   // degenerate face
  const float e0 = lin(u, v, r[0], r[1], r[2]);
  const float e1 = lin(u, v, r[3], r[4], r[5]);
  const float e2 = lin(u, v, r[6], r[7], r[8]);
  const float z = lin(u, v, r[9], r[10], r[11]);
  if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && z > 0.f && z < best) {
    best = z;
    best_i = id;
  }
}

// Stage rows f0 .. f0 + nf - 1 (nf <= kChunk) of one image's (F, 16) rows
// into s_rows: 64 rows x 16 floats = 256 float4, one per thread of a
// 256-thread block; rows past nf are zero (invalid).
__device__ __forceinline__ void stage_rows(float* s_rows, const float* rows,
                                           int f0, int nf, int tid) {
  float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
  if ((tid >> 2) < nf)
    val = reinterpret_cast<const float4*>(rows + (size_t)f0 * kRow)[tid];
  reinterpret_cast<float4*>(s_rows)[tid] = val;
}

// The sample's result: (best, best_i), or (0, -1) where no face covers it.
__device__ __forceinline__ void store(float best, int best_i, float* zbuf,
                                      int32_t* idx, long long at) {
  const bool bg = !(best < kInf);
  zbuf[at] = bg ? 0.f : best;
  idx[at] = bg ? -1 : best_i;
}

}  // namespace dsf_raster
