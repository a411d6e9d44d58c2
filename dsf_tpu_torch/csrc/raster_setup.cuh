// The face set-up of the raster kernels K1 (raster_skip.cu) and K6
// (raster_dense.cu), on the card: one thread per (image, face) builds
//
//  * the face's 16-float row, bitwise-equal to rasterize.face_rows (the
//    plain version): rasterize.face_coeffs rounds every product and sum on
//    its own, left to right, so each is written with __fmul_rn /
//    __fadd_rn / __fsub_rn in that order (nvcc would otherwise contract to
//    FMAs); 1.0 / A is PyTorch's IEEE-rounded reciprocal (__frcp_rn, not a
//    fast one), and torch.sign(0) is 0;
//  * the face's screen box (umin, umax, vmin, vmax), empty (+inf, -inf)
//    for an invalid face, so that no box test passes it;
//  * per block of kCull faces, the union of its faces' boxes (the chunk
//    box), which lets a raster block skip a whole chunk with one test.
//
// It replaces about 25 eager PyTorch launches per raster call
// (rasterize.skip_tables); each library that includes it exports a C
// entry point for it, so a raster route needs no other library.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "raster_rows.cuh"

namespace dsf_raster {

__global__ void __launch_bounds__(kCull)
face_setup_kernel(const float* __restrict__ proj,      // (B, V, 3)
                  const int32_t* __restrict__ faces,   // (F, 3)
                  float* __restrict__ rows,            // (B, F, 16)
                  float* __restrict__ boxes,           // (B, F, 4)
                  float* __restrict__ cbox,            // (B, nc, 4)
                  int V, int F) {
  __shared__ float s_part[4][kCull / 32];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int f = blockIdx.x * kCull + tid;
  float4 box = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  if (f < F) {
    const float* pb = proj + (size_t)b * V * 3;
    const float* p0 = pb + 3 * faces[3 * f];
    const float* p1 = pb + 3 * faces[3 * f + 1];
    const float* p2 = pb + 3 * faces[3 * f + 2];
    const float u0 = p0[0], v0 = p0[1], z0 = p0[2];
    const float u1 = p1[0], v1 = p1[1], z1 = p1[2];
    const float u2 = p2[0], v2 = p2[1], z2 = p2[2];
    const float c0 = __fsub_rn(__fmul_rn(u1, v2), __fmul_rn(u2, v1));
    const float c1 = __fsub_rn(__fmul_rn(u2, v0), __fmul_rn(u0, v2));
    const float c2 = __fsub_rn(__fmul_rn(u0, v1), __fmul_rn(u1, v0));
    const float A = __fadd_rn(__fadd_rn(c0, c1), c2);   // 2x signed area
    const bool valid = fabsf(A) > 1e-9f;
    const float sgn = (A > 0.f ? 1.f : 0.f) - (A < 0.f ? 1.f : 0.f);
    const float a0 = __fmul_rn(__fsub_rn(v1, v2), sgn);
    const float a1 = __fmul_rn(__fsub_rn(v2, v0), sgn);
    const float a2 = __fmul_rn(__fsub_rn(v0, v1), sgn);
    const float b0 = __fmul_rn(__fsub_rn(u2, u1), sgn);
    const float b1 = __fmul_rn(__fsub_rn(u0, u2), sgn);
    const float b2 = __fmul_rn(__fsub_rn(u1, u0), sgn);
    const float c0s = __fmul_rn(c0, sgn);
    const float c1s = __fmul_rn(c1, sgn);
    const float c2s = __fmul_rn(c2, sgn);
    const float w = __fmul_rn(sgn, valid ? __frcp_rn(A) : 0.f);
    const float az = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(a0, z0),
                                                   __fmul_rn(a1, z1)),
                                         __fmul_rn(a2, z2)), w);
    const float bz = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(b0, z0),
                                                   __fmul_rn(b1, z1)),
                                         __fmul_rn(b2, z2)), w);
    const float cz = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(c0s, z0),
                                                   __fmul_rn(c1s, z1)),
                                         __fmul_rn(c2s, z2)), w);
    float4* row = reinterpret_cast<float4*>(rows) + ((size_t)b * F + f) * 4;
    row[0] = make_float4(a0, b0, c0s, a1);
    row[1] = make_float4(b1, c1s, a2, b2);
    row[2] = make_float4(c2s, az, bz, cz);
    row[3] = make_float4(valid ? 1.f : 0.f, 0.f, 0.f, 0.f);
    if (valid) {
      box = make_float4(fminf(fminf(u0, u1), u2), fmaxf(fmaxf(u0, u1), u2),
                        fminf(fminf(v0, v1), v2), fmaxf(fmaxf(v0, v1), v2));
    }
    reinterpret_cast<float4*>(boxes)[(size_t)b * F + f] = box;
  }
  // the chunk box: the union over the block's faces
  float4 r = box;
  for (int off = 16; off > 0; off >>= 1) {
    r.x = fminf(r.x, __shfl_xor_sync(0xffffffffu, r.x, off));
    r.y = fmaxf(r.y, __shfl_xor_sync(0xffffffffu, r.y, off));
    r.z = fminf(r.z, __shfl_xor_sync(0xffffffffu, r.z, off));
    r.w = fmaxf(r.w, __shfl_xor_sync(0xffffffffu, r.w, off));
  }
  if ((tid & 31) == 0) {
    s_part[0][tid >> 5] = r.x;
    s_part[1][tid >> 5] = r.y;
    s_part[2][tid >> 5] = r.z;
    s_part[3][tid >> 5] = r.w;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kCull / 32; ++k) {
      r.x = fminf(r.x, s_part[0][k]);
      r.y = fmaxf(r.y, s_part[1][k]);
      r.z = fminf(r.z, s_part[2][k]);
      r.w = fmaxf(r.w, s_part[3][k]);
    }
    reinterpret_cast<float4*>(cbox)[(size_t)b * gridDim.x + blockIdx.x] = r;
  }
}

// Launch the set-up over B images of V vertices and F faces on stream.
inline int launch_face_setup(const float* proj, const int32_t* faces,
                             float* rows, float* boxes, float* cbox, int B,
                             int V, int F, void* stream) {
  const dim3 grid((F + kCull - 1) / kCull, B);
  face_setup_kernel<<<grid, kCull, 0, static_cast<cudaStream_t>(stream)>>>(
      proj, faces, rows, boxes, cbox, V, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dsf_raster
