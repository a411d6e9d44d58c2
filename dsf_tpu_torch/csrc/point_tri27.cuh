// The divide-free point-triangle squared distance of the ICP argmin
// kernels K3 (point_mesh.cu) and K7 (point_mesh_v2.cu), both through
// argmin_body.cuh, in one place so
// that both keep the same arithmetic (ref: the Pallas bodies' region math,
// dsf_tpu/ops/pallas_point_mesh.py:_region_sqdist, on the constants of
// _face_constants27).
//
// With three per-pair dot products s1 = ab.p, s2 = ac.p, pa = a.p and the
// plane dot pn = n.p, the Ericson region tests are sign tests on
// d_k = s_i - const, and each region's squared distance has a closed form
// over per-face constants (precomputed once a face by the set-up kernel,
// argmin_setup.cuh:row27, word for word the plain rows of
// ops/point_mesh_kernel.py:face_constants):
//   vertex v:     p.p - 2 p.v + v.v
//   edge (u, e):  |p - u|^2 - (e.(p - u))^2 / |e|^2
//   interior:     (n.(p - a))^2 / |n|^2
// 63 float adds and multiplies a pair (an FMA counts 2).  The plain version
// (ops/point_mesh.py:point_tri_sqdist) divides for the barycentric closest
// point instead; the two agree to float32 rounding of the distance.  Needs
// non-degenerate faces, as the Pallas kernels do.

#pragma once

#include <cuda_runtime.h>

namespace dsf_icp {

constexpr int kRow4 = 7;             // float4 per face row (28 floats)
constexpr float kInf = 1e10f;

// The squared distance from p = (px, py, pz), pp = p.p, to the face of row
// c: a(0-2) ab(3-5) ac(6-8) n(9-11) | ab.a ac.a ab.b ac.b ab.c ac.c
// (12-17) | a.a b.b c.c (18-20) | 1/ab.ab 1/ac.ac 1/bc.bc (21-23) | bc.b
// n.a 1/n.n (24-26), clamped at 0.
__device__ __forceinline__ float region_sqdist27(const float* c, float px,
                                                 float py, float pz,
                                                 float pp) {
  const float s1 = px * c[3] + py * c[4] + pz * c[5];
  const float s2 = px * c[6] + py * c[7] + pz * c[8];
  const float pa = px * c[0] + py * c[1] + pz * c[2];
  const float pn = px * c[9] + py * c[10] + pz * c[11];
  const float d1 = s1 - c[12], d2 = s2 - c[13];
  const float d3 = s1 - c[14], d4 = s2 - c[15];
  const float d5 = s1 - c[16], d6 = s2 - c[17];
  const float vc = d1 * d4 - d3 * d2;
  const float vb = d5 * d2 - d1 * d6;
  const float va = d3 * d6 - d5 * d4;
  const float dA = pp - 2.f * pa + c[18];
  const float dB = pp - 2.f * (pa + s1) + c[19];      // p.b = p.a + ab.p
  const float dC = pp - 2.f * (pa + s2) + c[20];
  const float dpn = pn - c[25];
  float d = dpn * dpn * c[26];                          // face interior
  if (va <= 0.f && d4 - d3 >= 0.f && d5 - d6 >= 0.f) {
    const float e = (s2 - s1) - c[24];                 // bc.(p - b)
    d = dB - e * e * c[23];
  }
  if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) d = dA - d2 * d2 * c[22];
  if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) d = dA - d1 * d1 * c[21];
  if (d6 >= 0.f && d5 <= d6) d = dC;
  if (d3 >= 0.f && d4 <= d3) d = dB;
  if (d1 <= 0.f && d2 <= 0.f) d = dA;
  return fmaxf(d, 0.f);
}

}  // namespace dsf_icp
