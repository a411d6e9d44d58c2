// K3 — point -> mesh nearest-face argmin under a factorized part mask.
//
// Replaces: dsf_tpu/ops/pallas_point_mesh.py:argmin_faces_pallas (body
// _kernel, region math _region_sqdist, constants _face_constants27), the
// argmin pass behind every ICP term of the self-supervised step
// (dsf_tpu/ops/point_mesh.py:point_face_distance).
//
// Function: for each point p of cloud n, the index of the nearest face t
// among those admissible for p (bit parts[n, p] of words[t] set), and its
// squared distance.  Ties go to the lowest face index; a point that admits
// no face gets (1e10, 0), as the JAX paths' initial values do.
//
// Distance form: divide-free, as the Pallas body: point_tri27.cuh, shared
// with K7.  The plain version (ops/point_mesh.py:argmin_faces_plain)
// divides for the barycentric closest point instead; the two agree to
// float32 rounding of the distance, so near-ties may pick another face of
// (almost) the same distance.
//
// What bounds it on this card: operations.  At the FinetuneStage step's
// shape (128 clouds x 2048 points x 1554 faces, 4.1e8 pairs, of which the
// full clouds' half admits every face and the joint clouds' half only its
// bone's) it reads ~15 MB and does 63 float adds and multiplies per
// admissible pair (an FMA counts 2); the bytes take ~4 us, the operations
// ~0.3 ms at the 67 TFLOP/s float32 rate.
//
// Design:
//  * the TPU kernel tiled points x 128-face chunks in VMEM on the VPU and
//    ran the part mask as a one-hot matmul on the MXU; here one thread
//    owns one point and keeps its running (min, argmin) in registers;
//  * each block (128 points of one cloud) streams the cloud's face rows
//    through shared memory, kTile faces at a time (7 KB), read as float4;
//    every thread of a warp reads the same face at once (a broadcast);
//  * the part mask is one 32-bit word per face and the point's part a bit
//    index: a pair is skipped unless (word >> part) & 1;
//  * faces are visited in index order with a strict '<', so the first
//    face of the least distance wins.

#include <cuda_runtime.h>
#include <cstdint>

#include "point_tri27.cuh"

namespace {

constexpr int kThreads = 128;        // points per block
constexpr int kTile = 64;            // faces per shared-memory tile
using dsf_icp::kInf;
using dsf_icp::kRow4;

__global__ void __launch_bounds__(kThreads)
point_mesh_argmin_kernel(const float* __restrict__ points,     // (N, P, 3)
                         const float4* __restrict__ fc,      // (N, T, 7)
                         const uint32_t* __restrict__ words, // (T,)
                         const int32_t* __restrict__ parts,  // (N, P)
                         float* __restrict__ dmin,           // (N, P)
                         int32_t* __restrict__ imin,         // (N, P)
                         int P, int T) {
  __shared__ float4 s_fc[kTile * kRow4];
  __shared__ uint32_t s_w[kTile];
  const int n = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < P;

  float px = 0.f, py = 0.f, pz = 0.f;
  uint32_t bit = 0u;                  // a padding thread admits nothing
  if (live) {
    const float* q = points + ((size_t)n * P + p) * 3;
    px = q[0];
    py = q[1];
    pz = q[2];
    bit = 1u << (parts[(size_t)n * P + p] & 31);
  }
  const float pp = px * px + py * py + pz * pz;
  float best = kInf;
  int arg = 0;

  const float4* fcn = fc + (size_t)n * T * kRow4;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int nf = min(kTile, T - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nf * kRow4; i += kThreads)
      s_fc[i] = fcn[(size_t)t0 * kRow4 + i];
    for (int i = threadIdx.x; i < nf; i += kThreads) s_w[i] = words[t0 + i];
    __syncthreads();

    for (int f = 0; f < nf; ++f) {
      if (!(s_w[f] & bit)) continue;
      const float d = dsf_icp::region_sqdist27(
          reinterpret_cast<const float*>(s_fc + f * kRow4), px, py, pz,
          pp);
      if (d < best) {
        best = d;
        arg = t0 + f;
      }
    }
  }
  if (live) {
    dmin[(size_t)n * P + p] = best;
    imin[(size_t)n * P + p] = arg;
  }
}

}  // namespace

extern "C" int dsf_point_mesh_argmin(const float* points, const float* fc,
                                     const int32_t* words,
                                     const int32_t* parts, float* dmin,
                                     int32_t* imin, int N, int P, int T,
                                     void* stream) {
  const dim3 grid((P + kThreads - 1) / kThreads, N);
  point_mesh_argmin_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      points, reinterpret_cast<const float4*>(fc),
      reinterpret_cast<const uint32_t*>(words), parts, dmin, imin, P, T);
  return static_cast<int>(cudaGetLastError());
}
