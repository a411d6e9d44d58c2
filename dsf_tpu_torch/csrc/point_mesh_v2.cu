// K7 — point -> mesh nearest-face argmin with an admissibility skip mask.
//
// Replaces: dsf_tpu/ops/pallas_point_mesh.py:argmin_faces_pallas_v2 (body
// _kernel_v2, region math _region_sqdist, constants _face_constants27),
// selected by dsf_tpu/ops/point_mesh.py:USE_V2_KERNEL (DSF_ICP_KERNEL=v2).
// The TPU variant's MXU dot products (use_mxu) are not ported: the TPU
// measured them slower, and this card has no use for a depth-4 product.
//
// Function: K3's (csrc/point_mesh.cu), the index of the nearest face among
// those admissible for each point (bit parts[n, p] of words[t]) and its
// squared distance, in the same divide-free form (point_tri27.cuh) on the
// same 28-float rows (ops/point_mesh_kernel.py:face_constants).  The faces come sorted by
// part (ops/point_mesh.py:_static_part_perm), so a 128-face chunk holds one
// part or few.  skip[n, tile] has bit ci set when some point of the
// 128-point tile admits some face of chunk ci (ops/point_mesh.py:v2_words);
// a clear bit is a block of pairs that are all inadmissible, and the block
// skips it whole.  Ties go to the lowest face index; a point that admits no
// face gets (1e10, 0).
//
// What bounds it on this card: operations, as K3: 63 float adds and
// multiplies per admissible pair.  The skip removes blocks, not pairs: in
// a block that runs, the inadmissible pairs still cost their word test.
//
// Design: K3's, with the chunk loop over 128-face chunks.  One block per
// (cloud, 128-point tile), one thread per point; the block reads its skip
// word once, and for every chunk whose bit is set stages the chunk's 128
// face rows (14 KB, float4 reads) and part words in shared memory.  The
// branch on the bit is uniform over the block.  Faces are visited in index
// order with a strict '<'.

#include <cuda_runtime.h>
#include <cstdint>

#include "point_tri27.cuh"

namespace {

constexpr int kThreads = 128;        // points per block (the skip tile)
constexpr int kChunk = 128;          // faces per skip bit
using dsf_icp::kInf;
using dsf_icp::kRow4;

__global__ void __launch_bounds__(kThreads)
point_mesh_v2_kernel(const float* __restrict__ points,     // (N, P, 3)
                     const float4* __restrict__ fc,        // (N, T, 7)
                     const uint32_t* __restrict__ words,   // (T,)
                     const int32_t* __restrict__ parts,    // (N, P)
                     const uint32_t* __restrict__ skip,    // (N, NT)
                     float* __restrict__ dmin,             // (N, P)
                     int32_t* __restrict__ imin,           // (N, P)
                     int P, int T) {
  __shared__ float4 s_fc[kChunk * kRow4];
  __shared__ uint32_t s_w[kChunk];
  const int n = blockIdx.y;
  const int NT = gridDim.x;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < P;
  const uint32_t word = skip[(size_t)n * NT + blockIdx.x];

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
  const int nc = (T + kChunk - 1) / kChunk;
  for (int ci = 0; ci < nc; ++ci) {
    if (!((word >> ci) & 1u)) continue;   // uniform over the block
    const int t0 = ci * kChunk;
    const int nf = min(kChunk, T - t0);
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

extern "C" int dsf_point_mesh_argmin_v2(const float* points, const float* fc,
                                        const int32_t* words,
                                        const int32_t* parts,
                                        const int32_t* skip, float* dmin,
                                        int32_t* imin, int N, int P, int T,
                                        void* stream) {
  const dim3 grid((P + kThreads - 1) / kThreads, N);
  point_mesh_v2_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      points, reinterpret_cast<const float4*>(fc),
      reinterpret_cast<const uint32_t*>(words), parts,
      reinterpret_cast<const uint32_t*>(skip), dmin, imin, P, T);
  return static_cast<int>(cudaGetLastError());
}
