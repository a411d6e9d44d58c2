// K2 — raster-backward moments: per-face sums of the cotangent rows.
//
// Replaces: dsf_tpu/ops/pallas_raster.py:face_moments_pallas (body
// _moments_kernel), the building block of the raster backward
// dsf_tpu/ops/rasterize.py:_attach_bwd (:461-536).  On the TPU that
// backward takes the chunked one-hot einsum by default
// (rasterize.py:499-511, USE_PALLAS_MOMENTS = False); both compute the
// same function, which this kernel computes on Hopper.
//
// Function: out[b, t, m] = sum over pixels p with idx[b, p] == t of
// upd[b, p, m], for m in {g, g*u, g*v}; ids outside [0, T) (background
// is -1) add nothing.
//
// What bounds it on this card: bytes.  At the training step's shape
// (B=32, P=64^2, T=1554) it reads 2.1 MB (ids and rows) and writes 0.6 MB,
// and does one add per row value: 0.4 M adds, nothing beside the bytes.
//
// Design:
//  * the TPU kernel built a (tile, T) one-hot in VMEM and ran it through
//    the matrix unit in three bf16 passes; a scatter keyed by face id is
//    the direct form on this card;
//  * one block per (image, range of kRange faces).  The block keeps its
//    faces' 3 x kRange float accumulators in shared memory (6 KB), scans
//    all P ids of its image with coalesced 4-byte reads, adds the rows of
//    the pixels whose face falls in its range with shared-memory atomics,
//    then writes each face of its range once.  No global atomics, no
//    memset pass, and B * ceil(T / kRange) blocks (128 at the step's
//    shape) to fill the card, each reading the ids once more than a
//    single block per image would (64 KB per image);
//  * shared-memory float atomics add in an order that changes from run to
//    run, so sums agree with a sequential scatter to float32 rounding of
//    the summation order, not bitwise.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRange = 512;          // faces per block

__global__ void __launch_bounds__(kThreads)
moments_kernel(const int32_t* __restrict__ idx,   // (B, P)
               const float* __restrict__ upd,     // (B, P, 3)
               float* __restrict__ out,           // (B, T, 3)
               int P, int T) {
  __shared__ float s_acc[3 * kRange];
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kRange;
  const int nf = min(kRange, T - f0);
  for (int i = threadIdx.x; i < 3 * nf; i += kThreads) s_acc[i] = 0.f;
  __syncthreads();

  const int32_t* ib = idx + (size_t)b * P;
  const float* ub = upd + (size_t)b * P * 3;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    // unsigned compare: -1 and every other id outside the range wrap high
    const unsigned local = static_cast<unsigned>(ib[p] - f0);
    if (ib[p] >= 0 && local < static_cast<unsigned>(nf)) {
      const float* r = ub + (size_t)p * 3;
      atomicAdd(&s_acc[3 * local], r[0]);
      atomicAdd(&s_acc[3 * local + 1], r[1]);
      atomicAdd(&s_acc[3 * local + 2], r[2]);
    }
  }
  __syncthreads();
  float* ob = out + ((size_t)b * T + f0) * 3;
  for (int i = threadIdx.x; i < 3 * nf; i += kThreads) ob[i] = s_acc[i];
}

}  // namespace

extern "C" int dsf_raster_moments(const int32_t* idx, const float* upd,
                                  float* out, int B, int P, int T,
                                  void* stream) {
  const dim3 grid((T + kRange - 1) / kRange, B);
  moments_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, upd, out, P, T);
  return static_cast<int>(cudaGetLastError());
}
