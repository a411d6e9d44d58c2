// K6 — dense raster: nearest-face depth and face id per sample position,
// with no pixel layout assumed.
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
// What bounds it on this card: bytes.  At the pre-render's shape (B=32
// NYU frames of 640x480, 1554 faces) the positions and outputs are ~157
// MB, while the (sample, face) pairs in a face's box are ~4e6 of the 1.5e10
// a test of every pair makes (the hand covers a few percent of the
// frame).  The design's job is to touch no pair outside a face's box
// and to keep enough position loads in flight.
//
// Design: K1's (raster_skip.cu) over blocks of 128 consecutive samples,
// two a thread.  The set-up (raster_setup.cuh, one thread per (image,
// face)) builds the face rows bitwise as rasterize.face_rows does, each
// face's cover box (raster_setup.cuh:cover_box) and each 256-face chunk's
// box.  Each raster block reduces the box of its samples and bins the
// faces inside the block (raster_rows.cuh:scan_culled): chunks and faces
// whose cover boxes miss the block's cover none of its samples and are
// never staged; the rest are walked in ascending face order with a strict
// '<', so zbuf and ids are bitwise
// raster_scan's.  The result does not depend on the sample order, only the
// speed does: in the pre-render's raster order a block is a strip of a
// frame row, and a strip away from the hand skips every chunk after its
// box reduction.  Two samples a thread keep two position loads in flight
// for those strips; 128 samples keep the strips that meet the hand short.
// Of the shapes scripts/raster_shapes_gpu.py times, 64 threads x 2 samples
// was the fastest.

#include <cuda_runtime.h>
#include <cstdint>

#include "raster_rows.cuh"
#include "raster_setup.cuh"

namespace {

// the block: kThreads threads over kThreads * kSamples consecutive samples
constexpr int kThreads = 64;
constexpr int kSamples = 2;
using dsf_raster::kRow;

// A block of NT threads over NT * S consecutive samples: thread t takes
// samples t, t + NT, ...
template <int NT, int S>
__global__ void __launch_bounds__(NT)
raster_dense_kernel(const float* __restrict__ rows,   // (B, F, 16)
                    const float* __restrict__ boxes,  // (B, F, 4)
                    const float* __restrict__ cbox,   // (B, nc, 4)
                    const float* __restrict__ pix,    // (B, P, 2)
                    float* __restrict__ zbuf,         // (B, P)
                    int32_t* __restrict__ idx,        // (B, P)
                    int F, int P) {
  __shared__ dsf_raster::CullShared<NT> s;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nc = (F + dsf_raster::kCull - 1) / dsf_raster::kCull;

  float u[S], v[S], best[S];
  int best_i[S];
  bool active[S];
  long long at[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const long long p = (long long)blockIdx.x * NT * S + j * NT + tid;
    active[j] = p < P;
    at[j] = (long long)b * P + p;
    u[j] = v[j] = 0.f;
    if (active[j]) {
      const float2 uv = reinterpret_cast<const float2*>(pix)[at[j]];
      u[j] = uv.x;
      v[j] = uv.y;
    }
    best[j] = dsf_raster::kInf;
    best_i[j] = -1;
  }
  dsf_raster::scan_culled<NT, S>(
      rows + (size_t)b * F * kRow,
      reinterpret_cast<const float4*>(boxes) + (size_t)b * F,
      reinterpret_cast<const float4*>(cbox) + (size_t)b * nc, F, u, v,
      active, tid, s, best, best_i);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (active[j]) dsf_raster::store(best[j], best_i[j], zbuf, idx, at[j]);
  }
}

template <int NT, int S>
int launch_raster_dense(const float* rows, const float* boxes,
                        const float* cbox, const float* pix, float* zbuf,
                        int32_t* idx, int B, int F, int P, void* stream) {
  const dim3 grid((P + NT * S - 1) / (NT * S), B);
  raster_dense_kernel<NT, S>
      <<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
          rows, boxes, cbox, pix, zbuf, idx, F, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsf_raster_dense_setup(const float* proj, const int32_t* faces,
                                      float* rows, float* boxes, float* cbox,
                                      int B, int V, int F, void* stream) {
  return dsf_raster::launch_face_setup(proj, faces, rows, boxes, cbox, B, V,
                                       F, stream);
}

extern "C" int dsf_raster_dense(const float* rows, const float* boxes,
                                const float* cbox, const float* pix,
                                float* zbuf, int32_t* idx, int B, int F,
                                int P, void* stream) {
  return launch_raster_dense<kThreads, kSamples>(rows, boxes, cbox, pix,
                                                 zbuf, idx, B, F, P, stream);
}
