// The per-face depth test of the raster kernels K1 (raster_skip.cu), K6
// (raster_dense.cu) and K10 (raster_binned.cu), in one place so that the
// three stay bitwise-equal to their common plain version
// (ops/rasterize.py:_depth_or_inf and scan_rows); and the culled scan that
// the three share (scan_culled).
//
// A face row is 16 floats (rasterize.face_rows): the three edge lines
// a*u + b*v + c (0-8), the depth line (9-11), the valid flag (12) and
// padding.  nvcc would contract a*u + b*v + c into an FMA; the plain
// version rounds each product and sum on its own, so the lines are
// evaluated with __fmul_rn / __fadd_rn in its order.
//
// The culls test each face's cover box (raster_setup.cuh:cover_box,
// rasterize.cover_boxes): a box that holds every sample at which the
// face's rounded edge test passes, bounded from its own coefficients.  A
// face whose cover box misses a block's samples covers none of them, so
// a cull needs no margin and cannot change the answer.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace dsf_raster {

constexpr int kRow = 16;             // floats per face row
constexpr float kInf = 1e10f;
constexpr int kCull = 256;           // faces a chunk box covers and the
                                     // set-up's block (raster_setup.cuh)
constexpr int kList = 2048;          // faces a block culls into one list

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

// The sample's result: (best, best_i), or (0, -1) where no face covers it.
__device__ __forceinline__ void store(float best, int best_i, float* zbuf,
                                      int32_t* idx, long long at) {
  const bool bg = !(best < kInf);
  zbuf[at] = bg ? 0.f : best;
  idx[at] = bg ? -1 : best_i;
}

// The shared memory of scan_culled for a block of kThreads threads.
template <int kThreads>
struct CullShared {
  int32_t list[kList];                  // the faces that passed, ascending
  float4 rows[kThreads * 4];            // a batch of their rows
  int32_t warp_n[kList / kThreads][kThreads / 32];
  float part[4][kThreads / 32];
};

__device__ __forceinline__ bool meets(float4 box, float umin, float umax,
                                      float vmin, float vmax) {
  return box.x <= umax && box.y >= umin && box.z <= vmax && box.w >= vmin;
}

// scan_culled's list beside its cull: every face (K1, K6, and K10 when a
// tile overflowed) ...
struct AnyFace {
  static constexpr bool kAll = true;
  __device__ __forceinline__ bool operator()(float4) const { return true; }
};

// ... or the faces whose screen box (vbox, raster_setup.cuh) meets `tile`
// = (umin, umax, vmin, vmax) inclusively, with no margin: K10's 16x16
// tile's list (rasterize.binned_tables).  A chunk box, the union of its
// faces' cover boxes, holds their screen boxes, so a chunk box that
// misses `tile` holds no listed face.
struct TileList {
  static constexpr bool kAll = false;
  const float4* vbox;
  float4 tile;
  __device__ __forceinline__ bool operator()(float4 b) const {
    return meets(b, tile.x, tile.y, tile.z, tile.w);
  }
};

// One block of kThreads threads, each with up to S samples (u[j], v[j];
// active[j] where the sample exists), against the faces of one image's F
// that `listed` passes: rows (F, 16), cover boxes (F) and the chunk boxes
// (ceil(F / kCull)) of raster_setup.cuh.  Leaves in (best[j], best_i[j])
// the least depth over those faces and the lowest face id at it:
// raster_scan's answer for AnyFace, the tile list's for TileList.
//
//  1. The block reduces the box of its own samples (a face whose cover
//     box misses it covers none of them).
//  2. It culls up to kList faces at a time into one list, kThreads faces a
//     step, one face a thread.  A chunk box that misses the block's box,
//     or `listed`'s, skips its steps for the whole block (one uniform
//     test, the chunk boxes read at once); otherwise each thread tests its
//     face's cover box and, for a TileList, its screen box, the next
//     step's boxes already in flight.  __ballot_sync, __popc and a
//     prefix over the warps' counts give each passing face a slot in
//     ascending face order.
//  3. The listed rows are gathered into shared memory kThreads at a time,
//     and each thread walks them for its S samples with nearer's strict
//     '<': faces come in ascending id order, so the lowest id at the least
//     depth wins.
// A block whose box meets no chunk reads no face box and no row.
template <int kThreads, int S, class List = AnyFace>
__device__ __forceinline__ void scan_culled(
    const float* __restrict__ rows, const float4* __restrict__ boxes,
    const float4* __restrict__ cbox, int F, const float (&u)[S],
    const float (&v)[S], const bool (&active)[S], int tid,
    CullShared<kThreads>& s, float (&best)[S], int (&best_i)[S],
    List listed = List()) {
  static_assert(kCull % kThreads == 0 && kThreads % 32 == 0, "block size");
  constexpr int kWarps = kThreads / 32;
  constexpr int kSteps = kList / kThreads;
  constexpr int kPerChunk = kCull / kThreads;    // steps a chunk box covers
  const int lane = tid & 31, warp = tid >> 5;
  const float4 none = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);

  float r0 = INFINITY, r1 = -INFINITY, r2 = INFINITY, r3 = -INFINITY;
  bool any = false;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    if (active[j]) {
      r0 = fminf(r0, u[j]);
      r1 = fmaxf(r1, u[j]);
      r2 = fminf(r2, v[j]);
      r3 = fmaxf(r3, v[j]);
      any = true;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    r0 = fminf(r0, __shfl_xor_sync(0xffffffffu, r0, off));
    r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, off));
    r2 = fminf(r2, __shfl_xor_sync(0xffffffffu, r2, off));
    r3 = fmaxf(r3, __shfl_xor_sync(0xffffffffu, r3, off));
  }
  if (lane == 0) {
    s.part[0][warp] = r0;
    s.part[1][warp] = r1;
    s.part[2][warp] = r2;
    s.part[3][warp] = r3;
  }
  __syncthreads();
  for (int k = 0; k < kWarps; ++k) {
    r0 = fminf(r0, s.part[0][k]);
    r1 = fmaxf(r1, s.part[1][k]);
    r2 = fminf(r2, s.part[2][k]);
    r3 = fmaxf(r3, s.part[3][k]);
  }
  const float umin = r0, umax = r1, vmin = r2, vmax = r3;

  for (int g0 = 0; g0 < F; g0 += kList) {
    // the chunk boxes of this pass that meet the block's box, a bit each
    const int c0 = g0 / kCull;
    const int ncb = min(kList / kCull, (F - g0 + kCull - 1) / kCull);
    unsigned cmask = 0;
#pragma unroll
    for (int k = 0; k < kList / kCull; ++k) {
      if (k < ncb) {
        const float4 cb = cbox[c0 + k];
        if (meets(cb, umin, umax, vmin, vmax) && listed(cb)) cmask |= 1u << k;
      }
    }
    if (cmask == 0) continue;                   // the same for every thread

    int n = 0;                                  // faces listed, uniform
    float4 next = none, vnext = none;
    if ((cmask & 1u) && g0 + tid < F) {
      next = boxes[g0 + tid];
      if constexpr (!List::kAll) vnext = listed.vbox[g0 + tid];
    }
    for (int k = 0; k < kSteps; ++k) {
      const float4 box = next, vb = vnext;
      const int f = g0 + k * kThreads + tid;
      next = none;
      if (k + 1 < kSteps && ((cmask >> ((k + 1) / kPerChunk)) & 1u) &&
          f + kThreads < F) {
        next = boxes[f + kThreads];
        if constexpr (!List::kAll) vnext = listed.vbox[f + kThreads];
      }
      if (!((cmask >> (k / kPerChunk)) & 1u)) continue;
      const bool pass =
          f < F && meets(box, umin, umax, vmin, vmax) && listed(vb);
      const unsigned m = __ballot_sync(0xffffffffu, pass);
      if (lane == 0) s.warp_n[k][warp] = __popc(m);
      __syncthreads();
      int slot = n;
      for (int w = 0; w < kWarps; ++w) {
        const int nw = s.warp_n[k][w];
        slot += w < warp ? nw : 0;
        n += nw;
      }
      if (pass) s.list[slot + __popc(m & ((1u << lane) - 1u))] = f;
    }
    __syncthreads();                            // the list is complete

    for (int b0 = 0; b0 < n; b0 += kThreads) {
      const int nb = min(kThreads, n - b0);
      if (tid < nb) {
        const float4* src =
            reinterpret_cast<const float4*>(rows) + (size_t)s.list[b0 + tid] * 4;
        const float4 q0 = src[0], q1 = src[1], q2 = src[2], q3 = src[3];
        s.rows[tid * 4 + 0] = q0;
        s.rows[tid * 4 + 1] = q1;
        s.rows[tid * 4 + 2] = q2;
        s.rows[tid * 4 + 3] = q3;
      }
      __syncthreads();                          // the batch is staged
      if (any) {
        for (int k = 0; k < nb; ++k) {
          const float* r = reinterpret_cast<const float*>(s.rows + k * 4);
          const int id = s.list[b0 + k];
#pragma unroll
          for (int j = 0; j < S; ++j) nearer(r, u[j], v[j], id, best[j], best_i[j]);
        }
      }
      __syncthreads();                          // the batch is walked
    }
  }
}

}  // namespace dsf_raster
