// The argmin bodies of K3 (point_mesh.cu) and K8 (point_mesh_culled.cu),
// one design templated on the distance form, and of K7 (point_mesh_v2.cu)
// beside it, over the tables of argmin_setup.cuh.
//
// Function: for each point of a cloud, the nearest face among those its
// part admits (K8: among those the cull keeps, which always hold the
// nearest), the lowest face index of the least distance, written at the
// point's own index; a point that admits nothing gets (1e10, 0), or
// (1e10, fperm[0]) under K8, whose face ids come back in the caller's
// order.
//
// What bounds it on this card: operations.  At the FinetuneStage step's
// shape (128 clouds x 2048 points x 1554 faces) the function needs 2.4e8
// admissible pairs at 63 float operations each, ~0.22 ms at the 67 TFLOP/s
// float32 rate; the bytes take ~5 us.  A body of one point a thread spent
// ~6x that: a warp of 32 points of random parts ran the region math for
// nearly every face (a face was skipped only if all 32 lanes rejected it),
// and each pair re-read its face's constants from shared memory.
//
// Design:
//  * one block takes one tile: up to THREADS x R points of one part, in
//    the set-up's stable part order, so a warp never mixes parts and the
//    block walks only its part's face list (the joint clouds' ~280 faces
//    a part instead of 1554); a thread owns R consecutive points, so each
//    face row read from shared memory (as float4) serves R pairs, and a
//    warp whose points are all padding skips the math;
//  * the block is GROUPS groups of THREADS threads; each group holds the
//    tile's points and walks its own ascending segment of the list, and
//    the segments' minima are merged in order through shared memory.  A
//    full cloud's tile walks all 1554 faces: without the split (GROUPS =
//    1) its few blocks left ~2 warps a scheduler and the kernel was
//    latency-bound (PERF.md §6);
//  * a group gathers its segment's face rows (by list index, from the
//    per-cloud rows in L2) into shared memory kStageFaces / GROUPS faces at
//    a time, double buffered with cp.async, so the next stage loads while
//    this one runs;
//  * K8 first copies to shared memory the stretches of its part's list
//    that lie in chunks its tile's run word keeps (one uniform decision a
//    chunk), then walks them as K3 walks its list;
//  * faces go in ascending index with a strict '<', so the lowest index of
//    the least distance wins (K8: in the part order, as its plain
//    version); the grid holds maxT + 1 blocks a cloud, the block after the
//    last tile writes the points that admit nothing.
//
// Distance forms: K3 the divide-free 27 constants of point_tri27.cuh (the
// arithmetic K7 shares); K8 the TPU kernel's 16 constants with
// the closest point by region, where one __frcp_rn of the chosen region's
// denominator replaces the five IEEE divides of culled_sqdist (which
// computes every region's quotient): the distance moves by a few float32
// ulps of p.p + q.q, within K8's hold (1e-5 relative + 1e-6).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "argmin_setup.cuh"
#include "point_tri27.cuh"

namespace dsf_argmin {

constexpr int kStageFaces = 128;     // faces a block stages at a time

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

// K8's distance on a 16-float row c: a(0-2) ab(3-5) ac(6-8) | ab.a ac.a
// ab.b ac.b ab.c ac.c (9-14) | a.a (15); culled_sqdist's region cascade
// and final form, one reciprocal.
__device__ __forceinline__ float culled_sqdist16(const float* c, float px,
                                                 float py, float pz,
                                                 float pp) {
  const float ab_a = c[9], ac_a = c[10], ab_b = c[11], ac_b = c[12];
  const float ab_c = c[13], ac_c = c[14], aa = c[15];
  const float abab = ab_b - ab_a, acac = ac_c - ac_a, abac = ac_b - ac_a;
  const float s1 = px * c[3] + py * c[4] + pz * c[5];
  const float s2 = px * c[6] + py * c[7] + pz * c[8];
  const float pa = px * c[0] + py * c[1] + pz * c[2];
  const float d1 = s1 - ab_a, d2 = s2 - ac_a, d3 = s1 - ab_b;
  const float d4 = s2 - ac_b, d5 = s1 - ab_c, d6 = s2 - ac_c;
  const float vc = d1 * d4 - d3 * d2;
  const float vb = d5 * d2 - d1 * d6;
  const float va = d3 * d6 - d5 * d4;
  const bool on_bc = va <= 0.f && d4 - d3 >= 0.f && d5 - d6 >= 0.f;
  const bool on_ac = vb <= 0.f && d2 >= 0.f && d6 <= 0.f;
  const bool on_ab = vc <= 0.f && d1 >= 0.f && d3 <= 0.f;
  // the quotient the winning region needs, by culled_sqdist's precedence
  float num = vb, den = va + vb + vc;
  if (on_bc) {
    num = d4 - d3;
    den = (d4 - d3) + (d5 - d6);
  }
  if (on_ac) {
    num = d2;
    den = d2 - d6;
  }
  if (on_ab) {
    num = d1;
    den = d1 - d3;
  }
  const float inv = __frcp_rn(fabsf(den) < 1e-12f ? 1e-12f : den);
  const float qv = num * inv;
  float v = qv, w = vc * inv;
  if (on_bc) {
    w = clamp01(qv);
    v = 1.f - w;
  }
  if (on_ac) {
    w = clamp01(qv);
    v = 0.f;
  }
  if (on_ab) {
    v = clamp01(qv);
    w = 0.f;
  }
  if (d6 >= 0.f && d5 <= d6) { v = 0.f; w = 1.f; }
  if (d3 >= 0.f && d4 <= d3) { v = 1.f; w = 0.f; }
  if (d1 <= 0.f && d2 <= 0.f) { v = 0.f; w = 0.f; }
  const float qq = aa + v * (2.f * ab_a + v * abab)
                   + w * (2.f * ac_a + w * acac) + 2.f * v * w * abac;
  return fmaxf(pp - 2.f * (pa + v * s1 + w * s2) + qq, 0.f);
}

struct Form27 {                      // K3
  static constexpr int kRow4 = 7;
  static constexpr bool kCulled = false;
  __device__ static __forceinline__ float dist(const float* c, float px,
                                               float py, float pz, float pp) {
    return dsf_icp::region_sqdist27(c, px, py, pz, pp);
  }
};

struct Form16 {                      // K8
  static constexpr int kRow4 = 4;
  static constexpr bool kCulled = true;
  __device__ static __forceinline__ float dist(const float* c, float px,
                                               float py, float pz, float pp) {
    return culled_sqdist16(c, px, py, pz, pp);
  }
};

// The GROUPS segments' minima of a tile of THREADS x R points, merged in
// segment order with the strict '<' (the lowest position of the least
// distance wins, as one walk would give) into group 0's registers.
// Returns false in the threads of the other groups, which are done.
template <int THREADS, int R, int GROUPS>
__device__ __forceinline__ bool merge_groups(float (&best)[R], int (&arg)[R],
                                             int grp, int gt) {
  if constexpr (GROUPS > 1) {
    __shared__ float s_best[GROUPS - 1][THREADS * R];
    __shared__ int s_arg[GROUPS - 1][THREADS * R];
    if (grp > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s_best[grp - 1][gt * R + r] = best[r];
        s_arg[grp - 1][gt * R + r] = arg[r];
      }
    }
    __syncthreads();
    if (grp > 0) return false;
#pragma unroll
    for (int g = 0; g < GROUPS - 1; ++g) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = s_best[g][gt * R + r];
        if (d < best[r]) {
          best[r] = d;
          arg[r] = s_arg[g][gt * R + r];
        }
      }
    }
  }
  return true;
}

template <class Form, int THREADS, int R, int GROUPS>
__global__ void __launch_bounds__(THREADS * GROUPS)
argmin_kernel(const float* __restrict__ points,    // (N, P, 3)
              const float4* __restrict__ rows,     // (N, T, kRow4)
              const int32_t* __restrict__ lists,   // (Kp, T)
              const int32_t* __restrict__ lens,    // (Kp,)
              const int32_t* __restrict__ choff,   // (Kp, G + 1), K8
              const int32_t* __restrict__ fperm,   // (T,), K8
              const int32_t* __restrict__ perm,    // (N, P)
              const int4* __restrict__ tiles,      // (N, maxT, 4)
              const int32_t* __restrict__ tcount,  // (N, 2)
              float* __restrict__ dmin,            // (N, P)
              int32_t* __restrict__ imin,          // (N, P)
              int P, int T, int maxT) {
  constexpr int ROW4 = Form::kRow4;
  constexpr int BLOCK = THREADS * GROUPS;
  constexpr int STAGE = kStageFaces / GROUPS;   // faces a group stages
  __shared__ __align__(16) float4 s_rows[GROUPS][2][STAGE * ROW4];
  __shared__ int s_fid[GROUPS][2][STAGE];
  __shared__ int s_list[Form::kCulled ? kMaxChunks * kChunk : 1];
  __shared__ int s_seg[3][kMaxChunks];
  __shared__ int s_len;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int grp = tid / THREADS;                // the list segment it walks
  const int gt = tid - grp * THREADS;           // its points in the tile
  const int ntiles = tcount[2 * n];
  if (static_cast<int>(blockIdx.x) > ntiles) return;
  const int32_t* perm_n = perm + (size_t)n * P;
  if (static_cast<int>(blockIdx.x) == ntiles) {
    const int id0 = Form::kCulled ? fperm[0] : 0;
    for (int i = tcount[2 * n + 1] + tid; i < P; i += BLOCK) {
      const int p = perm_n[i];
      dmin[(size_t)n * P + p] = kInf;
      imin[(size_t)n * P + p] = id0;
    }
    return;
  }
  const int4 tile = tiles[(size_t)n * maxT + blockIdx.x];
  const int k = tile.x;

  // every group holds the tile's points: thread gt owns gt * R ... + R - 1
  float px[R], py[R], pz[R], pp[R], best[R];
  int arg[R], pid[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = gt * R + r;
    pid[r] = -1;
    px[r] = py[r] = pz[r] = 0.f;
    if (i < tile.z) {
      pid[r] = perm_n[tile.y + i];
      const float* q = points + ((size_t)n * P + pid[r]) * 3;
      px[r] = q[0];
      py[r] = q[1];
      pz[r] = q[2];
    }
    pp[r] = px[r] * px[r] + py[r] * py[r] + pz[r] * pz[r];
    best[r] = kInf;
    arg[r] = 0;
  }
  const bool warp_live = (gt & ~31) * R < tile.z;

  const int32_t* list;
  int len;
  if constexpr (Form::kCulled) {
    // the stretches of the part's list in chunks the run word keeps
    const int G = (T + kChunk - 1) / kChunk;
    if (tid < 32) {
      int lo = 0, m = 0;
      if (tid < G && ((static_cast<uint32_t>(tile.w) >> tid) & 1u)) {
        lo = choff[k * (G + 1) + tid];
        m = choff[k * (G + 1) + tid + 1] - lo;
      }
      int incl = m;
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      s_seg[0][tid] = lo;
      s_seg[1][tid] = incl - m;
      s_seg[2][tid] = m;
      if (tid == 31) s_len = incl;
    }
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      const int32_t* src = lists + (size_t)k * T + s_seg[0][g];
      for (int i = tid; i < s_seg[2][g]; i += BLOCK)
        s_list[s_seg[1][g] + i] = src[i];
    }
    __syncthreads();
    list = s_list;
    len = s_len;
  } else {
    list = lists + (size_t)k * T;
    len = lens[k];
  }
  // group grp walks list positions [lo, hi), ascending
  const int seg = (len + GROUPS - 1) / GROUPS;
  const int lo = min(len, grp * seg), hi = min(len, lo + seg);

  const float4* rows_n = rows + (size_t)n * T * ROW4;
  auto stage = [&](int buf, int base) {
    const int nf = max(0, min(STAGE, hi - base));
    for (int q = gt; q < nf * ROW4; q += THREADS) {
      const int f = q / ROW4;
      cp_async16(&s_rows[grp][buf][q],
                 rows_n + (size_t)list[base + f] * ROW4 + (q - f * ROW4));
    }
    for (int f = gt; f < nf; f += THREADS)
      s_fid[grp][buf][f] = list[base + f];
    cp_async_commit();
  };

  const int nstage = (seg + STAGE - 1) / STAGE;  // the same in every group
  if (nstage > 0) stage(0, lo);
  for (int st = 0; st < nstage; ++st) {
    const int buf = st & 1;
    if (st + 1 < nstage) {
      stage(buf ^ 1, lo + (st + 1) * STAGE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      const int nf = max(0, min(STAGE, hi - (lo + st * STAGE)));
      for (int f = 0; f < nf; ++f) {
        float c[ROW4 * 4];
#pragma unroll
        for (int q = 0; q < ROW4; ++q) {
          const float4 v = s_rows[grp][buf][f * ROW4 + q];
          c[4 * q] = v.x;
          c[4 * q + 1] = v.y;
          c[4 * q + 2] = v.z;
          c[4 * q + 3] = v.w;
        }
        const int fid = s_fid[grp][buf][f];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float d = Form::dist(c, px[r], py[r], pz[r], pp[r]);
          if (d < best[r]) {
            best[r] = d;
            arg[r] = fid;
          }
        }
      }
    }
    __syncthreads();
  }

  if (!merge_groups<THREADS, R, GROUPS>(best, arg, grp, gt)) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (pid[r] >= 0) {
      dmin[(size_t)n * P + pid[r]] = best[r];
      imin[(size_t)n * P + pid[r]] = Form::kCulled ? fperm[arg[r]] : arg[r];
    }
  }
}

// Launch the body over N clouds of P points and T faces: maxT + 1 blocks a
// cloud (the set-up's tiles, then the points that admit nothing), GROUPS
// groups of THREADS threads a block.
template <class Form, int THREADS, int R, int GROUPS>
int launch_argmin(const float* points, const float* rows,
                  const int32_t* lists, const int32_t* lens,
                  const int32_t* choff, const int32_t* fperm,
                  const int32_t* perm, const int32_t* tiles,
                  const int32_t* tcount, float* dmin, int32_t* imin, int N,
                  int P, int T, int maxT, void* stream) {
  const dim3 grid(maxT + 1, N);
  argmin_kernel<Form, THREADS, R, GROUPS>
      <<<grid, THREADS * GROUPS, 0, static_cast<cudaStream_t>(stream)>>>(
          points, reinterpret_cast<const float4*>(rows), lists, lens, choff,
          fperm, perm, reinterpret_cast<const int4*>(tiles), tcount, dmin,
          imin, P, T, maxT);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ K7

// K7's body.  Function: K3's, with K7's skip rule: a block takes one
// 128-point tile of a cloud in the caller's order (kV2Tile, the skip
// word's tile) and runs only the 128-face chunks (in fperm's part order)
// whose bit its skip word sets; each pair's admissibility is the point's
// part bit in the face's word; the lowest part-order index of the least
// distance wins, written as the caller's face id fperm[arg]; a point that
// admits nothing in the chunks its tile runs gets (1e10, fperm[0]), part
// order index 0 as in the plain version.
//
// Design, argmin_kernel's geometry on K7's tiles:
//  * GROUPS groups of THREADS threads, R points a thread (THREADS x R =
//    128): each group holds the whole tile and walks its own ascending
//    segment of the run chunks' faces, staged kStageFaces / GROUPS faces
//    at a time with cp.async (rows and words), double buffered; the
//    segments' minima merge in order (merge_groups);
//  * a face that no lane of a warp admits (its word AND the OR of the
//    warp's points' part bits is 0) costs the warp one test and no
//    distance; the skip is exact, as the face is inadmissible for every
//    lane.  The tiles are in the caller's order, so their warps mix parts
//    and most faces are admitted by some lane;
//  * SELECT: the distance of every pair the warp does not skip, with kInf
//    selected where the pair is inadmissible (no divergent branch); else a
//    branch per pair around the distance (scripts/argmin_shapes_gpu.py
//    times both).
template <int THREADS, int R, int GROUPS, bool SELECT>
__global__ void __launch_bounds__(THREADS * GROUPS)
argmin_v2_kernel(const float* __restrict__ points,    // (N, P, 3)
                 const float4* __restrict__ rows,     // (N, T, 7) fperm order
                 const int32_t* __restrict__ words,   // (T,) fperm order
                 const int32_t* __restrict__ parts,   // (N, P) in [0, 31]
                 const int32_t* __restrict__ skip,    // (N, NT)
                 const int32_t* __restrict__ fperm,   // (T,)
                 float* __restrict__ dmin,            // (N, P)
                 int32_t* __restrict__ imin,          // (N, P)
                 int P, int T) {
  constexpr int ROW4 = dsf_icp::kRow4;
  constexpr int STAGE = kStageFaces / GROUPS;   // faces a group stages
  static_assert(THREADS * R == kV2Tile, "a block holds one skip tile");
  static_assert(THREADS % 32 == 0, "groups of whole warps");
  __shared__ __align__(16) float4 s_rows[GROUPS][2][STAGE * ROW4];
  __shared__ uint32_t s_w[GROUPS][2][STAGE];
  __shared__ int s_fid[GROUPS][2][STAGE];
  __shared__ int s_ci[32];
  const int n = blockIdx.y;
  const int NT = gridDim.x;
  const int tid = threadIdx.x;
  const int grp = tid / THREADS;                // the segment it walks
  const int gt = tid - grp * THREADS;           // its points in the tile
  const uint32_t word =
      static_cast<uint32_t>(skip[(size_t)n * NT + blockIdx.x]);
  const int G = (T + kChunk - 1) / kChunk;
  if (tid < 32) {                               // the run chunks, in order
    const bool run = tid < G && ((word >> tid) & 1u);
    const unsigned bal = __ballot_sync(0xffffffffu, run);
    if (run) s_ci[__popc(bal & ((1u << tid) - 1u))] = tid;
  }
  // faces run: whole chunks, the last (ragged) one short
  const int len = __popc(word) * kChunk
                  - (((word >> (G - 1)) & 1u) ? G * kChunk - T : 0);

  float px[R], py[R], pz[R], pp[R], best[R];
  int arg[R], pid[R];
  uint32_t bit[R], mine = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = blockIdx.x * kV2Tile + gt * R + r;
    pid[r] = p < P ? p : -1;
    px[r] = py[r] = pz[r] = 0.f;
    bit[r] = 0u;                       // a padding point admits nothing
    if (p < P) {
      const float* q = points + ((size_t)n * P + p) * 3;
      px[r] = q[0];
      py[r] = q[1];
      pz[r] = q[2];
      bit[r] = 1u << (parts[(size_t)n * P + p] & 31);
    }
    pp[r] = px[r] * px[r] + py[r] * py[r] + pz[r] * pz[r];
    best[r] = kInf;
    arg[r] = 0;
    mine |= bit[r];
  }
  const uint32_t wor = __reduce_or_sync(0xffffffffu, mine);
  __syncthreads();                              // s_ci

  // group grp walks run positions [lo, hi), ascending; position q is face
  // s_ci[q / 128] * 128 + q % 128
  const int seg = (len + GROUPS - 1) / GROUPS;
  const int lo = min(len, grp * seg), hi = min(len, lo + seg);
  const float4* rows_n = rows + (size_t)n * T * ROW4;
  auto face_of = [&](int q) { return s_ci[q / kChunk] * kChunk + q % kChunk; };
  auto stage = [&](int buf, int base) {
    const int nf = max(0, min(STAGE, hi - base));
    for (int q = gt; q < nf * ROW4; q += THREADS) {
      const int f = q / ROW4;
      cp_async16(&s_rows[grp][buf][q],
                 rows_n + (size_t)face_of(base + f) * ROW4 + (q - f * ROW4));
    }
    for (int f = gt; f < nf; f += THREADS) {
      const int t = face_of(base + f);
      cp_async4(&s_w[grp][buf][f], words + t);
      s_fid[grp][buf][f] = t;
    }
    cp_async_commit();
  };

  const int nstage = (seg + STAGE - 1) / STAGE;  // the same in every group
  if (nstage > 0) stage(0, lo);
  for (int st = 0; st < nstage; ++st) {
    const int buf = st & 1;
    const int base = lo + st * STAGE;
    if (st + 1 < nstage) {
      stage(buf ^ 1, base + STAGE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int nf = max(0, min(STAGE, hi - base));
    for (int f = 0; f < nf; ++f) {
      const uint32_t fw = s_w[grp][buf][f];
      if (!(fw & wor)) continue;                // uniform over the warp
      float c[ROW4 * 4];
#pragma unroll
      for (int q = 0; q < ROW4; ++q) {
        const float4 v = s_rows[grp][buf][f * ROW4 + q];
        c[4 * q] = v.x;
        c[4 * q + 1] = v.y;
        c[4 * q + 2] = v.z;
        c[4 * q + 3] = v.w;
      }
      const int fid = s_fid[grp][buf][f];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (SELECT) {
          float d = dsf_icp::region_sqdist27(c, px[r], py[r], pz[r], pp[r]);
          d = (fw & bit[r]) ? d : kInf;
          if (d < best[r]) {
            best[r] = d;
            arg[r] = fid;
          }
        } else if (fw & bit[r]) {
          const float d =
              dsf_icp::region_sqdist27(c, px[r], py[r], pz[r], pp[r]);
          if (d < best[r]) {
            best[r] = d;
            arg[r] = fid;
          }
        }
      }
    }
    __syncthreads();
  }

  if (!merge_groups<THREADS, R, GROUPS>(best, arg, grp, gt)) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (pid[r] >= 0) {
      dmin[(size_t)n * P + pid[r]] = best[r];
      imin[(size_t)n * P + pid[r]] = fperm[arg[r]];
    }
  }
}

// Launch K7's body over N clouds of P points and T faces: one block per
// (cloud, 128-point tile), GROUPS groups of THREADS threads.
template <int THREADS, int R, int GROUPS, bool SELECT>
int launch_argmin_v2(const float* points, const float* rows,
                     const int32_t* words, const int32_t* parts,
                     const int32_t* skip, const int32_t* fperm, float* dmin,
                     int32_t* imin, int N, int P, int T, void* stream) {
  const dim3 grid((P + kV2Tile - 1) / kV2Tile, N);
  argmin_v2_kernel<THREADS, R, GROUPS, SELECT>
      <<<grid, THREADS * GROUPS, 0, static_cast<cudaStream_t>(stream)>>>(
          points, reinterpret_cast<const float4*>(rows), words, parts, skip,
          fperm, dmin, imin, P, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dsf_argmin
