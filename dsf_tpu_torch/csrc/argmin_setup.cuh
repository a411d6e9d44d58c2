// The set-up of the point -> mesh argmin kernels K3 (point_mesh.cu), K8
// (point_mesh_culled.cu) and K7 (point_mesh_v2.cu), on the card.  It
// replaces a PyTorch set-up (ops/point_mesh_kernel.py:face_constants and
// part_words for K3; ops/point_mesh.py:culled_needed, culled_tables and
// face_constants16 for K8; ops/point_mesh.py:face_part_perm,
// face_constants, point_mesh._words_and_parts and
// point_mesh.v2_words for K7: a dozen to a few dozen small launches, 0.30,
// 0.78 and 1.28 ms at the FinetuneStage step's shape).  The plain versions
// of every table stay in ops/point_mesh.py and ops/point_mesh_kernel.py.
//
// Tables, all int32 unless said:
//  * rows: each (cloud, face)'s constants, face_constants' 28 floats (K3;
//    K7 in fperm's order) or face_constants16's 16 (K8, faces in part
//    order).  Every product, sum and reciprocal is rounded on its own, in
//    the plain version's order (__fmul_rn / __fadd_rn / __fsub_rn,
//    __frcp_rn for PyTorch's IEEE reciprocal), so the rows equal the plain
//    ones word for word;
//  * fperm (K7, K8): the faces in the stable order of their first
//    admissible part (point_mesh.face_part_perm);
//  * lists (Kp, T), lens (Kp,), choff (Kp, G + 1): for each column k of the
//    extended part table (column K admits nothing), the ascending face
//    indices it admits (in fperm's order for K8), -1 after lens[k]; choff
//    [k][g] is the list position where 128-face chunk g begins
//    (point_mesh.part_face_lists).  One warp a column: ballot, popc;
//  * key (N, P): each point's sort key, its part in [0, K] (K3) or part x
//    G + its nearest admissible chunk (K8); need (N, P) (K8): bit g set
//    when the chunk-g sphere bounds cannot rule out the point's nearest
//    admissible face (point_mesh.culled_needed, CULL_MARGIN);
//  * perm (N, P): the points of each cloud stably sorted by key (a
//    counting sort in shared memory: match_any and popc give each point
//    its rank among the equal keys before it, so it equals
//    torch.argsort(key, stable=True));
//  * tiles (N, maxT, 4): (part, first, count <= TP, run) over perm, no tile
//    mixing parts and none for part K; run is the OR of the tile's need
//    words (K8) or -1 (K3); zeros after the last tile.  tcount (N, 2): the
//    number of tiles and the first position of part K
//    (point_mesh.group_points_by_part);
//  * K7 (point_mesh.v2_tables_plain): words (T) each face's admissible
//    parts as bits in fperm's order (-1 without a table); cor (G) each
//    128-face chunk's OR of them; parts (N, P) each point's part in [0, K]
//    (0 without a table); skip (N, NT) one word per (cloud, 128-point tile
//    in the caller's order), bit g set when the OR of the tile's points'
//    part bits meets cor[g] (point_mesh.v2_words).  One warp a tile:
//    __reduce_or_sync, then a ballot over the chunks.
//
// Launches: K3 one (blocks take the rows, the lists or one cloud's
// grouping by their index); K8 two (the lists and the face order first,
// since the rows, the spheres and the keys read them); K7 two (the face
// order, its words and the chunk ORs; then the rows and the tiles).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace dsf_argmin {

constexpr int kSetupThreads = 512;   // threads of every set-up block
constexpr int kChunk = 128;          // faces per cull chunk and per choff step
constexpr int kMaxKeys = 32;         // K + 1 columns: a 32-bit part word
constexpr int kMaxChunks = 32;       // K8's G: a 32-bit need word
constexpr int kListStage = 2048;     // face words a list block stages
constexpr int kMaxTiles = 256;       // tiles per cloud
constexpr float kInf = 1e10f;
constexpr float kCullMargin = 1e-4f;  // point_mesh.CULL_MARGIN
constexpr int kV2Tile = 128;         // K7's points a skip word (its tile)

__device__ __forceinline__ float dot_rn(float x0, float x1, float x2,
                                       float y0, float y1, float y2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x1, y1)),
                   __fmul_rn(x2, y2));
}

// face_constants' row of the face (a, b, c): a ab ac n | ab.a ac.a ab.b
// ac.b ab.c ac.c | a.a b.b c.c | 1/ab.ab 1/ac.ac 1/bc.bc | bc.b n.a
// 1/max(n.n, 1e-12) | 0, with n = ab x ac.
__device__ __forceinline__ void row27(const float* v, float4* out) {
  const float a0 = v[0], a1 = v[1], a2 = v[2];
  const float b0 = v[3], b1 = v[4], b2 = v[5];
  const float c0 = v[6], c1 = v[7], c2 = v[8];
  const float ab0 = __fsub_rn(b0, a0), ab1 = __fsub_rn(b1, a1),
              ab2 = __fsub_rn(b2, a2);
  const float ac0 = __fsub_rn(c0, a0), ac1 = __fsub_rn(c1, a1),
              ac2 = __fsub_rn(c2, a2);
  const float bc0 = __fsub_rn(c0, b0), bc1 = __fsub_rn(c1, b1),
              bc2 = __fsub_rn(c2, b2);
  const float n0 = __fsub_rn(__fmul_rn(ab1, ac2), __fmul_rn(ab2, ac1));
  const float n1 = __fsub_rn(__fmul_rn(ab2, ac0), __fmul_rn(ab0, ac2));
  const float n2 = __fsub_rn(__fmul_rn(ab0, ac1), __fmul_rn(ab1, ac0));
  out[0] = make_float4(a0, a1, a2, ab0);
  out[1] = make_float4(ab1, ab2, ac0, ac1);
  out[2] = make_float4(ac2, n0, n1, n2);
  out[3] = make_float4(dot_rn(ab0, ab1, ab2, a0, a1, a2),
                       dot_rn(ac0, ac1, ac2, a0, a1, a2),
                       dot_rn(ab0, ab1, ab2, b0, b1, b2),
                       dot_rn(ac0, ac1, ac2, b0, b1, b2));
  out[4] = make_float4(dot_rn(ab0, ab1, ab2, c0, c1, c2),
                       dot_rn(ac0, ac1, ac2, c0, c1, c2),
                       dot_rn(a0, a1, a2, a0, a1, a2),
                       dot_rn(b0, b1, b2, b0, b1, b2));
  out[5] = make_float4(dot_rn(c0, c1, c2, c0, c1, c2),
                       __frcp_rn(dot_rn(ab0, ab1, ab2, ab0, ab1, ab2)),
                       __frcp_rn(dot_rn(ac0, ac1, ac2, ac0, ac1, ac2)),
                       __frcp_rn(dot_rn(bc0, bc1, bc2, bc0, bc1, bc2)));
  out[6] = make_float4(
      dot_rn(bc0, bc1, bc2, b0, b1, b2), dot_rn(n0, n1, n2, a0, a1, a2),
      __frcp_rn(fmaxf(dot_rn(n0, n1, n2, n0, n1, n2), 1e-12f)), 0.f);
}

// face_constants16's row: a ab ac | ab.a ac.a ab.b ac.b ab.c ac.c a.a.
__device__ __forceinline__ void row16(const float* v, float4* out) {
  const float a0 = v[0], a1 = v[1], a2 = v[2];
  const float b0 = v[3], b1 = v[4], b2 = v[5];
  const float c0 = v[6], c1 = v[7], c2 = v[8];
  const float ab0 = __fsub_rn(b0, a0), ab1 = __fsub_rn(b1, a1),
              ab2 = __fsub_rn(b2, a2);
  const float ac0 = __fsub_rn(c0, a0), ac1 = __fsub_rn(c1, a1),
              ac2 = __fsub_rn(c2, a2);
  out[0] = make_float4(a0, a1, a2, ab0);
  out[1] = make_float4(ab1, ab2, ac0, ac1);
  out[2] = make_float4(ac2, dot_rn(ab0, ab1, ab2, a0, a1, a2),
                       dot_rn(ac0, ac1, ac2, a0, a1, a2),
                       dot_rn(ab0, ab1, ab2, b0, b1, b2));
  out[3] = make_float4(dot_rn(ac0, ac1, ac2, b0, b1, b2),
                       dot_rn(ab0, ab1, ab2, c0, c1, c2),
                       dot_rn(ac0, ac1, ac2, c0, c1, c2),
                       dot_rn(a0, a1, a2, a0, a1, a2));
}

// ------------------------------------------------------ stable sort

// Stable counting sort of n keys in [0, nkeys), nkeys <= NK: out[pos] = i,
// pos = #(keys < key[i]) + #(j < i with key[j] == key[i]).  Each of NW
// warps counts, then places, one contiguous segment of the input (more
// warps, shorter chains of dependent loads); start[k] gets key k's first
// position, start[nkeys] = n.  The block (of at least NW warps) calls it
// together; key is read after a __syncthreads, so this block's own writes
// to it are seen.
template <int NK, int NW>
struct SortShared {
  int cnt[NW][NK];
  int start[NK + 1];
};

template <int NK, int NW>
__device__ void stable_sort(const int32_t* key, int n, int nkeys,
                            int32_t* out, SortShared<NK, NW>& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int i = tid; i < NW * NK; i += blockDim.x) (&s.cnt[0][0])[i] = 0;
  __syncthreads();
  const int seg = (n + NW - 1) / NW;
  const int lo = warp * seg, hi = min(n, lo + seg);
  if (warp < NW) {
    for (int b = lo; b < hi; b += 32) {
      const int i = b + lane;
      const bool live = i < hi;
      const unsigned act = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int k = key[i];
        const unsigned peers = __match_any_sync(act, k);
        if ((peers & lt) == 0u) s.cnt[warp][k] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive scan over (key, warp), key-major; lane L takes a run of keys
    const int per = (nkeys + 31) / 32;
    const int k0 = min(nkeys, lane * per), k1 = min(nkeys, k0 + per);
    int sum = 0;
    for (int k = k0; k < k1; ++k)
      for (int w = 0; w < NW; ++w) sum += s.cnt[w][k];
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - sum;
    for (int k = k0; k < k1; ++k) {
      s.start[k] = run;
      for (int w = 0; w < NW; ++w) {
        const int c = s.cnt[w][k];
        s.cnt[w][k] = run;
        run += c;
      }
    }
    if (lane == 31) s.start[nkeys] = incl;
  }
  __syncthreads();
  if (warp < NW) {
    for (int b = lo; b < hi; b += 32) {
      const int i = b + lane;
      const bool live = i < hi;
      const unsigned act = __ballot_sync(0xffffffffu, live);
      int k = 0;
      unsigned peers = 0u;
      if (live) {
        k = key[i];
        peers = __match_any_sync(act, k);
        out[s.cnt[warp][k] + __popc(peers & lt)] = i;
      }
      __syncwarp();
      if (live && (peers & lt) == 0u) s.cnt[warp][k] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
}

// ------------------------------------------------------ part lists

// Face t's admitted parts as bits into fword (T) (mask (T, K) uint8, or
// null for one part that admits every face); Sorted also sorts the faces
// by their first admitted part into fperm (fkey (T) scratch).  The block
// calls it together; it ends with a __syncthreads.
constexpr int kSortWarpsAll = kSetupThreads / 32;
constexpr int kSortWarpsCulled = 8;      // K8's sort: 8 x 1024 counters fit

template <bool Sorted>
__device__ void face_order(const uint8_t* mask, int K, int T, int32_t* fword,
                           int32_t* fkey, int32_t* fperm,
                           SortShared<kMaxKeys, kSortWarpsAll>& s) {
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    uint32_t w = 1u;
    if (mask != nullptr) {
      w = 0u;
      for (int k = 0; k < K; ++k) w |= (mask[(size_t)t * K + k] ? 1u : 0u) << k;
    }
    fword[t] = static_cast<int32_t>(w);
    if constexpr (Sorted) fkey[t] = w ? __ffs(w) - 1 : K;
  }
  if constexpr (Sorted) {
    stable_sort(fkey, T, K + 1, fperm, s);
  } else {
    __syncthreads();
  }
}

// One block: the extended table's lists (see the top), after face_order
// (Culled: the lists in fperm's order).  fword (T) is scratch.  The
// columns' walks read the words kListStage faces at a time from shared
// memory.
struct ListShared {
  SortShared<kMaxKeys, kSortWarpsAll> sort;
  uint32_t w[kListStage];
  int run[kMaxKeys];
};

template <bool Culled>
__device__ void build_lists(const uint8_t* mask, int K, int T,
                            int32_t* fword, int32_t* fkey, int32_t* fperm,
                            int32_t* lists, int32_t* lens, int32_t* choff,
                            ListShared& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int G = (T + kChunk - 1) / kChunk;
  if (tid < kMaxKeys) s.run[tid] = 0;
  face_order<Culled>(mask, K, T, fword, fkey, fperm, s.sort);
  const unsigned lt = (1u << lane) - 1u;
  for (int j0 = 0; j0 < T; j0 += kListStage) {
    const int nj = min(kListStage, T - j0);
    for (int i = tid; i < nj; i += blockDim.x)
      s.w[i] = static_cast<uint32_t>(fword[Culled ? fperm[j0 + i] : j0 + i]);
    __syncthreads();
    for (int k = warp; k <= K; k += nwarps) {
      int run = s.run[k];
      for (int i0 = 0; i0 < nj; i0 += 32) {
        const int i = i0 + lane;
        const bool adm = i < nj && k < K && ((s.w[i] >> k) & 1u);
        const unsigned bal = __ballot_sync(0xffffffffu, adm);
        if (lane == 0 && (j0 + i0) % kChunk == 0)
          choff[(size_t)k * (G + 1) + (j0 + i0) / kChunk] = run;
        if (adm) lists[(size_t)k * T + run + __popc(bal & lt)] = j0 + i;
        run += __popc(bal);
      }
      if (lane == 0) s.run[k] = run;
    }
    __syncthreads();
  }
  for (int k = warp; k <= K; k += nwarps) {
    const int run = s.run[k];
    if (lane == 0) {
      lens[k] = run;
      choff[(size_t)k * (G + 1) + G] = run;
    }
    for (int i = run + lane; i < T; i += 32) lists[(size_t)k * T + i] = -1;
  }
}

// ------------------------------------------------------ face rows

// The rows of faces [j0, j0 + blockDim) of cloud n (face j is fperm[j]
// where fperm is given, else j): face_constants16's (Row16) or
// face_constants' (else).
template <bool Row16>
__device__ void build_rows(int n, int j0, const float* tris,
                           const int32_t* fperm, float4* rows, int T) {
  const int j = j0 + threadIdx.x;
  if (j >= T) return;
  const int t = fperm != nullptr ? fperm[j] : j;
  float v[9];
  const float* src = tris + ((size_t)n * T + t) * 9;
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = src[i];
  if (Row16) {
    row16(v, rows + ((size_t)n * T + j) * 4);
  } else {
    row27(v, rows + ((size_t)n * T + j) * 7);
  }
}

// ------------------------------------------------------ point grouping

template <int NK, int NW>
struct GroupShared {
  SortShared<NK, NW> sort;
  float4 sph[kMaxChunks];
  uint32_t cw[kMaxKeys];
  int pstart[kMaxKeys + 1];
  int toff[kMaxKeys + 1];
  int run[kMaxTiles];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// K8's bounding sphere of chunk g of cloud n (faces in fperm's order),
// one warp: the mean of its faces' centroids and the largest distance
// from it to a centroid plus that face's radius (culled_needed's).
__device__ void chunk_sphere(int n, int g, const float* tris,
                             const int32_t* fperm, int T, float4* out) {
  const int lane = threadIdx.x & 31;
  float cx[kChunk / 32], cy[kChunk / 32], cz[kChunk / 32], fr[kChunk / 32];
  float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
  for (int q = 0; q < kChunk / 32; ++q) {
    const int j = g * kChunk + q * 32 + lane;
    cx[q] = cy[q] = cz[q] = 0.f;
    fr[q] = -1.f;                       // a pad face
    if (j < T) {
      const float* v = tris + ((size_t)n * T + fperm[j]) * 9;
      const float third = 1.f / 3.f;
      cx[q] = __fmul_rn(__fadd_rn(__fadd_rn(v[0], v[3]), v[6]), third);
      cy[q] = __fmul_rn(__fadd_rn(__fadd_rn(v[1], v[4]), v[7]), third);
      cz[q] = __fmul_rn(__fadd_rn(__fadd_rn(v[2], v[5]), v[8]), third);
      float m = 0.f;
      for (int i = 0; i < 3; ++i) {
        const float dx = __fsub_rn(v[3 * i], cx[q]);
        const float dy = __fsub_rn(v[3 * i + 1], cy[q]);
        const float dz = __fsub_rn(v[3 * i + 2], cz[q]);
        m = fmaxf(m, dot_rn(dx, dy, dz, dx, dy, dz));
      }
      fr[q] = sqrtf(__fadd_rn(m, 1e-20f));
      sx += cx[q];
      sy += cy[q];
      sz += cz[q];
    }
  }
  const float nreal = static_cast<float>(min(kChunk, T - g * kChunk));
  const float mx = warp_sum(sx) / nreal;
  const float my = warp_sum(sy) / nreal;
  const float mz = warp_sum(sz) / nreal;
  float r = 0.f;
#pragma unroll
  for (int q = 0; q < kChunk / 32; ++q) {
    if (fr[q] >= 0.f) {
      const float dx = __fsub_rn(cx[q], mx), dy = __fsub_rn(cy[q], my),
                  dz = __fsub_rn(cz[q], mz);
      r = fmaxf(r, __fadd_rn(sqrtf(__fadd_rn(dot_rn(dx, dy, dz, dx, dy, dz),
                                              1e-20f)),
                             fr[q]));
    }
  }
  r = warp_max(r);
  if (lane == 0) *out = make_float4(mx, my, mz, r);
}

// One block per cloud n: keys (and need words), the stable order, the
// tiles.  parts (N, P) int64 or null (every point part 0); K parts, G
// chunks (1 without Culled), TP points a tile.  Culled reads the lists'
// chunk offsets (choff) and builds the chunk spheres from tris and fperm.
template <int NK, int NW, bool Culled>
__device__ void group_cloud(int n, const float* points, const int64_t* parts,
                            const float* tris, const int32_t* fperm,
                            const int32_t* choff, int K, int P, int T, int G,
                            int TP, int maxT, int32_t* key, int32_t* need,
                            int32_t* perm, int4* tiles, int32_t* tcount,
                            GroupShared<NK, NW>& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  int32_t* key_n = key + (size_t)n * P;
  int32_t* need_n = Culled ? need + (size_t)n * P : nullptr;
  int32_t* perm_n = perm + (size_t)n * P;
  if (Culled) {
    for (int g = warp; g < G; g += nwarps)
      chunk_sphere(n, g, tris, fperm, T, &s.sph[g]);
    if (tid <= K) {
      uint32_t w = 0u;
      for (int g = 0; g < G; ++g)
        w |= (choff[tid * (G + 1) + g + 1] > choff[tid * (G + 1) + g] ? 1u
                                                                      : 0u)
             << g;
      s.cw[tid] = w;
    }
    __syncthreads();
  }
  for (int p = tid; p < P; p += blockDim.x) {
    int pp = 0;
    if (parts != nullptr) {
      const int64_t q = parts[(size_t)n * P + p];
      pp = (q >= 0 && q < K) ? static_cast<int>(q) : K;
    }
    if (!Culled) {
      key_n[p] = pp;
      continue;
    }
    const float* x = points + ((size_t)n * P + p) * 3;
    const float px = x[0], py = x[1], pz = x[2];
    const uint32_t cw = s.cw[pp];
    float ub = kInf, nearest = kInf;
    int near = 0;
    for (int g = 0; g < G; ++g) {
      const float4 c = s.sph[g];
      const float dx = __fsub_rn(px, c.x), dy = __fsub_rn(py, c.y),
                  dz = __fsub_rn(pz, c.z);
      const float dpc = sqrtf(__fadd_rn(dot_rn(dx, dy, dz, dx, dy, dz),
                                        1e-20f));
      if ((cw >> g) & 1u) {
        const float u = __fadd_rn(__fadd_rn(dpc, c.w), kCullMargin);
        ub = fminf(ub, __fmul_rn(u, u));
        if (dpc < nearest) {
          nearest = dpc;
          near = g;
        }
      }
    }
    uint32_t nd = 0u;
    for (int g = 0; g < G; ++g) {
      if (!((cw >> g) & 1u)) continue;
      const float4 c = s.sph[g];
      const float dx = __fsub_rn(px, c.x), dy = __fsub_rn(py, c.y),
                  dz = __fsub_rn(pz, c.z);
      const float dpc = sqrtf(__fadd_rn(dot_rn(dx, dy, dz, dx, dy, dz),
                                        1e-20f));
      const float l = fmaxf(__fsub_rn(__fsub_rn(dpc, c.w), kCullMargin), 0.f);
      if (__fmul_rn(l, l) <= ub) nd |= 1u << g;
    }
    key_n[p] = pp * G + near;
    need_n[p] = static_cast<int32_t>(nd);
  }
  __syncthreads();
  stable_sort(key_n, P, (K + 1) * G, perm_n, s.sort);
  if (warp == 0) {
    int cnt = 0;
    if (lane < K) {
      s.pstart[lane] = s.sort.start[lane * G];
      cnt = s.sort.start[(lane + 1) * G] - s.sort.start[lane * G];
    }
    const int nt = (cnt + TP - 1) / TP;
    int incl = nt;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane < K) s.toff[lane] = incl - nt;
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (lane == 0) {
      s.toff[K] = total;
      s.pstart[K] = s.sort.start[K * G];
      tcount[2 * n] = total;
      tcount[2 * n + 1] = s.sort.start[K * G];
    }
  }
  for (int t = tid; t < maxT; t += blockDim.x) s.run[t] = 0;
  __syncthreads();
  if (Culled) {
    for (int i = tid; i < s.pstart[K]; i += blockDim.x) {
      int k = 0;
      while (k + 1 < K && s.pstart[k + 1] <= i) ++k;
      atomicOr(&s.run[s.toff[k] + (i - s.pstart[k]) / TP],
               need_n[perm_n[i]]);
    }
    __syncthreads();
  }
  const int ntiles = s.toff[K];
  for (int t = tid; t < maxT; t += blockDim.x) {
    int4 e = make_int4(0, 0, 0, 0);
    if (t < ntiles) {
      int k = 0;
      while (k + 1 < K && s.toff[k + 1] <= t) ++k;
      const int first = s.pstart[k] + (t - s.toff[k]) * TP;
      e = make_int4(k, first, min(TP, s.pstart[k + 1] - first),
                    Culled ? s.run[t] : -1);
    }
    tiles[(size_t)n * maxT + t] = e;
  }
}

// ------------------------------------------------------ the kernels

// K3: block n < N cloud n's grouping, block N the lists, the blocks after
// it the rows (kSetupThreads faces each, over clouds): the long blocks
// first, so that they start at once.
__global__ void __launch_bounds__(kSetupThreads)
setup27_kernel(const float* __restrict__ points, const float* __restrict__ tris,
               const uint8_t* __restrict__ mask,
               const int64_t* __restrict__ parts, float4* __restrict__ rows,
               int32_t* fword, int32_t* lists, int32_t* lens, int32_t* choff,
               int32_t* key, int32_t* perm, int4* tiles, int32_t* tcount,
               int N, int P, int T, int K, int TP, int maxT) {
  __shared__ union {
    GroupShared<kMaxKeys, kSortWarpsAll> group;
    ListShared list;
  } s;
  const int per_cloud = (T + kSetupThreads - 1) / kSetupThreads;
  const int b = blockIdx.x;
  if (b < N) {
    group_cloud<kMaxKeys, kSortWarpsAll, false>(
        b, points, parts, nullptr, nullptr, nullptr, K, P, T, 1, TP, maxT,
        key, nullptr, perm, tiles, tcount, s.group);
  } else if (b == N) {
    build_lists<false>(mask, K, T, fword, nullptr, nullptr, lists, lens,
                       choff, s.list);
  } else {
    const int r = b - N - 1;
    build_rows<false>(r / per_cloud, (r % per_cloud) * kSetupThreads, tris,
                      nullptr, rows, T);
  }
}

// K8, first launch: the face order and the lists.
__global__ void __launch_bounds__(kSetupThreads)
lists16_kernel(const uint8_t* __restrict__ mask, int32_t* fword,
               int32_t* fkey, int32_t* fperm, int32_t* lists, int32_t* lens,
               int32_t* choff, int K, int T) {
  __shared__ ListShared s;
  build_lists<true>(mask, K, T, fword, fkey, fperm, lists, lens, choff, s);
}

// K8, second launch: block n < N cloud n's spheres, keys, need words and
// grouping, the blocks after them the rows in fperm's order.
__global__ void __launch_bounds__(kSetupThreads)
setup16_kernel(const float* __restrict__ points, const float* __restrict__ tris,
               const int64_t* __restrict__ parts,
               const int32_t* __restrict__ fperm,
               const int32_t* __restrict__ choff, float4* __restrict__ rows,
               int32_t* key, int32_t* need, int32_t* perm, int4* tiles,
               int32_t* tcount, int N, int P, int T, int K, int TP,
               int maxT) {
  __shared__ GroupShared<kMaxKeys * kMaxChunks, kSortWarpsCulled> s;
  const int per_cloud = (T + kSetupThreads - 1) / kSetupThreads;
  const int b = blockIdx.x;
  if (b < N) {
    const int G = (T + kChunk - 1) / kChunk;
    group_cloud<kMaxKeys * kMaxChunks, kSortWarpsCulled, true>(
        b, points, parts, tris, fperm, choff, K, P, T, G, TP, maxT, key,
        need, perm, tiles, tcount, s);
  } else {
    const int r = b - N;
    build_rows<true>(r / per_cloud, (r % per_cloud) * kSetupThreads, tris,
                     fperm, rows, T);
  }
}

// K7, first launch, one block: the face order (face_order), each face's
// word in that order (-1 without a table) and each 128-face chunk's OR
// of them, one warp a chunk.
__global__ void __launch_bounds__(kSetupThreads)
v2_faces_kernel(const uint8_t* __restrict__ mask, int32_t* fword,
                int32_t* fkey, int32_t* fperm, int32_t* __restrict__ words,
                int32_t* __restrict__ cor, int K, int T) {
  __shared__ SortShared<kMaxKeys, kSortWarpsAll> s;
  face_order<true>(mask, K, T, fword, fkey, fperm, s);
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int G = (T + kChunk - 1) / kChunk;
  for (int g = threadIdx.x >> 5; g < G; g += nwarps) {
    uint32_t o = 0u;
#pragma unroll
    for (int q = 0; q < kChunk / 32; ++q) {
      const int j = g * kChunk + q * 32 + lane;
      if (j < T) {
        const uint32_t w =
            mask != nullptr ? static_cast<uint32_t>(fword[fperm[j]]) : ~0u;
        words[j] = static_cast<int32_t>(w);
        o |= w;
      }
    }
    o = __reduce_or_sync(0xffffffffu, o);
    if (lane == 0) cor[g] = static_cast<int32_t>(o);
  }
}

// K7, second launch: the blocks [0, nrow) the rows in fperm's order, the
// blocks after them the (cloud, 128-point tile)s, one warp each: the
// points' parts in [0, K] (parts (N, P) int64, or null: part 0) and the
// tile's skip word.  A padding point admits nothing.
__global__ void __launch_bounds__(kSetupThreads)
v2_setup_kernel(const float* __restrict__ tris,
                const int64_t* __restrict__ parts,
                const int32_t* __restrict__ fperm,
                const int32_t* __restrict__ cor, float4* __restrict__ rows,
                int32_t* __restrict__ parts32, int32_t* __restrict__ skip,
                int N, int P, int T, int K) {
  const int per_cloud = (T + kSetupThreads - 1) / kSetupThreads;
  const int nrow = N * per_cloud;
  const int b = blockIdx.x;
  if (b < nrow) {
    build_rows<false>(b / per_cloud, (b % per_cloud) * kSetupThreads, tris,
                      fperm, rows, T);
    return;
  }
  const int NT = (P + kV2Tile - 1) / kV2Tile;
  const int lane = threadIdx.x & 31;
  const int tile = (b - nrow) * (kSetupThreads / 32) + (threadIdx.x >> 5);
  if (tile >= N * NT) return;             // uniform over the warp
  const int n = tile / NT, ti = tile - n * NT;
  uint32_t o = 0u;
#pragma unroll
  for (int q = 0; q < kV2Tile / 32; ++q) {
    const int p = ti * kV2Tile + q * 32 + lane;
    if (p < P) {
      int pp = 0;
      if (parts != nullptr) {
        const int64_t v = parts[(size_t)n * P + p];
        pp = (v >= 0 && v < K) ? static_cast<int>(v) : K;
      }
      parts32[(size_t)n * P + p] = pp;
      o |= 1u << pp;
    }
  }
  o = __reduce_or_sync(0xffffffffu, o);
  const int G = (T + kChunk - 1) / kChunk;
  const bool hit = lane < G && (o & static_cast<uint32_t>(cor[lane])) != 0u;
  const uint32_t word = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) skip[tile] = static_cast<int32_t>(word);
}

inline int launch_setup27(const float* points, const float* tris,
                          const uint8_t* mask, const int64_t* parts,
                          float* rows, int32_t* fword, int32_t* lists,
                          int32_t* lens, int32_t* choff, int32_t* key,
                          int32_t* perm, int32_t* tiles, int32_t* tcount,
                          int N, int P, int T, int K, int TP, int maxT,
                          void* stream) {
  const int nrow = N * ((T + kSetupThreads - 1) / kSetupThreads);
  setup27_kernel<<<nrow + 1 + N, kSetupThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      points, tris, mask, parts, reinterpret_cast<float4*>(rows), fword,
      lists, lens, choff, key, perm, reinterpret_cast<int4*>(tiles), tcount,
      N, P, T, K, TP, maxT);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_setup16(const float* points, const float* tris,
                          const uint8_t* mask, const int64_t* parts,
                          float* rows, int32_t* fword, int32_t* fkey,
                          int32_t* fperm, int32_t* lists, int32_t* lens,
                          int32_t* choff, int32_t* key, int32_t* need,
                          int32_t* perm, int32_t* tiles, int32_t* tcount,
                          int N, int P, int T, int K, int TP, int maxT,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  lists16_kernel<<<1, kSetupThreads, 0, st>>>(mask, fword, fkey, fperm,
                                              lists, lens, choff, K, T);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int nrow = N * ((T + kSetupThreads - 1) / kSetupThreads);
  setup16_kernel<<<nrow + N, kSetupThreads, 0, st>>>(
      points, tris, parts, fperm, choff, reinterpret_cast<float4*>(rows),
      key, need, perm, reinterpret_cast<int4*>(tiles), tcount, N, P, T, K,
      TP, maxT);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_setup_v2(const float* tris, const uint8_t* mask,
                           const int64_t* parts, float* rows, int32_t* fword,
                           int32_t* fkey, int32_t* fperm, int32_t* words,
                           int32_t* cor, int32_t* parts32, int32_t* skip,
                           int N, int P, int T, int K, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  v2_faces_kernel<<<1, kSetupThreads, 0, st>>>(mask, fword, fkey, fperm,
                                               words, cor, K, T);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int nrow = N * ((T + kSetupThreads - 1) / kSetupThreads);
  const int ntile = N * ((P + kV2Tile - 1) / kV2Tile);
  const int warps = kSetupThreads / 32;
  v2_setup_kernel<<<nrow + (ntile + warps - 1) / warps, kSetupThreads, 0,
                    st>>>(tris, parts, fperm, cor,
                          reinterpret_cast<float4*>(rows), parts32, skip, N,
                          P, T, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dsf_argmin
