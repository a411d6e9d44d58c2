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
// A scatter keyed by face id is latency-bound long before that: a thread
// that walks pixels one at a time (load an id, then its row, then add)
// waits ~1 us a step.
//
// Design (the layout scripts/moments_shapes_gpu.py chose, PERF.md §6):
//  * the TPU kernel built a (tile, T) one-hot in VMEM and ran it through
//    the matrix unit in three bf16 passes; on this card the pixels are
//    read once, each lane's with 16-byte loads all issued before any add;
//  * the split CTAs of an image (one thread-block cluster) take
//    contiguous shares of its pixels; each warp keeps its own copy of the
//    image's 3T sums in shared memory (so T is at most
//    dsf_raster_moments_max_faces) and takes 32 units of 4 pixels a
//    round.  For each of the 4 pixel slots the lanes that hold one face
//    form a group (__match_any_sync), and the group's lowest lane adds the
//    group's rows in lane order to the warp's copy;
//  * the CTA adds its warps' copies in warp order; rank r of the cluster
//    adds the CTAs' totals of its share of the 3T sums in rank order
//    through distributed shared memory and writes each once.  No atomics,
//    no memset, fixed orders: two runs agree bitwise.  The sums differ
//    from a sequential scatter's to float32 rounding of the order.
//  * where P is not a multiple of 4 or a start is not 16-byte aligned,
//    every pixel is a unit of its own (4-byte loads).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dsf_moments {

namespace cg = cooperative_groups;

constexpr size_t kMaxSmem = 232448;   // the most a CTA may have on sm_90

// a lane's N pixels: their ids (-1 where the lane has none) and rows
template <int N>
struct Px {
  int id[N];
  float r[3 * N];
};

__device__ __forceinline__ void load_px(Px<4>& x, const int32_t* __restrict__ ib,
                                        const float* __restrict__ ub, int p) {
  const int4 t = __ldg(reinterpret_cast<const int4*>(ib + p));
  x.id[0] = t.x; x.id[1] = t.y; x.id[2] = t.z; x.id[3] = t.w;
  const float4* r = reinterpret_cast<const float4*>(ub + 3 * static_cast<size_t>(p));
  const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
  x.r[0] = a.x; x.r[1] = a.y; x.r[2] = a.z; x.r[3] = a.w;
  x.r[4] = b.x; x.r[5] = b.y; x.r[6] = b.z; x.r[7] = b.w;
  x.r[8] = c.x; x.r[9] = c.y; x.r[10] = c.z; x.r[11] = c.w;
}

__device__ __forceinline__ void load_px(Px<1>& x, const int32_t* __restrict__ ib,
                                        const float* __restrict__ ub, int p) {
  x.id[0] = __ldg(ib + p);
  const float* r = ub + 3 * static_cast<size_t>(p);
  x.r[0] = __ldg(r); x.r[1] = __ldg(r + 1); x.r[2] = __ldg(r + 2);
}

template <int N>
__device__ __forceinline__ void no_px(Px<N>& x) {
#pragma unroll
  for (int i = 0; i < N; ++i) x.id[i] = -1;
#pragma unroll
  for (int i = 0; i < 3 * N; ++i) x.r[i] = 0.f;
}

// one pixel a lane into the warp's copy acc (3T floats): the lanes of one
// face form a group, whose lowest lane adds the group's rows, staged in
// stage (3 x 32 floats), in lane order
__device__ __forceinline__ void add_slot(float* acc, float* stage, int f,
                                         bool valid, float r0, float r1,
                                         float r2, int lane) {
  const unsigned grp = __match_any_sync(0xffffffffu, valid ? f : -1);
  stage[lane] = r0;
  stage[32 + lane] = r1;
  stage[64 + lane] = r2;
  __syncwarp();
  if (valid && lane == __ffs(grp) - 1) {
    float* a = acc + 3 * f;
    float s0 = a[0], s1 = a[1], s2 = a[2];
    for (unsigned m = grp; m; m &= m - 1) {
      const int l = __ffs(m) - 1;
      s0 += stage[l];
      s1 += stage[32 + l];
      s2 += stage[64 + l];
    }
    a[0] = s0;
    a[1] = s1;
    a[2] = s2;
  }
  __syncwarp();
}

// floats of one warp's copy: 3T rounded up to a 16-byte multiple
__host__ __device__ inline int copy_floats(int T) { return (3 * T + 3) & ~3; }

template <int WARPS>
size_t smem_bytes(int T) {
  return (static_cast<size_t>(WARPS) * copy_floats(T) + WARPS * 96)
         * sizeof(float);
}

// this warp's units of rounds it .. it + U - 1 (lane `lane` of each)
template <int WARPS, int N, int U>
__device__ __forceinline__ void load_rounds(Px<N> (&x)[U],
                                            const int32_t* __restrict__ ib,
                                            const float* __restrict__ ub,
                                            int it, int rounds, int u0,
                                            int u1, int warp, int lane) {
#pragma unroll
  for (int q = 0; q < U; ++q) {
    const int un = u0 + ((it + q) * WARPS + warp) * 32 + lane;
    if (it + q < rounds && un < u1)
      load_px(x[q], ib, ub, un * N);
    else
      no_px(x[q]);
  }
}

// grid (split, B): the split CTAs of an image (a cluster when CLUSTER,
// else split is 1) take contiguous shares of its P / N units of N pixels;
// WARPS warps a CTA, each loading U rounds of 32 units a step (the first
// step's loads in flight while it zeroes its copy; with PF the next
// step's while it adds the current one).  Dynamic shared memory
// smem_bytes<WARPS>(T).
template <int WARPS, int N, int U, bool PF, bool CLUSTER>
__global__ void __launch_bounds__(WARPS * 32)
moments_kernel(const int32_t* __restrict__ idx,   // (B, P)
               const float* __restrict__ upd,     // (B, P, 3)
               float* __restrict__ out,           // (B, T, 3)
               int P, int T) {
  constexpr int kThreads = WARPS * 32;
  extern __shared__ __align__(16) float s_mem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n3 = 3 * T, stride = copy_floats(T);
  float* acc = s_mem + static_cast<size_t>(warp) * stride;
  float* stage = s_mem + static_cast<size_t>(WARPS) * stride + warp * 96;
  const int b = blockIdx.y, split = gridDim.x, rank = blockIdx.x;
  const int units = P / N;
  const int per = (units + split - 1) / split;
  const int u0 = rank * per, u1 = min(units, u0 + per);
  const int rounds = u1 > u0 ? (u1 - u0 + kThreads - 1) / kThreads : 0;
  const int32_t* ib = idx + static_cast<size_t>(b) * P;
  const float* ub = upd + static_cast<size_t>(b) * P * 3;

  Px<N> x[U];
  load_rounds<WARPS>(x, ib, ub, 0, rounds, u0, u1, warp, lane);
  float4* acc4 = reinterpret_cast<float4*>(acc);
  for (int i = lane; i < stride / 4; i += 32)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  for (int it = 0; it < rounds; it += U) {
    Px<N> nx[U];
    if constexpr (PF)
      load_rounds<WARPS>(nx, ib, ub, it + U, rounds, u0, u1, warp, lane);
#pragma unroll
    for (int q = 0; q < U; ++q)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int f = x[q].id[i];
        add_slot(acc, stage, f, static_cast<unsigned>(f) < static_cast<unsigned>(T),
                 x[q].r[3 * i], x[q].r[3 * i + 1], x[q].r[3 * i + 2], lane);
      }
    if constexpr (PF) {
#pragma unroll
      for (int q = 0; q < U; ++q) x[q] = nx[q];
    } else {
      load_rounds<WARPS>(x, ib, ub, it + U, rounds, u0, u1, warp, lane);
    }
  }
  __syncthreads();
  // the CTA's total in warp 0's copy, its warps added in warp order
  for (int c = threadIdx.x; c < n3; c += kThreads) {
    float s = s_mem[c];
    for (int w = 1; w < WARPS; ++w) s += s_mem[static_cast<size_t>(w) * stride + c];
    s_mem[c] = s;
  }
  float* ob = out + static_cast<size_t>(b) * n3;
  if constexpr (CLUSTER) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    const int share = (n3 + split - 1) / split;
    const int c1 = min(n3, (rank + 1) * share);
    for (int c = rank * share + threadIdx.x; c < c1; c += kThreads) {
      float s = cl.map_shared_rank(s_mem, 0)[c];
      for (int r = 1; r < split; ++r) s += cl.map_shared_rank(s_mem, r)[c];
      ob[c] = s;
    }
    cl.sync();                  // every CTA's total has been read
  } else {
    __syncthreads();
    for (int c = threadIdx.x; c < n3; c += kThreads) ob[c] = s_mem[c];
  }
}

// 16-byte units where P is a multiple of 4 and both starts are aligned
inline bool quads(const int32_t* idx, const float* upd, int P) {
  return P % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0
         && reinterpret_cast<uintptr_t>(upd) % 16 == 0;
}

template <int WARPS, int N, int U, bool PF>
int launch_n(const int32_t* idx, const float* upd, float* out, int B, int P,
             int T, int split, cudaStream_t st) {
  const size_t smem = smem_bytes<WARPS>(T);
  if (smem > kMaxSmem || split < 1 || split > 8 || B < 1 || P < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(split, B);
  if (split == 1) {
    auto* kern = moments_kernel<WARPS, N, U, PF, false>;
    // set on every launch: a flag cached in a template would be one object
    // across every library loaded with this instantiation
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, WARPS * 32, smem, st>>>(idx, upd, out, P, T);
    return static_cast<int>(cudaGetLastError());
  }
  auto* kern = moments_kernel<WARPS, N, U, PF, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, idx, upd, out, P, T);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// quads where they apply, else single pixels
template <int WARPS, int U, bool PF>
int launch(const int32_t* idx, const float* upd, float* out, int B, int P,
           int T, int split, cudaStream_t st) {
  if (quads(idx, upd, P))
    return launch_n<WARPS, 4, U, PF>(idx, upd, out, B, P, T, split, st);
  return launch_n<WARPS, 1, U, PF>(idx, upd, out, B, P, T, split, st);
}

template <int WARPS>
int max_faces() {
  int T = 1;
  while (smem_bytes<WARPS>(T + 1) <= kMaxSmem) ++T;
  return T;
}

}  // namespace dsf_moments

namespace {

// the library's layout, the fastest of scripts/moments_shapes_gpu.py's
constexpr int kWarps = 8, kRounds = 1, kSplit = 2;
constexpr bool kPrefetch = true;

}  // namespace

extern "C" int dsf_raster_moments(const int32_t* idx, const float* upd,
                                  float* out, int B, int P, int T,
                                  void* stream) {
  return dsf_moments::launch<kWarps, kRounds, kPrefetch>(
      idx, upd, out, B, P, T, kSplit, static_cast<cudaStream_t>(stream));
}

// the most faces a launch takes: every warp's copy of the 3T sums fits in
// one CTA's shared memory
extern "C" int dsf_raster_moments_max_faces() {
  return dsf_moments::max_faces<kWarps>();
}
