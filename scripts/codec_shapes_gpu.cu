// Candidate layouts of K4 and of K5 bwd that scripts/codec_shapes_gpu.py
// times beside the library's own.  The library's source is included whole;
// this adds what the library does not run:
//  * the forward's CTA states written to device memory and merged by a
//    second kernel, instead of a thread-block cluster;
//  * the VJP with the loads of JU joints issued before their use, and
//    (STAGE) each joint's 6 constants staged in shared memory behind the
//    first barrier instead of read with the loads;
//  * every pixel loaded alone (4-byte loads) instead of 16-byte units.
//  * the encode VJP with its joint lanes inside a warp (d depth summed by
//    shuffles, no barrier in the loop) instead of across the CTA, and the
//    library's layout with each thread's next unit copied into shared
//    memory by cp.async while it works on the current one.
// fwd_candidate and bwd_candidate take any of them, and
// dsf_encode::bwd_candidate any layout of the encode VJP (joint lanes,
// joints a lane, warps or units a CTA, CTAs an image, 16- or 4-byte
// loads); the script adds one extern "C" instantiation of each layout and
// builds it with the library's flags.

#include "../dsf_tpu_torch/csrc/codec.cu"

namespace dsf_decode {

// grid (split, J, B): each CTA's state into part (B, J, split, 5)
template <int THREADS, int U>
__global__ void __launch_bounds__(THREADS)
decode_part_kernel(const float* __restrict__ x,
                   const float* __restrict__ depth, float* __restrict__ part,
                   int J, int S, float k, float scale, int h, int nq) {
  extern __shared__ float s_coord[];
  __shared__ Soft s_warp[THREADS / 32];
  const int j = blockIdx.y, b = blockIdx.z;
  const Soft a = cta_state<THREADS, U>(x, depth, s_coord, s_warp, j, b, J,
                                       S, k, scale, h, nq);
  if (threadIdx.x == 0) {
    float* o = part + ((static_cast<size_t>(b) * J + j) * gridDim.x
                       + blockIdx.x) * 5;
    o[0] = a.m; o[1] = a.z; o[2] = a.sx; o[3] = a.sy; o[4] = a.sz;
  }
}

// one thread a row: its split states merged in CTA order
__global__ void decode_merge_kernel(const float* __restrict__ part,
                                    float* __restrict__ y,
                                    float* __restrict__ stats, int rows,
                                    int split) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* pr = part + static_cast<size_t>(r) * split * 5;
  Soft a = {pr[0], pr[1], pr[2], pr[3], pr[4]};
  for (int c = 1; c < split; ++c) {
    const float* q = pr + 5 * c;
    merge(a, Soft{q[0], q[1], q[2], q[3], q[4]});
  }
  finish(a, y, stats, r);
}

// the VJP's pixels with JU joints' loads issued before their use
template <int N, int JL, int JU, bool STAGE>
__device__ __forceinline__ void bwd_pixels_unrolled(
    float (&acc)[4], const float* __restrict__ xb, float* __restrict__ dxb,
    const float* __restrict__ db, const float* s_coord, const float* s_row,
    const float* __restrict__ sb, const float* __restrict__ gb,
    const float* __restrict__ yb, int p, int jl, int J, int S, float k,
    float scale) {
  const int P = S * S;
  Base<N> px;
  base_load(px, db, s_coord, p, S);
  for (int j0 = jl; j0 < J; j0 += JL * JU) {
    Field<N> f[JU];
    Row rw[JU];
#pragma unroll
    for (int r = 0; r < JU; ++r) {
      const int j = j0 + r * JL;
      if (j < J) {
        field_load(f[r], xb, p, j, J, P);
        if constexpr (STAGE) {
          const float* t = s_row + 6 * j;
          rw[r] = Row{t[0], t[1], t[2], t[3], t[4], t[5]};
        } else {
          rw[r] = row_of(j, sb, gb, yb);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < JU; ++r) {
      const int j = j0 + r * JL;
      if (j >= J) break;
      joint_grad(acc, px, f[r], rw[r], dxb, p, j, J, P, k, scale);
    }
  }
}

// decode_bwd_kernel's grid and threads; dynamic shared memory S (+ 6J
// with STAGE) + (JL - 1) PT 4 floats
template <int PT, int JL, int JU, bool STAGE>
__global__ void __launch_bounds__(PT * JL)
decode_bwd_unrolled_kernel(const float* __restrict__ x,
                           const float* __restrict__ depth,
                           const float* __restrict__ g,
                           const float* __restrict__ y,
                           const float* __restrict__ stats,
                           float* __restrict__ dx, float* __restrict__ dd,
                           int J, int S, float k, float scale, int h,
                           int nq) {
  extern __shared__ float s_mem[];
  float* s_coord = s_mem;
  float* s_row = s_mem + S;
  float* s_dd = s_row + (STAGE ? 6 * J : 0);
  const int b = blockIdx.y, P = S * S;
  const float* sb = stats + static_cast<size_t>(b) * J * 2;
  const float* gb = g + static_cast<size_t>(b) * J * 3;
  const float* yb = y + static_cast<size_t>(b) * J * 3;
  for (int i = threadIdx.x; i < S; i += PT * JL) s_coord[i] = pix_coord(i, S);
  if constexpr (STAGE) {
    for (int j = threadIdx.x; j < J; j += PT * JL) {
      const Row r = row_of(j, sb, gb, yb);
      float* o = s_row + 6 * j;
      o[0] = r.m; o[1] = r.z; o[2] = r.gx; o[3] = r.gy; o[4] = r.gz;
      o[5] = r.A;
    }
  }
  __syncthreads();
  const int pt = threadIdx.x % PT, jl = threadIdx.x / PT;
  const int un = blockIdx.x * PT + pt;
  const size_t off = static_cast<size_t>(b) * 4 * J * P;
  const float* db = depth + static_cast<size_t>(b) * P;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int p = 0, n = 0;
  if (un < nq) {
    p = h + 4 * un;
    n = 4;
    bwd_pixels_unrolled<4, JL, JU, STAGE>(acc, x + off, dx + off, db,
                                          s_coord, s_row, sb, gb, yb, p, jl,
                                          J, S, k, scale);
  } else if (un < P - 3 * nq) {
    p = single_pixel(un - nq, h, nq);
    n = 1;
    bwd_pixels_unrolled<1, JL, JU, STAGE>(acc, x + off, dx + off, db,
                                          s_coord, s_row, sb, gb, yb, p, jl,
                                          J, S, k, scale);
  }
  lane_sum<PT, JL>(acc, s_dd, pt, jl);
  if (jl == 0)
    for (int i = 0; i < n; ++i) dd[static_cast<size_t>(b) * P + p + i] = acc[i];
}

// the library's unit plan (vec), or every pixel single
inline void plan(int P, int vec, const void* const* ptrs, int n, int* h,
                 int* nq) {
  if (vec) {
    plan_units(P, ptrs, n, h, nq);
  } else {
    *h = 0;
    *nq = 0;
  }
}

// TWO: merged by decode_merge_kernel from part (B * J * split * 5 floats),
// else the library's fwd_launch (a cluster where split > 1)
template <int THREADS, int U, bool TWO>
int fwd_candidate(const float* x, const float* depth, float* y, float* stats,
                  float* part, int B, int J, int S, int split, int vec,
                  float k, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[2] = {x, depth};
  int h, nq;
  plan(S * S, vec, ptrs, 2, &h, &nq);
  if constexpr (!TWO) {
    return fwd_launch<THREADS, U>(x, depth, y, stats, B, J, S, split, k,
                                  scale, h, nq, st);
  } else {
    decode_part_kernel<THREADS, U><<<dim3(split, J, B), THREADS,
                                     S * sizeof(float), st>>>(
        x, depth, part, J, S, k, scale, h, nq);
    decode_merge_kernel<<<(B * J + 127) / 128, 128, 0, st>>>(part, y, stats,
                                                             B * J, split);
    return static_cast<int>(cudaGetLastError());
  }
}

// JU 1 without STAGE is the library's bwd_launch
template <int PT, int JL, int JU, bool STAGE>
int bwd_candidate(const float* x, const float* depth, const float* g,
                  const float* y, const float* stats, float* dx, float* dd,
                  int B, int J, int S, int vec, float k, float scale,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* ptrs[4] = {x, depth, dx, dd};
  int h, nq;
  plan(S * S, vec, ptrs, 4, &h, &nq);
  if constexpr (JU == 1 && !STAGE) {
    return bwd_launch<PT, JL>(x, depth, g, y, stats, dx, dd, B, J, S, k,
                              scale, h, nq, st);
  } else {
    const int P = S * S;
    const dim3 grid((P - 3 * nq + PT - 1) / PT, B);
    const size_t smem = (static_cast<size_t>(S) + (STAGE ? 6 * J : 0)
                         + (JL - 1) * PT * 4) * sizeof(float);
    decode_bwd_unrolled_kernel<PT, JL, JU, STAGE><<<grid, PT * JL, smem,
                                                    st>>>(
        x, depth, g, y, stats, dx, dd, J, S, k, scale, h, nq);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace dsf_decode

namespace dsf_encode {

// joint lanes inside a warp: grid (split, B), WARPS warps a CTA, a warp
// takes 32 / JL units a step, lane = unit slot * JL + jl (JL a power of 2
// dividing 32), J <= JL JPT; d depth summed over a unit's lanes by a
// fixed shuffle tree, no barrier inside the loop.  Dynamic shared memory
// S + 3J + WARPS JL 3 JPT floats
template <int JL, int JPT, int WARPS, bool CLUSTER>
__global__ void __launch_bounds__(WARPS * 32)
encode_bwd_warp_kernel(const float* __restrict__ joints,  // (B, J, 3)
                  const float* __restrict__ img,     // (B, S*S)
                  const float* __restrict__ g,       // (B, 4J, S*S)
                  float* __restrict__ dj,            // (B, J, 3)
                  float* __restrict__ dd,            // (B, S*S)
                  int J, int S, float k, int h, int nq) {
  constexpr int kThreads = WARPS * 32, kUnits = 32 / JL;
  extern __shared__ float s_mem[];
  float* s_coord = s_mem;                          // S
  float* s_sum = s_coord + S;                      // 3J: the CTA's sums
  float* s_warp = s_sum + 3 * J;                   // warps x JL x 3 JPT
  const int b = blockIdx.y, P = S * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ul = lane / JL, jl = lane % JL;
  const float inv_k = __frcp_rn(k);
  for (int i = threadIdx.x; i < S; i += kThreads)
    s_coord[i] = pix_coord(i, S);
  float jx[JPT], jy[JPT], jz[JPT], a[JPT][3];
  joints_of<JL>(joints, b, jl, J, jx, jy, jz, a);
  __syncthreads();
  const float* gb = g + static_cast<size_t>(b) * 4 * J * P;
  const float* db = img + static_cast<size_t>(b) * P;
  float* ddb = dd + static_cast<size_t>(b) * P;
  int u0, u1;
  cta_units(P - 3 * nq, &u0, &u1);
  // base is the same across the warp: every lane reaches the shuffles
  for (int base = u0 + warp * kUnits; base < u1; base += WARPS * kUnits) {
    const int un = base + ul;
    float dz[4] = {0.f, 0.f, 0.f, 0.f};
    int p = 0, n = 0;
    if (un < u1 && un < nq) {
      p = h + 4 * un;
      n = 4;
      unit_vjp<4, JL>(a, dz, gb, db, s_coord, jx, jy, jz, p, jl, J, S, k,
                      inv_k);
    } else if (un < u1) {
      p = dsf_decode::single_pixel(un - nq, h, nq);
      n = 1;
      unit_vjp<1, JL>(a, dz, gb, db, s_coord, jx, jy, jz, p, jl, J, S, k,
                      inv_k);
    }
    // d depth over the unit's JL lanes, a fixed tree
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 1; off < JL; off <<= 1)
        dz[i] += __shfl_xor_sync(0xffffffffu, dz[i], off);
    if (jl == 0 && n == 4) {
      const float o[4] = {-dz[0], -dz[1], -dz[2], -dz[3]};
      dsf_decode::store(ddb + p, o);
    } else if (jl == 0 && n == 1) {
      ddb[p] = -dz[0];
    }
  }
  // the joint sums over the warp's unit slots, then the warps in order
#pragma unroll
  for (int i = 0; i < JPT; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = a[i][c];
#pragma unroll
      for (int off = JL; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (ul == 0) s_warp[(warp * JL + jl) * 3 * JPT + 3 * i + c] = v;
    }
  __syncthreads();
  for (int e = threadIdx.x; e < JL * 3 * JPT; e += kThreads) {
    const int l = e / (3 * JPT), ic = e % (3 * JPT);
    const int j = l + JL * (ic / 3);
    if (j >= J) continue;
    float s = s_warp[l * 3 * JPT + ic];
    for (int w = 1; w < WARPS; ++w) s += s_warp[(w * JL + l) * 3 * JPT + ic];
    s_sum[3 * j + ic % 3] = s;
  }
  __syncthreads();
  write_sums<CLUSTER>(s_sum, dj + static_cast<size_t>(b) * 3 * J, J,
                      kThreads);
}

// the library kernel's d depth step, as a function: a unit's d depth, the
// JL lanes' sums in lane order through buffer (it & 1) of s_dd (2 x (JL -
// 1) x PT x 4 floats; a buffer is written again two steps later, after the
// next step's barrier), stored by lane 0
template <int PT, int JL>
__device__ __forceinline__ void store_dd(float (&dz)[4], float* s_dd, int it,
                                         int pt, int jl, float* ddb, int p,
                                         int n) {
  dsf_decode::lane_sum<PT, JL>(dz, s_dd + (it & 1) * (JL - 1) * PT * 4, pt,
                               jl);
  if (jl == 0 && n == 4) {
    const float o[4] = {-dz[0], -dz[1], -dz[2], -dz[3]};
    dsf_decode::store(ddb + p, o);
  } else if (jl == 0 && n == 1) {
    ddb[p] = -dz[0];
  }
}

// the library kernel's joint sums, as a function: into s_sum (3J), behind
// a barrier, over each lane's warps (shuffles, then warp order); s_warp
// (warps x 3 JPT)
template <int PT, int JL, int JPT>
__device__ __forceinline__ void cta_sums(float (&a)[JPT][3], float* s_warp,
                                         float* s_sum, int J) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < JPT; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = a[i][c];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) s_warp[warp * 3 * JPT + 3 * i + c] = v;
    }
  __syncthreads();
  constexpr int kLaneWarps = PT / 32;
  for (int e = threadIdx.x; e < JL * 3 * JPT; e += PT * JL) {
    const int l = e / (3 * JPT), ic = e % (3 * JPT);
    const int j = l + JL * (ic / 3);
    if (j >= J) continue;
    const float* w = s_warp + l * kLaneWarps * 3 * JPT + ic;
    float s = w[0];
    for (int q = 1; q < kLaneWarps; ++q) s += w[q * 3 * JPT];
    s_sum[3 * j + ic % 3] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// the library's block-lane layout with each thread's next unit of 4
// pixels copied into its own shared-memory slots (16-byte cp.async, two
// buffers) while it works on the current one, so a step's loads stay in
// flight through the arithmetic and the barrier of the one before; the
// single pixels after the quads are read directly.  Dynamic shared
// memory: encode_bwd_kernel's floats rounded up to 16 bytes, then 2 x 4
// JPT x PT JL float4
template <int PT, int JL, int JPT, bool CLUSTER>
__global__ void __launch_bounds__(PT * JL)
encode_bwd_async_kernel(const float* __restrict__ joints,
                        const float* __restrict__ img,
                        const float* __restrict__ g, float* __restrict__ dj,
                        float* __restrict__ dd, int J, int S, float k, int h,
                        int nq) {
  constexpr int kThreads = PT * JL, kRows = 4 * JPT;
  extern __shared__ __align__(16) float s_mem[];
  float* s_coord = s_mem;
  float* s_sum = s_coord + S;
  float* s_dd = s_sum + 3 * J;
  float* s_warp = s_dd + 2 * (JL - 1) * PT * 4;
  float4* s_g = reinterpret_cast<float4*>(
      s_mem + ((smem_floats<PT, JL, JPT>(S, J) + 3) & ~static_cast<size_t>(3)));
  const int b = blockIdx.y, P = S * S;
  const int pt = threadIdx.x % PT, jl = threadIdx.x / PT;
  const float inv_k = __frcp_rn(k);
  for (int i = threadIdx.x; i < S; i += kThreads)
    s_coord[i] = pix_coord(i, S);
  float jx[JPT], jy[JPT], jz[JPT], a[JPT][3];
  joints_of<JL>(joints, b, jl, J, jx, jy, jz, a);
  __syncthreads();
  const float* gb = g + static_cast<size_t>(b) * 4 * J * P;
  const float* db = img + static_cast<size_t>(b) * P;
  float* ddb = dd + static_cast<size_t>(b) * P;
  int u0, u1;
  cta_units(P - 3 * nq, &u0, &u1);
  const int q1 = min(u1, nq);
  const int qsteps = q1 > u0 ? (q1 - u0 + PT - 1) / PT : 0;
  // this thread's rows of quad step `step` into buffer step & 1; one
  // commit group a step, empty past the last
  auto issue = [&](int step) {
    const int un = u0 + step * PT + pt;
    if (step < qsteps && un < q1) {
      const int p = h + 4 * un;
      float4* dst = s_g + (step & 1) * kRows * kThreads + threadIdx.x;
#pragma unroll
      for (int i = 0; i < JPT; ++i) {
        const int j = min(jl + JL * i, J - 1);
        const float* ux = gb + static_cast<size_t>(3 * j) * P + p;
        cp_async16(dst + (4 * i) * kThreads, ux);
        cp_async16(dst + (4 * i + 1) * kThreads, ux + P);
        cp_async16(dst + (4 * i + 2) * kThreads, ux + 2 * P);
        cp_async16(dst + (4 * i + 3) * kThreads,
                   gb + static_cast<size_t>(3 * J + j) * P + p);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  issue(0);
  for (int it = 0; it < qsteps; ++it) {
    issue(it + 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    const int un = u0 + it * PT + pt;
    float dz[4] = {0.f, 0.f, 0.f, 0.f};
    int p = 0, n = 0;
    if (un < q1) {
      p = h + 4 * un;
      n = 4;
      Base<4> px;
      dsf_decode::base_load(px, db, s_coord, p, S);
      const float4* src = s_g + (it & 1) * kRows * kThreads + threadIdx.x;
#pragma unroll
      for (int i = 0; i < JPT; ++i) {
        if (jl + JL * i >= J) continue;
        Field<4> f;
        const float4 r0 = src[(4 * i) * kThreads];
        const float4 r1 = src[(4 * i + 1) * kThreads];
        const float4 r2 = src[(4 * i + 2) * kThreads];
        const float4 r3 = src[(4 * i + 3) * kThreads];
        f.a[0] = r0.x; f.a[1] = r0.y; f.a[2] = r0.z; f.a[3] = r0.w;
        f.b[0] = r1.x; f.b[1] = r1.y; f.b[2] = r1.z; f.b[3] = r1.w;
        f.c[0] = r2.x; f.c[1] = r2.y; f.c[2] = r2.z; f.c[3] = r2.w;
        f.h[0] = r3.x; f.h[1] = r3.y; f.h[2] = r3.z; f.h[3] = r3.w;
        joint_vjp(a[i], dz, px, f, jx[i], jy[i], jz[i], k, inv_k);
      }
    }
    store_dd<PT, JL>(dz, s_dd, it, pt, jl, ddb, p, n);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  const int s0 = max(u0, nq);
  const int ssteps = u1 > s0 ? (u1 - s0 + PT - 1) / PT : 0;
  for (int it = 0; it < ssteps; ++it) {
    const int un = s0 + it * PT + pt;
    float dz[4] = {0.f, 0.f, 0.f, 0.f};
    int p = 0, n = 0;
    if (un < u1) {
      p = dsf_decode::single_pixel(un - nq, h, nq);
      n = 1;
      unit_vjp<1, JL>(a, dz, gb, db, s_coord, jx, jy, jz, p, jl, J, S, k,
                      inv_k);
    }
    store_dd<PT, JL>(dz, s_dd, qsteps + it, pt, jl, ddb, p, n);
  }
  cta_sums<PT, JL>(a, s_warp, s_sum, J);
  write_sums<CLUSTER>(s_sum, dj + static_cast<size_t>(b) * 3 * J, J,
                      kThreads);
}

// KIND 1: the library's encode_bwd_kernel<A, B, C> (PT, JL, JPT); 2:
// encode_bwd_async_kernel<A, B, C>; 0: encode_bwd_warp_kernel<A, B, C>
// (JL, JPT, WARPS).  At split CTAs an image, with the library's unit plan
// (vec) or every pixel single
template <int A, int B_, int C, int KIND>
int bwd_candidate(const float* joints, const float* img, const float* g,
                  float* dj, float* dd, int B, int J, int S, int split,
                  int vec, float k, void* stream) {
  const void* ptrs[3] = {img, g, dd};
  int h, nq;
  dsf_decode::plan(S * S, vec, ptrs, 3, &h, &nq);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (J > (KIND ? B_ * C : A * B_) || split < 1 || split > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (KIND == 1) {
    if (split > 8) {
      // clusters of 16: a size the launch takes only once allowed
      const cudaError_t err = cudaFuncSetAttribute(
          encode_bwd_kernel<A, B_, C, true>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return bwd_launch<A, B_, C>(joints, img, g, dj, dd, B, J, S, split, k,
                                h, nq, st);
  } else if constexpr (KIND == 2) {
    const size_t smem =
        ((smem_floats<A, B_, C>(S, J) + 3) & ~static_cast<size_t>(3))
            * sizeof(float)
        + 2 * 4 * C * A * B_ * sizeof(float4);
    cudaError_t err = cudaFuncSetAttribute(
        encode_bwd_async_kernel<A, B_, C, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(encode_bwd_async_kernel<A, B_, C, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess && split > 8)
      err = cudaFuncSetAttribute(
          encode_bwd_async_kernel<A, B_, C, true>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_split(encode_bwd_async_kernel<A, B_, C, false>,
                        encode_bwd_async_kernel<A, B_, C, true>,
                        dim3(split, B), A * B_, smem, st, joints, img, g, dj,
                        dd, J, S, k, h, nq);
  } else {
    static_assert(A > 0 && 32 % A == 0, "JL divides a warp");
    if (split > 8) {
      const cudaError_t err = cudaFuncSetAttribute(
          encode_bwd_warp_kernel<A, B_, C, true>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const size_t smem = (static_cast<size_t>(S) + 3 * J + C * A * 3 * B_)
                        * sizeof(float);
    return launch_split(encode_bwd_warp_kernel<A, B_, C, false>,
                        encode_bwd_warp_kernel<A, B_, C, true>,
                        dim3(split, B), C * 32, smem, st, joints, img, g, dj,
                        dd, J, S, k, h, nq);
  }
}

}  // namespace dsf_encode
