// Candidate layouts of K4 that scripts/codec_shapes_gpu.py times beside
// the library's own.  The library's source is included whole; this adds
// what the library does not run:
//  * the forward's CTA states written to device memory and merged by a
//    second kernel, instead of a thread-block cluster;
//  * the VJP with the loads of JU joints issued before their use, and
//    (STAGE) each joint's 6 constants staged in shared memory behind the
//    first barrier instead of read with the loads;
//  * every pixel loaded alone (4-byte loads) instead of 16-byte units.
// fwd_candidate and bwd_candidate take any of them; the script adds one
// extern "C" instantiation of each layout and builds it with the
// library's flags.

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
