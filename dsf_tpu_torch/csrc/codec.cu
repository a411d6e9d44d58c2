// K5 and K4 — the offset codec (joints <-> dense offset field), forward
// and backward.
//
// Replaces: dsf_tpu/ops/pallas_codec.py:_encode_fwd_call (K5, body
// _enc_fwd_kernel), :_decode_fwd_call (K4, body _fwd_kernel), and their
// VJPs :_encode_bwd (K5 bwd, body _enc_bwd_kernel) and :_decode_bwd (K4
// bwd, body _bwd_kernel), dispatched from dsf_tpu/ops/offset_codec.py:44-51
// and :76-82.
//
// What bounds them on this card: bytes.  Encode writes the (B, 4J, S, S)
// float32 field (44 MB at B=32, J=21, S=64) from 0.5 MB of input; decode
// reads that field once.  The decode VJP reads it and writes its gradient
// (88 MB); the encode VJP reads the field's gradient (44 MB).  Each does a
// few tens of float operations per element, far under the ~20 operations
// per byte at which the card's float32 rate would take over.
//
// Design:
//  * encode: a grid over (pixel block, image); one thread per pixel walks
//    all J joints, read once per block into shared memory, and writes the
//    4J channels of its pixel — neighbouring threads write neighbouring
//    addresses of each channel plane.  dist = sqrt(ox^2 + oy^2 + oz^2 +
//    1e-8) is written with round-to-nearest intrinsics in the plain
//    version's order, and divisions are IEEE divisions, so the field
//    matches the plain PyTorch version to the last bit or two;
//  * decode and its VJP: see the comment above namespace dsf_decode;
//  * encode VJP: see the comment above namespace dsf_encode.  It shares
//    the decode's 16-byte units (plan_units, base_load, field_load).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kEncThreads = 256;

// normalized pixel-centre coordinate (i + 0.5) / S * 2 - 1, rounded as
// the plain version's separate tensor ops round it
__device__ __forceinline__ float pix_coord(int i, int S) {
  return __fsub_rn(
      __fmul_rn(__fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f),
                          static_cast<float>(S)), 2.0f), 1.0f);
}

__global__ void __launch_bounds__(kEncThreads)
encode_fwd_kernel(const float* __restrict__ joints,  // (B, J, 3)
                  const float* __restrict__ img,     // (B, S*S)
                  float* __restrict__ out,           // (B, 4J, S*S)
                  int J, int S, float k) {
  extern __shared__ float s_j[];                      // 3J
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 3 * J; i += blockDim.x)
    s_j[i] = joints[(size_t)b * 3 * J + i];
  __syncthreads();
  const int P = S * S;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float u = pix_coord(p % S, S);
  const float v = pix_coord(p / S, S);
  const float d = img[(size_t)b * P + p];
  const float fg = d < 0.99f ? 1.f : 0.f;
  float* ob = out + (size_t)b * 4 * J * P + p;
  for (int j = 0; j < J; ++j) {
    const float ox = __fsub_rn(s_j[3 * j], u);
    const float oy = __fsub_rn(s_j[3 * j + 1], v);
    const float oz = __fsub_rn(s_j[3 * j + 2], d);
    const float ss = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)),
                  __fmul_rn(oz, oz)), 1e-8f);
    const float dist = __fsqrt_rn(ss);
    const float heat = __fdiv_rn(__fsub_rn(k, dist), k);
    const float m = __fmul_rn(heat >= 0.f ? 1.f : 0.f, fg);
    ob[(size_t)(3 * j) * P] = __fmul_rn(__fdiv_rn(ox, dist), m);
    ob[(size_t)(3 * j + 1) * P] = __fmul_rn(__fdiv_rn(oy, dist), m);
    ob[(size_t)(3 * j + 2) * P] = __fmul_rn(__fdiv_rn(oz, dist), m);
    ob[(size_t)(3 * J + j) * P] = __fmul_rn(heat, m);
  }
}

}  // namespace

// K4, the decode, forward and VJP.
//
// Function (dsf_tpu/ops/pallas_codec.py:_fwd_kernel, _bwd_kernel): per
// image b and joint j, over the S^2 pixels p, hm = heat * mask with mask =
// depth < 0.99 (not differentiated), w = softmax(scale * hm) (background
// pixels keep their exp(0 - m) mass), dist = k - k hm, the vote v = unit
// mask dist + (u, v, depth)_p, and y = sum_p w v.  The VJP for the
// cotangent g needs A = sum_p w (g . v), which is g . y: so once the
// forward keeps y and its softmax statistics (the max m and the mass Z)
// every gradient element depends on its own pixel only.
//
// What bounds them: bytes.  At B=32, J=21, S=64 the forward reads the 44
// MB field once; the VJP reads it and writes its gradient, 88 MB, 0.0266
// ms at 3.35 TB/s.  Both read every element, the background's too: a NaN
// or inf anywhere in a row reaches the row's result through the
// exponential, as in the plain version.
//
// Design (the layouts scripts/codec_shapes_gpu.py chose, PERF.md §6):
//  * forward: one pass with an online softmax.  A CTA takes one joint of
//    one image over one of `split` contiguous shares of the pixels; each
//    thread keeps a running max m and the sums Z, sum v e that it
//    rescales by exp(m_old - m_new) when the max rises, so each element
//    leaves device memory once.  A thread reads 4 pixels of each row with
//    one 16-byte load where the rows share the depth's alignment (the
//    first h pixels and the last few are single-pixel units, so any S and
//    any base address run here), and issues the loads of U such units
//    before it adds them.  States merge with the same rescaling across the
//    warp (shuffles) and the block (shared memory, in warp order); where
//    split > 1 the CTAs of a row form a thread-block cluster whose rank 0
//    reads the others' states through distributed shared memory in rank
//    order.  Fixed orders, so results repeat bitwise.  The wrapper splits
//    rows only while the grid is small (B=1, 2): a cluster launch costs up
//    to 2 us, and even at B=1 the split saves about a microsecond, since
//    there the time is the latency of a launch and a load, not the card's
//    width.  It writes y and the statistics (m, Z) per (image, joint).
//  * VJP: one elementwise pass.  A thread takes one unit (4 pixels, or
//    one) of an image for J / JL of its joints (JL joint lanes a unit),
//    and recomputes w = exp(scale hm - m) / Z, U = mask (g . unit) and V =
//    dist U + g . (u, v, depth) from the 6 floats (m, Z, g, A = g . y) of
//    each joint, read with its loads; it writes d unit = g mask dist w and
//    d heat = mask w (scale (V - A) - k U) and sums d depth = sum_j w_j
//    g_jz over its joints, then over the lanes in lane order through
//    shared memory.  No atomics, no reduction over pixels, one launch.
//  * The NaN rules: a state's max is never NaN (a NaN s fails every
//    comparison) and exp(-inf - m) is taken as 0 also when m is -inf, so
//    the only NaNs are those of the plain version's exponentials and
//    products.
namespace dsf_decode {

namespace cg = cooperative_groups;

constexpr float kFg = 0.99f;              // the codec's foreground test

// online softmax state of one (image, joint) row over some pixels: the
// running max m of s = scale hm, Z = sum exp(s - m) and sum v exp(s - m)
struct Soft {
  float m, z, sx, sy, sz;
};

__device__ __forceinline__ Soft soft_empty() {
  return {-INFINITY, 0.f, 0.f, 0.f, 0.f};
}

// exp(from - to), to >= from, with exp(-inf - anything) = 0: a state that
// has seen no pixel, or only s = -inf, adds nothing
__device__ __forceinline__ float shift(float from, float to) {
  return from == -INFINITY ? 0.f : expf(from - to);
}

__device__ __forceinline__ void merge(Soft& a, const Soft& b) {
  const float m = fmaxf(a.m, b.m);
  const float fa = shift(a.m, m), fb = shift(b.m, m);
  a.m = m;
  a.z = a.z * fa + b.z * fb;
  a.sx = a.sx * fa + b.sx * fb;
  a.sy = a.sy * fa + b.sy * fb;
  a.sz = a.sz * fa + b.sz * fb;
}

__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  *p = v[0];
}

// the first pixel of a single-pixel unit: the h pixels before the first
// 16-byte boundary, then those after the nq groups of 4
__device__ __forceinline__ int single_pixel(int i, int h, int nq) {
  return i < h ? i : h + 4 * nq + (i - h);
}

// N pixels from p of one image: depth, coordinates (from the table of S)
// and mask
template <int N>
struct Base {
  float d[N], u[N], v[N], mask[N];
};

template <int N>
__device__ __forceinline__ void base_load(Base<N>& px,
                                          const float* __restrict__ db,
                                          const float* s_coord, int p,
                                          int S) {
  load(db + p, px.d);
  int row = p / S, col = p - row * S;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    px.u[i] = s_coord[col];
    px.v[i] = s_coord[row];
    if (++col == S) { col = 0; ++row; }
    px.mask[i] = px.d[i] < kFg ? 1.f : 0.f;
  }
}

// joint j's 3 unit rows and heat row at those pixels
template <int N>
struct Field {
  float a[N], b[N], c[N], h[N];
};

template <int N>
__device__ __forceinline__ void field_load(Field<N>& f,
                                           const float* __restrict__ xb,
                                           int p, int j, int J, int P) {
  const float* ux = xb + static_cast<size_t>(3 * j) * P + p;
  load(ux, f.a);
  load(ux + P, f.b);
  load(ux + 2 * P, f.c);
  load(xb + static_cast<size_t>(3 * J + j) * P + p, f.h);
}

// add N pixels of one row to a state: one rescale for the N
template <int N>
__device__ __forceinline__ void fwd_add(Soft& st, const Base<N>& px,
                                        const Field<N>& f, float k,
                                        float scale) {
  float s[N], vx[N], vy[N], vz[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float mask = px.mask[i];
    const float hm = __fmul_rn(f.h[i], mask);
    s[i] = __fmul_rn(hm, scale);
    const float dist = __fsub_rn(k, __fmul_rn(hm, k));
    vx[i] = __fadd_rn(__fmul_rn(__fmul_rn(f.a[i], mask), dist), px.u[i]);
    vy[i] = __fadd_rn(__fmul_rn(__fmul_rn(f.b[i], mask), dist), px.v[i]);
    vz[i] = __fadd_rn(__fmul_rn(__fmul_rn(f.c[i], mask), dist), px.d[i]);
  }
  float ml = s[0];
#pragma unroll
  for (int i = 1; i < N; ++i) ml = fmaxf(ml, s[i]);
  if (ml > st.m) {
    const float r = shift(st.m, ml);
    st.z *= r; st.sx *= r; st.sy *= r; st.sz *= r;
    st.m = ml;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = s[i] == -INFINITY ? 0.f : expf(s[i] - st.m);
    st.z += e;
    st.sx = fmaf(vx[i], e, st.sx);
    st.sy = fmaf(vy[i], e, st.sy);
    st.sz = fmaf(vz[i], e, st.sz);
  }
}

__device__ __forceinline__ void finish(const Soft& a, float* y, float* stats,
                                       int row) {
  y[3 * row] = a.sx / a.z;
  y[3 * row + 1] = a.sy / a.z;
  y[3 * row + 2] = a.sz / a.z;
  stats[2 * row] = a.m;
  stats[2 * row + 1] = a.z;
}

// the state of this CTA's share (blockIdx.x of gridDim.x) of row (b, j),
// merged over its warps in warp order: valid in thread 0.  Fills the
// coordinate table s_coord (S floats) first.  A thread loads U units of 4
// pixels before it adds them.
template <int THREADS, int U>
__device__ __forceinline__ Soft cta_state(const float* __restrict__ x,
                                          const float* __restrict__ depth,
                                          float* s_coord, Soft* s_warp,
                                          int j, int b, int J, int S,
                                          float k, float scale, int h,
                                          int nq) {
  const int split = gridDim.x, c = blockIdx.x;
  const int P = S * S;
  for (int i = threadIdx.x; i < S; i += THREADS) s_coord[i] = pix_coord(i, S);
  __syncthreads();
  const float* xb = x + static_cast<size_t>(b) * 4 * J * P;
  const float* db = depth + static_cast<size_t>(b) * P;
  const int units = P - 3 * nq;
  const int per = (units + split - 1) / split;
  const int u1 = min(units, (c + 1) * per);
  Soft st = soft_empty();
  // the units in the order un, un + THREADS, ... whatever U is
  const int groups_end = min(u1, nq);
  int un = c * per + threadIdx.x;
  for (; un + (U - 1) * THREADS < groups_end; un += U * THREADS) {
    Base<4> px[U];
    Field<4> f[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int p = h + 4 * (un + q * THREADS);
      base_load(px[q], db, s_coord, p, S);
      field_load(f[q], xb, p, j, J, P);
    }
#pragma unroll
    for (int q = 0; q < U; ++q) fwd_add(st, px[q], f[q], k, scale);
  }
  for (; un < u1; un += THREADS) {
    if (un < nq) {
      Base<4> px;
      Field<4> f;
      base_load(px, db, s_coord, h + 4 * un, S);
      field_load(f, xb, h + 4 * un, j, J, P);
      fwd_add(st, px, f, k, scale);
    } else {
      const int p = single_pixel(un - nq, h, nq);
      Base<1> px;
      Field<1> f;
      base_load(px, db, s_coord, p, S);
      field_load(f, xb, p, j, J, P);
      fwd_add(st, px, f, k, scale);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    Soft o;
    o.m = __shfl_down_sync(0xffffffffu, st.m, off);
    o.z = __shfl_down_sync(0xffffffffu, st.z, off);
    o.sx = __shfl_down_sync(0xffffffffu, st.sx, off);
    o.sy = __shfl_down_sync(0xffffffffu, st.sy, off);
    o.sz = __shfl_down_sync(0xffffffffu, st.sz, off);
    merge(st, o);
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = st;
  __syncthreads();
  if (threadIdx.x == 0) {
    st = s_warp[0];
    for (int w = 1; w < THREADS / 32; ++w) merge(st, s_warp[w]);
  }
  return st;
}

// grid (split, J, B); dynamic shared memory S floats.  Split 1: each CTA
// finishes its row.  CLUSTER: the launch groups the split CTAs of a row
// into one cluster, whose rank 0 merges their states in rank order.
template <int THREADS, int U, bool CLUSTER>
__global__ void __launch_bounds__(THREADS)
decode_fwd_kernel(const float* __restrict__ x,      // (B, 4J, S*S)
                  const float* __restrict__ depth,  // (B, S*S)
                  float* __restrict__ y,            // (B, J, 3)
                  float* __restrict__ stats,        // (B, J, 2): m, Z
                  int J, int S, float k, float scale, int h, int nq) {
  extern __shared__ float s_coord[];
  __shared__ Soft s_warp[THREADS / 32];
  __shared__ Soft s_cta;
  const int j = blockIdx.y, b = blockIdx.z;
  const Soft a = cta_state<THREADS, U>(x, depth, s_coord, s_warp, j, b, J,
                                       S, k, scale, h, nq);
  const bool owner = threadIdx.x == 0;
  if constexpr (CLUSTER) {
    if (owner) s_cta = a;
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (blockIdx.x == 0 && owner) {
      const int split = gridDim.x;
      Soft t = s_cta;
      for (int r = 1; r < split; ++r)
        merge(t, *cl.map_shared_rank(&s_cta, r));
      finish(t, y, stats, b * J + j);
    }
    cl.sync();                  // rank 0 has read every CTA's state
  } else if (owner) {
    finish(a, y, stats, b * J + j);
  }
}

// a joint's constants for the VJP: m, Z, g and A = g . y
struct Row {
  float m, z, gx, gy, gz, A;
};

// joint j's Row, read from the image's statistics, cotangent and joints
__device__ __forceinline__ Row row_of(int j, const float* __restrict__ sb,
                                      const float* __restrict__ gb,
                                      const float* __restrict__ yb) {
  Row r{__ldg(sb + 2 * j), __ldg(sb + 2 * j + 1), __ldg(gb + 3 * j),
        __ldg(gb + 3 * j + 1), __ldg(gb + 3 * j + 2), 0.f};
  r.A = r.gx * __ldg(yb + 3 * j) + r.gy * __ldg(yb + 3 * j + 1)
        + r.gz * __ldg(yb + 3 * j + 2);
  return r;
}

// joint j's d offset at the N pixels from p, stored into dxb; adds each
// pixel's w g_z into acc
template <int N>
__device__ __forceinline__ void joint_grad(float (&acc)[4], const Base<N>& px,
                                           const Field<N>& f, const Row& rw,
                                           float* __restrict__ dxb, int p,
                                           int j, int J, int P, float k,
                                           float scale) {
  const float gx = rw.gx, gy = rw.gy, gz = rw.gz;
  float ox[N], oy[N], oz[N], oh[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float mask = px.mask[i];
    const float hm = __fmul_rn(f.h[i], mask);
    const float w = expf(__fsub_rn(__fmul_rn(hm, scale), rw.m)) / rw.z;
    const float dist = __fsub_rn(k, __fmul_rn(hm, k));
    const float U = mask * (f.a[i] * gx + f.b[i] * gy + f.c[i] * gz);
    const float V = dist * U + (gx * px.u[i] + gy * px.v[i] + gz * px.d[i]);
    const float mdw = mask * dist * w;
    ox[i] = gx * mdw;
    oy[i] = gy * mdw;
    oz[i] = gz * mdw;
    oh[i] = mask * w * (scale * (V - rw.A) - k * U);
    acc[i] += w * gz;
  }
  float* o = dxb + static_cast<size_t>(3 * j) * P + p;
  store(o, ox);
  store(o + P, oy);
  store(o + 2 * P, oz);
  store(dxb + static_cast<size_t>(3 * J + j) * P + p, oh);
}

// the d offset of N pixels from p for the joints jl, jl + JL, ...; adds
// each joint's w g_z into acc
template <int N, int JL>
__device__ __forceinline__ void bwd_pixels(float (&acc)[4],
                                           const float* __restrict__ xb,
                                           float* __restrict__ dxb,
                                           const float* __restrict__ db,
                                           const float* s_coord,
                                           const float* __restrict__ sb,
                                           const float* __restrict__ gb,
                                           const float* __restrict__ yb,
                                           int p, int jl, int J, int S,
                                           float k, float scale) {
  const int P = S * S;
  Base<N> px;
  base_load(px, db, s_coord, p, S);
  for (int j = jl; j < J; j += JL) {
    Field<N> f;
    field_load(f, xb, p, j, J, P);
    joint_grad(acc, px, f, row_of(j, sb, gb, yb), dxb, p, j, J, P, k, scale);
  }
}

// d depth of a unit: the JL lanes' sums added in lane order through
// s_dd ((JL - 1) x PT x 4 floats); lane 0 holds the total
template <int PT, int JL>
__device__ __forceinline__ void lane_sum(float (&acc)[4], float* s_dd,
                                         int pt, int jl) {
  if constexpr (JL > 1) {
    if (jl > 0)
      for (int i = 0; i < 4; ++i) s_dd[((jl - 1) * PT + pt) * 4 + i] = acc[i];
    __syncthreads();
    if (jl == 0)
      for (int l = 1; l < JL; ++l)
        for (int i = 0; i < 4; ++i) acc[i] += s_dd[((l - 1) * PT + pt) * 4 + i];
  }
}

// grid (ceil(units / PT), B), PT x JL threads: thread t takes unit
// blockIdx.x * PT + t % PT and the joints t / PT, + JL, ...; dynamic
// shared memory S + (JL - 1) PT 4 floats
template <int PT, int JL>
__global__ void __launch_bounds__(PT * JL)
decode_bwd_kernel(const float* __restrict__ x,      // (B, 4J, S*S)
                  const float* __restrict__ depth,  // (B, S*S)
                  const float* __restrict__ g,      // (B, J, 3)
                  const float* __restrict__ y,      // (B, J, 3)
                  const float* __restrict__ stats,  // (B, J, 2): m, Z
                  float* __restrict__ dx,           // (B, 4J, S*S)
                  float* __restrict__ dd,           // (B, S*S)
                  int J, int S, float k, float scale, int h, int nq) {
  extern __shared__ float s_mem[];
  float* s_coord = s_mem;                       // S
  float* s_dd = s_mem + S;                      // (JL - 1) x PT x 4
  const int b = blockIdx.y, P = S * S;
  const float* sb = stats + static_cast<size_t>(b) * J * 2;
  const float* gb = g + static_cast<size_t>(b) * J * 3;
  const float* yb = y + static_cast<size_t>(b) * J * 3;
  for (int i = threadIdx.x; i < S; i += PT * JL) s_coord[i] = pix_coord(i, S);
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
    bwd_pixels<4, JL>(acc, x + off, dx + off, db, s_coord, sb, gb, yb, p, jl,
                      J, S, k, scale);
  } else if (un < P - 3 * nq) {
    p = single_pixel(un - nq, h, nq);
    n = 1;
    bwd_pixels<1, JL>(acc, x + off, dx + off, db, s_coord, sb, gb, yb, p, jl,
                      J, S, k, scale);
  }
  lane_sum<PT, JL>(acc, s_dd, pt, jl);
  if (jl == 0)
    for (int i = 0; i < n; ++i) dd[static_cast<size_t>(b) * P + p + i] = acc[i];
}

// the 16-byte units: where P is a multiple of 4 and every pointer has the
// same offset from a 16-byte boundary, the h pixels before the first
// boundary are single, then nq groups of 4 (the rest single); else every
// pixel is single
inline void plan_units(int P, const void* const* ptrs, int n, int* h,
                       int* nq) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptrs[0]) % 16;
  bool ok = P % 4 == 0;
  for (int i = 1; i < n; ++i)
    ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == a;
  const int head = static_cast<int>((16 - a) % 16 / 4);
  *h = ok ? (head < P ? head : P) : 0;
  *nq = ok ? (P - *h) / 4 : 0;
}

// grid (split, J, B): one CTA a row without a cluster (split 1), else a
// cluster of the split CTAs of each row (at most 8, the portable size)
template <int THREADS, int U>
int fwd_launch(const float* x, const float* depth, float* y, float* stats,
               int B, int J, int S, int split, float k, float scale, int h,
               int nq, cudaStream_t st) {
  if (split < 1 || split > 8) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(split, J, B);
  const size_t smem = static_cast<size_t>(S) * sizeof(float);
  if (split == 1) {
    decode_fwd_kernel<THREADS, U, false><<<grid, THREADS, smem, st>>>(
        x, depth, y, stats, J, S, k, scale, h, nq);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_fwd_kernel<THREADS, U, true>, x, depth, y, stats, J, S, k,
      scale, h, nq);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int PT, int JL>
int bwd_launch(const float* x, const float* depth, const float* g,
               const float* y, const float* stats, float* dx, float* dd,
               int B, int J, int S, float k, float scale, int h, int nq,
               cudaStream_t st) {
  const int P = S * S;
  const dim3 grid((P - 3 * nq + PT - 1) / PT, B);
  const size_t smem = (static_cast<size_t>(S) + (JL - 1) * PT * 4)
                      * sizeof(float);
  decode_bwd_kernel<PT, JL><<<grid, PT * JL, smem, st>>>(
      x, depth, g, y, stats, dx, dd, J, S, k, scale, h, nq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dsf_decode

// K5 bwd, the encode VJP.
//
// Function: autograd of the encode (dsf_tpu/ops/pallas_codec.py:
// _enc_bwd_kernel) for the cotangent g of the field: per pixel p and
// joint j the forward's offset o = joint - (u, v, depth), dist = |o|
// (+1e-8 under the root), heat = (k - dist) / k and the mask m = (heat >=
// 0) (depth < 0.99) give d o = g_unit m / dist + o d dist / dist with d
// dist = -m (g_unit . o / dist^2 + g_heat / k); d joint_j = sum_p d o and
// d depth_p = -sum_j d o_z.  m is not differentiated.
//
// What bounds it: bytes.  It reads all of g (44 MB at B=32, J=21, S=64),
// inside the cones or not: a NaN or inf anywhere in g reaches its joint's
// d joint and its pixel's d depth, as in autograd and JAX's jnp path.
// Its ~50 float operations per (pixel, joint) come close to the time of
// those bytes, so the arithmetic is kept lean: the mask is dist <= k
// (the sign of heat, so the forward's division is not needed), 1/dist is
// one correctly rounded reciprocal, and g_heat / k is g_heat (1/k).
//
// Design (the layout scripts/codec_shapes_gpu.py chose, PERF.md §6): one
// launch.  The split CTAs of an image (one thread-block cluster; the
// wrapper's encode_bwd_split keeps about two CTAs a streaming
// multiprocessor) take contiguous shares of its units: 4 pixels read with
// 16-byte loads where g, the depth and d depth share their offset from a
// 16-byte boundary, else single pixels, as the decode's plan_units lays
// them out.  A CTA is PT units x JL joint lanes; thread (pt, jl) takes the
// units pt, pt + PT, ... of its share for the joints jl, jl + JL, ...  It
// recomputes the forward's offsets and distance as the forward rounds
// them, keeps its joints' 3 sums in registers over all its units, and sums
// d depth over its joints in joint order, then over the lanes in lane
// order (shared memory, double-buffered: one barrier a unit step).  The
// joint sums meet once at the end: over a lane's warps by shuffles, then
// in warp order, then over the cluster's CTAs in rank order through
// distributed shared memory.  No atomics, no scratch in device memory;
// two runs agree bitwise.
namespace dsf_encode {

namespace cg = cooperative_groups;
using dsf_decode::Base;
using dsf_decode::Field;

// joint (jx, jy, jz)'s VJP at N pixels for its cotangent rows f: adds the
// pixels' d offset to a in pixel order and each pixel's d o_z to dz
template <int N>
__device__ __forceinline__ void joint_vjp(float (&a)[3], float (&dz)[4],
                                          const Base<N>& px,
                                          const Field<N>& f, float jx,
                                          float jy, float jz, float k,
                                          float inv_k) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // the forward's offsets and distance, rounded as there; its mask
    // (k - dist) / k >= 0 is dist <= k, and 1 / dist is rounded as a
    // division would round it
    const float ox = __fsub_rn(jx, px.u[i]);
    const float oy = __fsub_rn(jy, px.v[i]);
    const float oz = __fsub_rn(jz, px.d[i]);
    const float ss = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)),
                  __fmul_rn(oz, oz)), 1e-8f);
    const float dist = __fsqrt_rn(ss);
    const float m = dist <= k ? px.mask[i] : 0.f;
    const float rd = __frcp_rn(dist);
    // d(unit)/d(dist) summed over the joint's 3 rows, and d(heat)/d(dist)
    const float su = f.a[i] * ox + f.b[i] * oy + f.c[i] * oz;
    const float ddist = -m * (rd * rd * su + f.h[i] * inv_k);
    const float mrd = m * rd, t = rd * ddist;
    const float dox = f.a[i] * mrd + ox * t;
    const float doy = f.b[i] * mrd + oy * t;
    const float doz = f.c[i] * mrd + oz * t;
    a[0] += dox;
    a[1] += doy;
    a[2] += doz;
    dz[i] += doz;
  }
}

// one unit (N pixels from p) for this thread's joints jl + JL i
template <int N, int JL, int JPT>
__device__ __forceinline__ void unit_vjp(float (&a)[JPT][3], float (&dz)[4],
                                         const float* __restrict__ gb,
                                         const float* __restrict__ db,
                                         const float* s_coord,
                                         const float (&jx)[JPT],
                                         const float (&jy)[JPT],
                                         const float (&jz)[JPT], int p,
                                         int jl, int J, int S, float k,
                                         float inv_k) {
  const int P = S * S;
  Base<N> px;
  dsf_decode::base_load(px, db, s_coord, p, S);
#pragma unroll
  for (int i = 0; i < JPT; ++i) {
    const int j = jl + JL * i;
    if (j < J) {
      Field<N> f;
      dsf_decode::field_load(f, gb, p, j, J, P);
      joint_vjp(a[i], dz, px, f, jx[i], jy[i], jz[i], k, inv_k);
    }
  }
}
// this thread's joints jl + JL i of image b, zeroed sums beside them
template <int JL, int JPT>
__device__ __forceinline__ void joints_of(const float* __restrict__ joints,
                                          int b, int jl, int J,
                                          float (&jx)[JPT], float (&jy)[JPT],
                                          float (&jz)[JPT],
                                          float (&a)[JPT][3]) {
#pragma unroll
  for (int i = 0; i < JPT; ++i) {
    const float* q = joints + (static_cast<size_t>(b) * J
                               + min(jl + JL * i, J - 1)) * 3;
    jx[i] = __ldg(q);
    jy[i] = __ldg(q + 1);
    jz[i] = __ldg(q + 2);
    a[i][0] = a[i][1] = a[i][2] = 0.f;
  }
}

// the CTA's joint sums s_sum (3J, filled and behind a barrier) into dj:
// over the cluster's CTAs in rank order (CLUSTER), else the CTA's own
template <bool CLUSTER>
__device__ __forceinline__ void write_sums(float* s_sum, float* djb, int J,
                                           int threads) {
  if constexpr (CLUSTER) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (blockIdx.x == 0)
      for (int c = threadIdx.x; c < 3 * J; c += threads) {
        float s = s_sum[c];
        for (int r = 1; r < static_cast<int>(gridDim.x); ++r)
          s += cl.map_shared_rank(s_sum, r)[c];
        djb[c] = s;
      }
    cl.sync();                  // rank 0 has read every CTA's sums
  } else {
    for (int c = threadIdx.x; c < 3 * J; c += threads) djb[c] = s_sum[c];
  }
}

// the units [u0, u1) of this CTA: its share of the image's units
__device__ __forceinline__ void cta_units(int units, int* u0, int* u1) {
  const int per = (units + gridDim.x - 1) / gridDim.x;
  *u0 = blockIdx.x * per;
  *u1 = min(units, *u0 + per);
}

// shared memory of encode_bwd_kernel, in floats
template <int PT, int JL, int JPT>
__host__ __device__ constexpr size_t smem_floats(int S, int J) {
  return static_cast<size_t>(S) + 3 * J + 2 * (JL - 1) * PT * 4
         + (PT * JL / 32) * 3 * JPT;
}

// grid (split, B): the split CTAs of an image take contiguous shares of
// its units, merged in a cluster (CLUSTER; else split is 1); a CTA is PT
// units x JL joint lanes (PT a multiple of 32), thread t the unit slot t
// % PT and the joints t / PT + JL i, J <= JL JPT
template <int PT, int JL, int JPT, bool CLUSTER>
__global__ void __launch_bounds__(PT * JL)
encode_bwd_kernel(const float* __restrict__ joints,  // (B, J, 3)
                  const float* __restrict__ img,     // (B, S*S)
                  const float* __restrict__ g,       // (B, 4J, S*S)
                  float* __restrict__ dj,            // (B, J, 3)
                  float* __restrict__ dd,            // (B, S*S)
                  int J, int S, float k, int h, int nq) {
  constexpr int kThreads = PT * JL;
  extern __shared__ float s_mem[];
  float* s_coord = s_mem;                          // S
  float* s_sum = s_coord + S;                      // 3J: the CTA's sums
  float* s_dd = s_sum + 3 * J;                     // 2 x (JL-1) x PT x 4
  float* s_warp = s_dd + 2 * (JL - 1) * PT * 4;    // warps x 3 JPT
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
  const int steps = u1 > u0 ? (u1 - u0 + PT - 1) / PT : 0;
  for (int it = 0; it < steps; ++it) {
    const int un = u0 + it * PT + pt;
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
    if constexpr (JL > 1) {
      // the lanes' d depth in lane order; a buffer is written again two
      // steps later, after the next step's barrier
      float* buf = s_dd + (it & 1) * (JL - 1) * PT * 4;
      if (jl > 0)
        for (int i = 0; i < 4; ++i) buf[((jl - 1) * PT + pt) * 4 + i] = dz[i];
      __syncthreads();
      if (jl == 0)
        for (int l = 1; l < JL; ++l)
          for (int i = 0; i < 4; ++i) dz[i] += buf[((l - 1) * PT + pt) * 4 + i];
    }
    if (jl == 0 && n == 4) {
      const float o[4] = {-dz[0], -dz[1], -dz[2], -dz[3]};
      dsf_decode::store(ddb + p, o);
    } else if (jl == 0 && n == 1) {
      ddb[p] = -dz[0];
    }
  }
  // the joint sums: over each lane's warps (shuffles, then warp order)
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
  for (int e = threadIdx.x; e < JL * 3 * JPT; e += kThreads) {
    const int l = e / (3 * JPT), ic = e % (3 * JPT);
    const int j = l + JL * (ic / 3);
    if (j >= J) continue;
    const float* w = s_warp + l * kLaneWarps * 3 * JPT + ic;
    float s = w[0];
    for (int q = 1; q < kLaneWarps; ++q) s += w[q * 3 * JPT];
    s_sum[3 * j + ic % 3] = s;
  }
  __syncthreads();
  write_sums<CLUSTER>(s_sum, dj + static_cast<size_t>(b) * 3 * J, J,
                      kThreads);
}

// plain on a grid where split is 1, else cluster launched as clusters of
// split CTAs (above 8, a non-portable size the caller has allowed)
template <typename K>
int launch_split(K plain, K cluster, dim3 grid, int threads, size_t smem,
                 cudaStream_t st, const float* joints, const float* img,
                 const float* g, float* dj, float* dd, int J, int S, float k,
                 int h, int nq) {
  const int split = static_cast<int>(grid.x);
  if (split == 1) {
    plain<<<grid, threads, smem, st>>>(joints, img, g, dj, dd, J, S, k, h,
                                       nq);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster, joints, img, g,
                                             dj, dd, J, S, k, h, nq);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// split CTAs an image, 1 to 16
template <int PT, int JL, int JPT>
int bwd_launch(const float* joints, const float* img, const float* g,
               float* dj, float* dd, int B, int J, int S, int split, float k,
               int h, int nq, cudaStream_t st) {
  static_assert(PT % 32 == 0, "a joint lane is whole warps");
  if (J > JL * JPT || split < 1 || split > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_split(encode_bwd_kernel<PT, JL, JPT, false>,
                      encode_bwd_kernel<PT, JL, JPT, true>,
                      dim3(split, B), PT * JL,
                      smem_floats<PT, JL, JPT>(S, J) * sizeof(float), st,
                      joints, img, g, dj, dd, J, S, k, h, nq);
}

}  // namespace dsf_encode

namespace {

// the library's layouts, the fastest of scripts/codec_shapes_gpu.py's by
// their summed times at B = 1, 32 and 64
constexpr int kFwdThreads = 128, kFwdU = 2;
constexpr int kBwdPT = 32, kBwdJL = 7;
// the encode VJP: PT units x JL joint lanes of JPT joints a CTA
constexpr int kEncPT = 32, kEncJL = 7, kEncJPT = 3;

}  // namespace

extern "C" int dsf_codec_encode(const float* joints, const float* img,
                                float* out, int B, int J, int S, float k,
                                void* stream) {
  const int P = S * S;
  const dim3 grid((P + kEncThreads - 1) / kEncThreads, B);
  encode_fwd_kernel<<<grid, kEncThreads, 3 * J * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(joints, img, out,
                                                           J, S, k);
  return static_cast<int>(cudaGetLastError());
}

// d joint (B, J, 3) and d img (B, S*S), one launch of split CTAs an
// image (a cluster when more than one, at most 8); J <= kEncJL * kEncJPT
extern "C" int dsf_codec_encode_bwd(const float* joints, const float* img,
                                    const float* g, float* dj, float* dd,
                                    int B, int J, int S, int split, float k,
                                    void* stream) {
  if (split > 8) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[3] = {img, g, dd};
  int h, nq;
  dsf_decode::plan_units(S * S, ptrs, 3, &h, &nq);
  return dsf_encode::bwd_launch<kEncPT, kEncJL, kEncJPT>(
      joints, img, g, dj, dd, B, J, S, split, k, h, nq,
      static_cast<cudaStream_t>(stream));
}

extern "C" int dsf_codec_encode_bwd_max_joints() { return kEncJL * kEncJPT; }

// y (B, J, 3) and stats (B, J, 2); split CTAs a row, 1 to 8, merged in a
// cluster when more than one (a cluster launch costs up to 2 us more)
extern "C" int dsf_codec_decode(const float* x, const float* depth,
                                float* y, float* stats, int B, int J, int S,
                                int split, float k, float scale,
                                void* stream) {
  const void* ptrs[2] = {x, depth};
  int h, nq;
  dsf_decode::plan_units(S * S, ptrs, 2, &h, &nq);
  return dsf_decode::fwd_launch<kFwdThreads, kFwdU>(
      x, depth, y, stats, B, J, S, split, k, scale, h, nq,
      static_cast<cudaStream_t>(stream));
}

extern "C" int dsf_codec_decode_bwd(const float* x, const float* depth,
                                    const float* g, const float* y,
                                    const float* stats, float* dx, float* dd,
                                    int B, int J, int S, float k, float scale,
                                    void* stream) {
  const void* ptrs[4] = {x, depth, dx, dd};
  int h, nq;
  dsf_decode::plan_units(S * S, ptrs, 4, &h, &nq);
  return dsf_decode::bwd_launch<kBwdPT, kBwdJL>(
      x, depth, g, y, stats, dx, dd, B, J, S, k, scale, h, nq,
      static_cast<cudaStream_t>(stream));
}
