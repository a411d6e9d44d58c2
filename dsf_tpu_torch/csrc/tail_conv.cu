// K9 — the CycleGAN generator's tail: tanh(7x7 convolution C -> 1 + bias).
//
// Replaces: dsf_tpu/ops/pallas_tapsum.py:tail_conv_tanh (:122), whose TPU
// path _fast_tail (:90) contracts the channels per tap on the matrix unit
// into a tap-major (49, B, Hp, Wp) float32 buffer and shift-sums it in
// Pallas (_shift_sum_kernel, pl.pallas_call :108), in four tap-chunked
// calls because one image's 49 taps do not fit VMEM (:31-41, 77-87).
//
// Function: out[b, 0, i, j] = tanh(bias + sum over c, ky, kx of
// w[0, c, ky, kx] * x[b, c, i + ky, j + kx]), x already reflect-padded
// (B, C, H + 6, W + 6), VALID padding, accumulated in float32 (the JAX
// reference _reference_tail, :57-65).  The sum runs over each group's
// channels in order (ky, then kx, within a channel), then over the groups
// in order, so it is the plain version's float32 sum in another order.
//
// Two element types, one template (T): float32, and bfloat16 for the
// generator's bfloat16 compute dtype.  In bfloat16, x, w and the bias are
// bfloat16; each product of two bfloat16 values is exact in float32 and
// the sum is float32, rounded to bfloat16 once; the bias is added in
// bfloat16 (rounded) and tanh's output is rounded to bfloat16: the
// rounding points of _reference_tail(x, w, b, bfloat16) and _fast_tail
// (:95-114).  At the generator's shape the bfloat16 variant reads 73.5 MB
// of x, 0.0219 ms at 3.35 TB/s, so the FMAs (0.049 ms) bound it.
//
// What bounds it on this card: both, about equally.  At the generator's
// shape (B=32, C=64, 134^2 in, 128^2 out) it reads 147 MB of x and writes
// 2 MB, 0.044 ms at 3.35 TB/s, and does 2 * 49 * 64 = 6272 float
// operations per output pixel, 3.29 GFLOP, 0.049 ms at 67 TFLOP/s.
//
// Design: a register-tiled direct convolution, split over the channels.
//  * Each thread keeps RT x CT outputs (rows x columns) in registers.  Per
//    channel it loads the channel's 49 weights into registers (13
//    broadcast float4 reads), then walks its RT + 6 input rows once: each
//    row's CT + 6 window in float2 reads, added into every output row it
//    feeds (at most 7, static indices).  At 8 x 4 that is 83 shared loads
//    for 1568 FMAs a channel, so the FMAs set the pace, not the loads.
//  * A block owns a band of BH = TY x RT output rows and BW = TX x CT
//    columns; its G groups of TX x TY threads take a contiguous share of
//    the channels each (split-K: 32 x 128^2 outputs at 32 a thread are
//    16k threads, too few for 132 SMs), and their partial sums are added
//    through shared memory in group order at the end, then the bias and
//    tanhf (CUDA's, within 2 ulp).
//  * A group stages one channel of its band at a time in shared memory,
//    double buffered: the copy of the next channel is in flight while the
//    group computes on this one.  The copy: a band of full-width rows of
//    one channel is one contiguous span of (BH + 6) x Wp elements, so one
//    cp.async.bulk per channel moves it, completed on an mbarrier.  In
//    float32 the span must be 16-byte aligned and a multiple of 16 bytes
//    (Wp = 134 at the generator's shape: 536-byte rows, BH even; a 2-D
//    TMA tensor map would need 16-byte row strides).  In bfloat16 a
//    134-element row is 268 bytes and a channel plane 8 bytes past a
//    multiple of 16, so the copy takes the span widened to 16 bytes at
//    both ends (inside x, whose start and size are multiples of 16) and
//    the threads read it from its first element on (an even element, as
//    the 4-byte pair reads need: Wp even).  Otherwise the group copies
//    the (BH + 6) x (BW + 6) window, zero-filled outside x (ragged shapes,
//    tiles narrower than W), with 4-byte cp.async in float32 and 2-byte
//    loads in bfloat16 (its elements need not pair on 4 bytes).
//
// The block shape is the one of scripts/tail_shapes_gpu.py's shapes that
// took the least time at the generator's shape (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace dsf_tail {

constexpr int K = 7;                      // taps per side
constexpr int kWPitch = 52;               // a channel's 49 weights, 13 float4

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0u;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// the threads of group g (ids 1..15; 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int g, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(threads) : "memory");
}

// two neighbouring elements of a staged row, as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// an output from its float32 sum: tanhf(sum + bias) in float32; in
// bfloat16 the sum rounded, the bias added and rounded, tanh rounded
__device__ __forceinline__ float finish(float sum, float bias) {
  return tanhf(sum + bias);
}
__device__ __forceinline__ __nv_bfloat16 finish(float sum,
                                                __nv_bfloat16 bias) {
  const float pre = __bfloat162float(__float2bfloat16_rn(
      __bfloat162float(__float2bfloat16_rn(sum)) + __bfloat162float(bias)));
  return __float2bfloat16_rn(tanhf(pre));
}

// one element global -> shared, zero outside x: 4-byte cp.async for
// float32; a plain load and store for bfloat16
__device__ __forceinline__ void stage1(float* dst, const float* src,
                                       bool valid) {
  cp_async4(dst, src, valid);
}
__device__ __forceinline__ void stage1(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, bool valid) {
  *dst = valid ? *src : __float2bfloat16_rn(0.f);
}

// Shared memory, in bytes: the mbarriers, the weights (float32), then
// G x 2 channel buffers of buf elements (their space holds the float32
// partial sums at the end).
struct Layout {
  int pitch;      // elements a staged row
  int buf;        // elements a channel buffer
  size_t bytes;   // the block's dynamic shared memory
};

// at most 128 registers a thread: 512 threads of an SM's 64k registers
template <int RT, int CT, int TX, int TY, int G, bool BULK, typename T>
__global__ void __launch_bounds__(TX * TY * G,
                                  TX * TY * G < 512 ? 512 / (TX * TY * G) : 1)
tail_conv_kernel(const T* __restrict__ x,          // (B, C, Hp, Wp)
                 const T* __restrict__ w,          // (C, K, K)
                 const T* __restrict__ bias,       // (1,)
                 T* __restrict__ out,              // (B, H, W)
                 int C, int H, int W, int pitch, int buf) {
  constexpr int GT = TX * TY;              // threads a group
  constexpr int BH = TY * RT, BW = TX * CT;
  constexpr int WIN = CT + K - 1;          // a row's window
  static_assert(CT % 2 == 0, "float2 windows");
  static_assert(GT % 32 == 0 && G <= 15, "groups of whole warps");
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);           // [G][2]
  float* s_w = reinterpret_cast<float*>(smem + 16 * G);          // [C][52]
  T* s_x = reinterpret_cast<T*>(s_w + (size_t)C * kWPitch);      // [G][2][buf]

  const int Hp = H + K - 1, Wp = W + K - 1;
  const int b = blockIdx.z, y0 = blockIdx.y * BH, x0 = blockIdx.x * BW;
  const int tid = threadIdx.x;
  const int grp = tid / GT, gt = tid - grp * GT;
  const int tx = gt % TX, ty = gt / TX;
  const T* xb = x + (size_t)b * C * Hp * Wp;
  const int cpg = (C + G - 1) / G;                  // channels a group
  const int c0 = grp * cpg;
  const int nch = max(0, min(C, c0 + cpg) - c0);

  for (int i = tid; i < C * kWPitch; i += blockDim.x) {
    const int c = i / kWPitch, k = i - c * kWPitch;
    s_w[i] = k < K * K ? to_float(w[c * K * K + k]) : 0.f;
  }
  if (BULK && tid < 2 * G) {
    mbar_init(&bars[tid], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int rows_in = min(BH + K - 1, Hp - y0);     // rows of x the band reads
  // the bulk copy's span of channel c0 + s: its band's rows widened to 16
  // bytes at both ends (exact in float32, where bulk_fits asks for it)
  auto span = [&](int s, uintptr_t* lo) {
    const T* band = xb + ((size_t)(c0 + s) * Hp + y0) * Wp;
    *lo = reinterpret_cast<uintptr_t>(band) & ~uintptr_t(15);
    const uintptr_t hi =
        (reinterpret_cast<uintptr_t>(band + (size_t)rows_in * Wp) + 15)
        & ~uintptr_t(15);
    return static_cast<unsigned>(hi - *lo);
  };
  auto issue = [&](int s) {                          // channel c0 + s
    T* dst = s_x + (size_t)(grp * 2 + (s & 1)) * buf;
    const T* plane = xb + (size_t)(c0 + s) * Hp * Wp;
    if constexpr (BULK) {
      if (gt == 0) {
        uintptr_t lo;
        const unsigned bytes = span(s, &lo);
        uint64_t* bar = &bars[grp * 2 + (s & 1)];
        mbar_expect_tx(bar, bytes);
        bulk_copy(dst, reinterpret_cast<const void*>(lo), bytes, bar);
      }
    } else {
      constexpr int RW = BW + K - 1;
      for (int i = gt; i < (BH + K - 1) * RW; i += GT) {
        const int r = i / RW, q = i - r * RW;
        const int gy = y0 + r, gx = x0 + q;
        const bool valid = gy < Hp && gx < Wp;
        stage1(dst + r * pitch + q,
               valid ? plane + (size_t)gy * Wp + gx : plane, valid);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
  };

  float acc[RT][CT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[r][j] = 0.f;

  if (nch > 0) issue(0);
  for (int s = 0; s < nch; ++s) {
    // the other buffer was released by the group_sync closing step s - 1
    const bool next = s + 1 < nch;
    if (next) issue(s + 1);
    if constexpr (BULK) {
      mbar_wait(&bars[grp * 2 + (s & 1)], (s >> 1) & 1);
    } else {
      if (next) {
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      group_sync(grp, GT);
    }
    // the bulk span starts up to 15 bytes before the band's first element
    int lead = 0;
    if constexpr (BULK && sizeof(T) < 4) {
      uintptr_t lo;
      span(s, &lo);
      lead = static_cast<int>(
          (reinterpret_cast<uintptr_t>(xb + ((size_t)(c0 + s) * Hp + y0) * Wp)
           - lo) / sizeof(T));
    }
    const T* xs = s_x + (size_t)(grp * 2 + (s & 1)) * buf + lead
                  + ty * RT * pitch + tx * CT;
    float wr[kWPitch];
    const float4* w4 = reinterpret_cast<const float4*>(
        s_w + (size_t)(c0 + s) * kWPitch);
#pragma unroll
    for (int q = 0; q < kWPitch / 4; ++q) {
      const float4 v = w4[q];
      wr[4 * q] = v.x;
      wr[4 * q + 1] = v.y;
      wr[4 * q + 2] = v.z;
      wr[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int iy = 0; iy < RT + K - 1; ++iy) {
      float win[WIN];
      const T* src = xs + iy * pitch;
#pragma unroll
      for (int q = 0; q < WIN / 2; ++q) {
        const float2 v = load2(src + 2 * q);
        win[2 * q] = v.x;
        win[2 * q + 1] = v.y;
      }
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const int r = iy - ky;             // the output row it feeds
        if (r >= 0 && r < RT) {
#pragma unroll
          for (int kx = 0; kx < K; ++kx)
#pragma unroll
            for (int j = 0; j < CT; ++j)
              acc[r][j] = fmaf(wr[ky * K + kx], win[j + kx], acc[r][j]);
        }
      }
    }
    group_sync(grp, GT);
  }

  // the groups' partial sums, added in group order through shared memory
  __syncthreads();
  if constexpr (G > 1) {
    float* part = reinterpret_cast<float*>(s_x);   // [G - 1][BH][BW]
    if (grp > 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < CT; ++j)
          part[((size_t)(grp - 1) * BH + ty * RT + r) * BW + tx * CT + j] =
              acc[r][j];
    }
    __syncthreads();
    if (grp > 0) return;
    for (int g = 0; g < G - 1; ++g)
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < CT; ++j)
          acc[r][j] += part[((size_t)g * BH + ty * RT + r) * BW + tx * CT + j];
  }
  const T bv = bias[0];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int oy = y0 + ty * RT + r;
    if (oy >= H) continue;
    T* ob = out + ((size_t)b * H + oy) * W;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int ox = x0 + tx * CT + j;
      if (ox < W) ob[ox] = finish(acc[r][j], bv);
    }
  }
}

// The shared memory of a shape; bulk: rows of pitch Wp, else BW + 8.  A
// bfloat16 bulk span may start 7 elements early and end 7 late.
template <int RT, int CT, int TX, int TY, int G, bool BULK, typename T>
Layout layout(int C, int W) {
  constexpr int BH = TY * RT, BW = TX * CT;
  constexpr int per16 = 16 / sizeof(T);         // elements in 16 bytes
  Layout L;
  L.pitch = BULK ? W + K - 1 : BW + 8;
  // a thread past the right edge reads up to column BW + 5 of the last row
  const int slack = BW + K - 1 - L.pitch > 0 ? BW + K - 1 - L.pitch : 0;
  const int widen = BULK && sizeof(T) < 4 ? 2 * per16 : 0;
  L.buf = ((BH + K - 1) * L.pitch + slack + widen + per16 - 1) / per16
          * per16;
  size_t xs = (size_t)G * 2 * L.buf * sizeof(T);
  if ((size_t)(G - 1) * BH * BW * 4 > xs) xs = (size_t)(G - 1) * BH * BW * 4;
  L.bytes = 16 * G + (size_t)C * kWPitch * 4 + xs;
  return L;
}

// Whether one cp.async.bulk per channel can move each band: the band is
// the whole width, and in float32 every span starts and ends on 16 bytes;
// in bfloat16 x starts and ends on 16 bytes (the widened spans stay
// inside it) and its rows have an even length (the pair reads).
template <int RT, int CT, int TX, int TY>
bool bulk_fits(const float* x, int B, int C, int H, int W) {
  constexpr int BH = TY * RT, BW = TX * CT;
  const long Hp = H + K - 1, Wp = W + K - 1;
  const long last = Hp - (long)((H - 1) / BH) * BH;   // rows of the last band
  return W <= BW && reinterpret_cast<uintptr_t>(x) % 16 == 0
         && (Hp * Wp * 4) % 16 == 0 && ((long)BH * Wp * 4) % 16 == 0
         && ((long)(BH + K - 1) * Wp * 4) % 16 == 0
         && ((last < BH + K - 1 ? last : BH + K - 1) * Wp * 4) % 16 == 0;
}

template <int RT, int CT, int TX, int TY>
bool bulk_fits(const __nv_bfloat16* x, int B, int C, int H, int W) {
  constexpr int BW = TX * CT;
  const long Wp = W + K - 1;
  return W <= BW && reinterpret_cast<uintptr_t>(x) % 16 == 0
         && ((long)B * C * (H + K - 1) * Wp * 2) % 16 == 0 && Wp % 2 == 0;
}

template <int RT, int CT, int TX, int TY, int G, bool BULK, typename T>
int launch(const T* x, const T* w, const T* bias, T* out, int B, int C,
           int H, int W, cudaStream_t stream) {
  constexpr int BH = TY * RT, BW = TX * CT;
  const Layout L = layout<RT, CT, TX, TY, G, BULK, T>(C, W);
  auto kernel = tail_conv_kernel<RT, CT, TX, TY, G, BULK, T>;
  // set on every launch (a host call of about a microsecond): a cached
  // flag would be one object for every library that instantiates this
  // shape, and another library's kernel would launch without the attribute
  if (L.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + BW - 1) / BW, (H + BH - 1) / BH, B);
  kernel<<<grid, TX * TY * G, L.bytes, stream>>>(x, w, bias, out, C, H, W,
                                                 L.pitch, L.buf);
  return static_cast<int>(cudaGetLastError());
}

// The bulk copy where it fits, else the element-wise staging.
template <int RT, int CT, int TX, int TY, int G, typename T>
int launch_any(const T* x, const T* w, const T* bias, T* out, int B, int C,
               int H, int W, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bulk_fits<RT, CT, TX, TY>(x, B, C, H, W))
    return launch<RT, CT, TX, TY, G, true>(x, w, bias, out, B, C, H, W, st);
  return launch<RT, CT, TX, TY, G, false>(x, w, bias, out, B, C, H, W, st);
}

}  // namespace dsf_tail

namespace {

constexpr int kRT = 8;               // output rows a thread
constexpr int kCT = 4;               // output columns a thread
constexpr int kTX = 32;              // threads across: 128 columns
constexpr int kTY = 2;               // threads down: a band of 16 rows
constexpr int kG = 4;                // channel groups of 64 threads

}  // namespace

extern "C" int dsf_tail_conv_tanh(const float* x, const float* w,
                                  const float* bias, float* out, int B,
                                  int C, int H, int W, void* stream) {
  return dsf_tail::launch_any<kRT, kCT, kTX, kTY, kG>(x, w, bias, out, B, C,
                                                      H, W, stream);
}

// the bfloat16 variant: bfloat16 in and out, float32 sums
extern "C" int dsf_tail_conv_tanh_bf16(const __nv_bfloat16* x,
                                       const __nv_bfloat16* w,
                                       const __nv_bfloat16* bias,
                                       __nv_bfloat16* out, int B, int C,
                                       int H, int W, void* stream) {
  return dsf_tail::launch_any<kRT, kCT, kTX, kTY, kG>(x, w, bias, out, B, C,
                                                      H, W, stream);
}
