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
// reference _reference_tail, :57-65).
//
// What bounds it on this card: both, about equally.  At the generator's
// shape (B=32, C=64, 134^2 in, 128^2 out) it reads 147 MB of x and writes
// 2 MB, 0.045 ms at 3.35 TB/s, and does 2 * 49 * 64 = 6272 float
// operations per output pixel, 3.29 GFLOP, 0.049 ms at 67 TFLOP/s.
//
// Design:
//  * a direct convolution: the TPU version's 145 MB tap-major buffer
//    exists for the matrix unit and VMEM; here one pass reads x and
//    writes the output, with nothing in between;
//  * one block per (image, 32 x 32 output tile), 256 threads; each thread
//    computes 4 consecutive outputs of one row;
//  * the tile's 38 x 38 halo is staged in shared memory 4 channels at a
//    time, with those channels' 4 x 49 weights (read by every thread at
//    one address: a broadcast).  Per (channel, tap row) a thread loads a
//    10-float window of its row into registers and does 28 fmaf with it,
//    so shared-memory loads are 10 per 28 multiply-adds;
//  * the halo row pitch is 39 floats, so the 4 rows a warp reads at once
//    fall in different banks (39 = 3 mod 4): no bank conflicts;
//  * neighbouring tiles overlap by the 6-pixel halo, so x is read
//    (38 / 32)^2 = 1.41 times over, the repeats mostly from L2;
//  * tanhf at the end (CUDA's, within 2 ulp); ragged tiles are masked.

#include <cuda_runtime.h>

namespace {

constexpr int K = 7;                       // taps per side
constexpr int kTile = 32;                  // output tile side
constexpr int kPerThread = 4;              // consecutive outputs a thread
constexpr int kThreadsX = kTile / kPerThread;
constexpr int kThreads = kThreadsX * kTile;   // 256
constexpr int kHalo = kTile + K - 1;       // 38
constexpr int kPitch = kHalo + 1;          // 39: conflict-free rows
constexpr int kChunk = 4;                  // channels staged at once
constexpr int kWindow = kPerThread + K - 1;   // 10

__global__ void __launch_bounds__(kThreads)
tail_conv_kernel(const float* __restrict__ x,      // (B, C, Hp, Wp)
                 const float* __restrict__ w,      // (C, K, K)
                 const float* __restrict__ bias,   // (1,)
                 float* __restrict__ out,          // (B, H, W)
                 int C, int H, int W) {
  __shared__ float s_x[kChunk][kHalo][kPitch];
  __shared__ float s_w[kChunk * K * K];
  const int Hp = H + K - 1, Wp = W + K - 1;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % kThreadsX, ty = threadIdx.x / kThreadsX;
  const float* xb = x + (size_t)b * C * Hp * Wp;

  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int nc = min(kChunk, C - c0);
    for (int i = threadIdx.x; i < kChunk * kHalo * kHalo; i += kThreads) {
      const int c = i / (kHalo * kHalo);
      const int r = (i / kHalo) % kHalo;
      const int q = i % kHalo;
      const int gy = y0 + r, gx = x0 + q;
      float v = 0.f;
      if (c < nc && gy < Hp && gx < Wp)
        v = xb[((size_t)(c0 + c) * Hp + gy) * Wp + gx];
      s_x[c][r][q] = v;
    }
    for (int i = threadIdx.x; i < kChunk * K * K; i += kThreads)
      s_w[i] = i < nc * K * K ? w[(size_t)c0 * K * K + i] : 0.f;
    __syncthreads();

    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const float* sr = &s_x[c][ty + ky][tx * kPerThread];
        float row[kWindow];
#pragma unroll
        for (int i = 0; i < kWindow; ++i) row[i] = sr[i];
        const float* wr = &s_w[(c * K + ky) * K];
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float wv = wr[kx];
#pragma unroll
          for (int j = 0; j < kPerThread; ++j)
            acc[j] = fmaf(wv, row[j + kx], acc[j]);
        }
      }
    }
    __syncthreads();
  }

  const int oy = y0 + ty;
  if (oy < H) {
    const float bv = bias[0];
    float* ob = out + ((size_t)b * H + oy) * W;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int ox = x0 + tx * kPerThread + j;
      if (ox < W) ob[ox] = tanhf(acc[j] + bv);
    }
  }
}

}  // namespace

extern "C" int dsf_tail_conv_tanh(const float* x, const float* w,
                                  const float* bias, float* out, int B,
                                  int C, int H, int W, void* stream) {
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  tail_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, C, H, W);
  return static_cast<int>(cudaGetLastError());
}
