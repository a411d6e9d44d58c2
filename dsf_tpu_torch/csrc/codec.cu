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
//  * decode: one block per (joint, image).  A first pass takes the block
//    max of 30 * heat * mask; a second pass sums exp(. - max) and exp
//    times each vote component; the joint is the ratio.  Background
//    pixels keep their exp(0 - max) softmax mass, as in the JAX path.
//    Coordinates come from the pixel index, as in the Pallas kernel's
//    _common.  The TPU version's 0/1 expansion matmuls were a layout
//    device for the matrix unit; here each block owns one joint row;
//  * decode VJP: the same (joint, image) blocks recompute the softmax
//    (max pass, then the mass Z and A = sum V * e in one pass), then write
//    d_unit = g * mask * dist * w and d_heat = mask * w * (scale (V - A)
//    - k U) for their joint row, and keep (max, Z) per row.  The depth
//    gradient dd(p) = sum_j w_j(p) g_jz sums over joints, across those
//    blocks: a second kernel with one thread per pixel loops the J joints
//    and recomputes w_j(p) from the kept (max, Z).  No float atomics, so
//    the result does not change from run to run;
//  * encode VJP: a grid over (pixel block, image), one thread per pixel
//    looping the J joints.  It recomputes dist, 1/dist and the cone mask
//    exactly as the forward does (round-to-nearest, same order), forms
//    d_off, and sums -d_off_z over joints for the image gradient in the
//    thread.  The joint gradient sums d_off over all pixels: each block
//    reduces its pixels (warp shuffles, then across warps) into one
//    partial row of 3J per block, and a second kernel sums the partials
//    of an image in block order.  Deterministic, no atomics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kEncThreads = 256;
constexpr int kDecThreads = 256;

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

template <int N>
__device__ __forceinline__ void block_sum(float (&x)[N], float* s_red) {
  // s_red: N * (kDecThreads / 32) floats
  for (int off = 16; off > 0; off >>= 1)
    for (int n = 0; n < N; ++n)
      x[n] += __shfl_xor_sync(0xffffffffu, x[n], off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kDecThreads / 32;
  if (lane == 0)
    for (int n = 0; n < N; ++n) s_red[n * kWarps + warp] = x[n];
  __syncthreads();
  for (int n = 0; n < N; ++n) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += s_red[n * kWarps + w];
    x[n] = t;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kDecThreads)
decode_fwd_kernel(const float* __restrict__ x,      // (B, 4J, S*S)
                  const float* __restrict__ depth,  // (B, S*S)
                  float* __restrict__ out,          // (B, J, 3)
                  int J, int S, float k, float scale) {
  __shared__ float s_red[4 * (kDecThreads / 32)];
  const int j = blockIdx.x, b = blockIdx.y;
  const int P = S * S;
  const float* xb = x + (size_t)b * 4 * J * P;
  const float* ux = xb + (size_t)(3 * j) * P;
  const float* uy = ux + P;
  const float* uz = uy + P;
  const float* heat = xb + (size_t)(3 * J + j) * P;
  const float* d = depth + (size_t)b * P;

  // pass 1: max over pixels of scale * heat * mask
  float mx = -INFINITY;
  for (int p = threadIdx.x; p < P; p += kDecThreads) {
    const float mask = d[p] < 0.99f ? 1.f : 0.f;
    mx = fmaxf(mx, __fmul_rn(__fmul_rn(heat[p], mask), scale));
  }
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = mx;
  __syncthreads();
  mx = s_red[0];
  for (int w = 1; w < kDecThreads / 32; ++w) mx = fmaxf(mx, s_red[w]);
  __syncthreads();

  // pass 2: softmax mass and weighted votes
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p = threadIdx.x; p < P; p += kDecThreads) {
    const float dp = d[p];
    const float mask = dp < 0.99f ? 1.f : 0.f;
    const float hm = __fmul_rn(heat[p], mask);
    const float e = expf(__fsub_rn(__fmul_rn(hm, scale), mx));
    const float dist = __fsub_rn(k, __fmul_rn(hm, k));
    const float vx = __fadd_rn(__fmul_rn(__fmul_rn(ux[p], mask), dist),
                               pix_coord(p % S, S));
    const float vy = __fadd_rn(__fmul_rn(__fmul_rn(uy[p], mask), dist),
                               pix_coord(p / S, S));
    const float vz = __fadd_rn(__fmul_rn(__fmul_rn(uz[p], mask), dist), dp);
    acc[0] += e;
    acc[1] += vx * e;
    acc[2] += vy * e;
    acc[3] += vz * e;
  }
  block_sum<4>(acc, s_red);
  if (threadIdx.x == 0) {
    float* o = out + ((size_t)b * J + j) * 3;
    o[0] = acc[1] / acc[0];
    o[1] = acc[2] / acc[0];
    o[2] = acc[3] / acc[0];
  }
}

__global__ void __launch_bounds__(kDecThreads)
decode_bwd_kernel(const float* __restrict__ x,      // (B, 4J, S*S)
                  const float* __restrict__ depth,  // (B, S*S)
                  const float* __restrict__ g,      // (B, J, 3)
                  float* __restrict__ dx,           // (B, 4J, S*S)
                  float* __restrict__ stats,        // (B, J, 2): max, Z
                  int J, int S, float k, float scale) {
  __shared__ float s_red[4 * (kDecThreads / 32)];
  const int j = blockIdx.x, b = blockIdx.y;
  const int P = S * S;
  const size_t row = (size_t)b * 4 * J * P;
  const float* ux = x + row + (size_t)(3 * j) * P;
  const float* uy = ux + P;
  const float* uz = uy + P;
  const float* heat = x + row + (size_t)(3 * J + j) * P;
  float* dux = dx + row + (size_t)(3 * j) * P;
  float* duy = dux + P;
  float* duz = duy + P;
  float* dheat = dx + row + (size_t)(3 * J + j) * P;
  const float* d = depth + (size_t)b * P;
  const float* gj = g + ((size_t)b * J + j) * 3;
  const float gx = gj[0], gy = gj[1], gz = gj[2];

  // pass 1: max over pixels of scale * heat * mask (as the forward)
  float mx = -INFINITY;
  for (int p = threadIdx.x; p < P; p += kDecThreads) {
    const float mask = d[p] < 0.99f ? 1.f : 0.f;
    mx = fmaxf(mx, __fmul_rn(__fmul_rn(heat[p], mask), scale));
  }
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = mx;
  __syncthreads();
  mx = s_red[0];
  for (int w = 1; w < kDecThreads / 32; ++w) mx = fmaxf(mx, s_red[w]);
  __syncthreads();

  // pass 2: softmax mass Z and sum of V * e, where V is the cotangent's
  // derivative with respect to the weight w (the vote dotted with g)
  float acc[2] = {0.f, 0.f};
  for (int p = threadIdx.x; p < P; p += kDecThreads) {
    const float dp = d[p];
    const float mask = dp < 0.99f ? 1.f : 0.f;
    const float hm = __fmul_rn(heat[p], mask);
    const float e = expf(__fsub_rn(__fmul_rn(hm, scale), mx));
    const float dist = __fsub_rn(k, __fmul_rn(hm, k));
    const float U = mask * (ux[p] * gx + uy[p] * gy + uz[p] * gz);
    const float V = dist * U + (gx * pix_coord(p % S, S)
                                + gy * pix_coord(p / S, S) + gz * dp);
    acc[0] += e;
    acc[1] += V * e;
  }
  block_sum<2>(acc, s_red);
  const float Z = acc[0];
  const float A = acc[1] / Z;

  // pass 3: the gradient of the joint row's unit and heat channels
  for (int p = threadIdx.x; p < P; p += kDecThreads) {
    const float dp = d[p];
    const float mask = dp < 0.99f ? 1.f : 0.f;
    const float hm = __fmul_rn(heat[p], mask);
    const float w = expf(__fsub_rn(__fmul_rn(hm, scale), mx)) / Z;
    const float dist = __fsub_rn(k, __fmul_rn(hm, k));
    const float U = mask * (ux[p] * gx + uy[p] * gy + uz[p] * gz);
    const float V = dist * U + (gx * pix_coord(p % S, S)
                                + gy * pix_coord(p / S, S) + gz * dp);
    const float dw = dist * w;
    dux[p] = gx * mask * dw;
    duy[p] = gy * mask * dw;
    duz[p] = gz * mask * dw;
    dheat[p] = mask * w * (scale * (V - A) - k * U);
  }
  if (threadIdx.x == 0) {
    float* st = stats + ((size_t)b * J + j) * 2;
    st[0] = mx;
    st[1] = Z;
  }
}

__global__ void __launch_bounds__(kEncThreads)
decode_bwd_depth_kernel(const float* __restrict__ x,      // (B, 4J, S*S)
                        const float* __restrict__ depth,  // (B, S*S)
                        const float* __restrict__ g,      // (B, J, 3)
                        const float* __restrict__ stats,  // (B, J, 2)
                        float* __restrict__ dd,           // (B, S*S)
                        int J, int S, float scale) {
  extern __shared__ float s_st[];                         // 3J: max, Z, gz
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < J; i += blockDim.x) {
    s_st[3 * i] = stats[((size_t)b * J + i) * 2];
    s_st[3 * i + 1] = stats[((size_t)b * J + i) * 2 + 1];
    s_st[3 * i + 2] = g[((size_t)b * J + i) * 3 + 2];
  }
  __syncthreads();
  const int P = S * S;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float mask = depth[(size_t)b * P + p] < 0.99f ? 1.f : 0.f;
  const float* heat = x + (size_t)b * 4 * J * P + (size_t)(3 * J) * P + p;
  float acc = 0.f;
  for (int j = 0; j < J; ++j) {
    const float hm = __fmul_rn(heat[(size_t)j * P], mask);
    const float w = expf(__fsub_rn(__fmul_rn(hm, scale), s_st[3 * j]))
                    / s_st[3 * j + 1];
    acc += w * s_st[3 * j + 2];
  }
  dd[(size_t)b * P + p] = acc;
}

__global__ void __launch_bounds__(kEncThreads)
encode_bwd_kernel(const float* __restrict__ joints,  // (B, J, 3)
                  const float* __restrict__ img,     // (B, S*S)
                  const float* __restrict__ g,       // (B, 4J, S*S)
                  float* __restrict__ dd,            // (B, S*S)
                  float* __restrict__ part,          // (B, nblk, 3J)
                  int J, int S, float k) {
  constexpr int kWarps = kEncThreads / 32;
  extern __shared__ float s_mem[];
  float* s_j = s_mem;                                 // 3J
  float* s_red = s_mem + 3 * J;                       // kWarps x 3J
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 3 * J; i += blockDim.x)
    s_j[i] = joints[(size_t)b * 3 * J + i];
  __syncthreads();
  const int P = S * S;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = p < P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float u = 0.f, v = 0.f, d = 0.f, fg = 0.f;
  if (active) {
    u = pix_coord(p % S, S);
    v = pix_coord(p / S, S);
    d = img[(size_t)b * P + p];
    fg = d < 0.99f ? 1.f : 0.f;
  }
  const float* gb = g + (size_t)b * 4 * J * P + p;
  float dz_sum = 0.f;
  for (int j = 0; j < J; ++j) {
    float dox = 0.f, doy = 0.f, doz = 0.f;
    if (active) {
      // the forward's offsets, distance and cone mask, rounded as there
      const float ox = __fsub_rn(s_j[3 * j], u);
      const float oy = __fsub_rn(s_j[3 * j + 1], v);
      const float oz = __fsub_rn(s_j[3 * j + 2], d);
      const float ss = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)),
                    __fmul_rn(oz, oz)), 1e-8f);
      const float dist = __fsqrt_rn(ss);
      const float heat = __fdiv_rn(__fsub_rn(k, dist), k);
      const float m = __fmul_rn(heat >= 0.f ? 1.f : 0.f, fg);
      const float rd = __fdiv_rn(1.f, dist);
      const float gux = gb[(size_t)(3 * j) * P];
      const float guy = gb[(size_t)(3 * j + 1) * P];
      const float guz = gb[(size_t)(3 * j + 2) * P];
      const float gh = gb[(size_t)(3 * J + j) * P];
      // d(unit)/d(dist) summed over the joint's 3 rows, and d(heat)/d(dist)
      const float su = gux * ox + guy * oy + guz * oz;
      const float ddist = -m * (rd * rd * su + gh / k);
      const float mrd = m * rd, t = rd * ddist;
      dox = gux * mrd + ox * t;
      doy = guy * mrd + oy * t;
      doz = guz * mrd + oz * t;
    }
    dz_sum += doz;
    for (int off = 16; off > 0; off >>= 1) {
      dox += __shfl_xor_sync(0xffffffffu, dox, off);
      doy += __shfl_xor_sync(0xffffffffu, doy, off);
      doz += __shfl_xor_sync(0xffffffffu, doz, off);
    }
    if (lane == 0) {
      s_red[warp * 3 * J + 3 * j] = dox;
      s_red[warp * 3 * J + 3 * j + 1] = doy;
      s_red[warp * 3 * J + 3 * j + 2] = doz;
    }
  }
  if (active) dd[(size_t)b * P + p] = -dz_sum;
  __syncthreads();
  float* pb = part + ((size_t)b * gridDim.x + blockIdx.x) * 3 * J;
  for (int c = threadIdx.x; c < 3 * J; c += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += s_red[w * 3 * J + c];
    pb[c] = t;
  }
}

__global__ void encode_bwd_reduce_kernel(const float* __restrict__ part,
                                         float* __restrict__ dj,  // (B, 3J)
                                         int nblk, int n) {
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float t = 0.f;
    for (int i = 0; i < nblk; ++i) t += part[((size_t)b * nblk + i) * n + c];
    dj[(size_t)b * n + c] = t;
  }
}

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

extern "C" int dsf_codec_decode(const float* x, const float* depth,
                                float* out, int B, int J, int S, float k,
                                float scale, void* stream) {
  const dim3 grid(J, B);
  decode_fwd_kernel<<<grid, kDecThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, depth, out, J,
                                                           S, k, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsf_codec_decode_bwd(const float* x, const float* depth,
                                    const float* g, float* dx, float* dd,
                                    float* stats, int B, int J, int S,
                                    float k, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_bwd_kernel<<<dim3(J, B), kDecThreads, 0, st>>>(x, depth, g, dx,
                                                         stats, J, S, k,
                                                         scale);
  const int P = S * S;
  const dim3 grid((P + kEncThreads - 1) / kEncThreads, B);
  decode_bwd_depth_kernel<<<grid, kEncThreads, 3 * J * sizeof(float), st>>>(
      x, depth, g, stats, dd, J, S, scale);
  return static_cast<int>(cudaGetLastError());
}

// ``part`` holds B * ceil(S*S / 256) * 3J floats of scratch.
extern "C" int dsf_codec_encode_bwd(const float* joints, const float* img,
                                    const float* g, float* dj, float* dd,
                                    float* part, int B, int J, int S,
                                    float k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = S * S;
  const int nblk = (P + kEncThreads - 1) / kEncThreads;
  const size_t smem = (size_t)3 * J * (1 + kEncThreads / 32) * sizeof(float);
  encode_bwd_kernel<<<dim3(nblk, B), kEncThreads, smem, st>>>(
      joints, img, g, dd, part, J, S, k);
  encode_bwd_reduce_kernel<<<B, 128, 0, st>>>(part, dj, nblk, 3 * J);
  return static_cast<int>(cudaGetLastError());
}
