// The face set-up of the raster kernels K1 (raster_skip.cu), K6
// (raster_dense.cu) and K10 (raster_binned.cu), on the card: one thread
// per (image, face) builds
//
//  * the face's 16-float row, bitwise-equal to rasterize.face_rows (the
//    plain version): rasterize.face_coeffs rounds every product and sum on
//    its own, left to right, so each is written with __fmul_rn /
//    __fadd_rn / __fsub_rn in that order (nvcc would otherwise contract to
//    FMAs); 1.0 / A is PyTorch's IEEE-rounded reciprocal (__frcp_rn, not a
//    fast one), and torch.sign(0) is 0;
//  * the face's cover box (umin, umax, vmin, vmax; cover_box below,
//    rasterize.cover_boxes bitwise): its screen box widened to every
//    sample its rounded edge test can pass, empty (+inf, -inf) for an
//    invalid face, so that no box test passes it; and for K10 its screen
//    box (vbox), the test of its tile lists;
//  * per block of kCull faces, the union of its faces' cover boxes (the
//    chunk box), which lets a raster block skip a whole chunk with one
//    test.
//
// It replaces about 25 eager PyTorch launches per raster call
// (rasterize.skip_tables); each library that includes it exports a C
// entry point for it, so a raster route needs no other library.
//
// K10 adds its bins (bin_count_kernel, a second launch: it reads every
// face box of its image, which the first launch's blocks write): per
// (image, 16x16 tile), the box of the tile's samples and the number of
// faces whose screen box meets it, and a flag raised when any tile holds
// more than the cap (rasterize.binned_tables' counts and overflow).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "raster_rows.cuh"

namespace dsf_raster {

// rasterize.COVER_*: the bounds of the cover box
constexpr double kCoverRel = 0x1p-22;
constexpr double kCoverAbs = 0x1p-140;
constexpr double kCoverSin = 0x1p-16;
constexpr double kCoverPad = 0x1p-10;
constexpr double kCoverPadRel = 0x1p-20;

// A valid face's cover box from its edge coefficients a, b, c (as its row
// holds them) and its screen box, as rasterize.cover_boxes computes it:
// the same float64 operations in the same order, each rounded on its own
// (__d*_rn: nvcc would otherwise contract them), so the two are bitwise
// equal.  Where the edge test passes at (u, v), a*u + b*v + c >= -kCoverRel
// (|a u| + |b v|) - kCoverAbs; per quadrant of the plane that is a
// half-plane per edge, and the three meet in a triangle whose corners
// bound the box.  The whole plane where the corners are not to be trusted.
__device__ __forceinline__ float4 cover_box(const float (&a)[3],
                                            const float (&b)[3],
                                            const float (&c)[3],
                                            float4 screen) {
  double ad[3], bd[3], cd[3], ga[3], gb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ad[k] = a[k];
    bd[k] = b[k];
    cd[k] = __dadd_rn((double)c[k], kCoverAbs);
    ga[k] = __dmul_rn(fabs(ad[k]), kCoverRel);
    gb[k] = __dmul_rn(fabs(bd[k]), kCoverRel);
  }
  double umin = screen.x, umax = screen.y, vmin = screen.z, vmax = screen.w;
  bool ok = true;
#pragma unroll
  for (int qu = 0; qu < 2; ++qu) {
    double ap[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) ap[k] = __dadd_rn(ad[k], qu ? ga[k] : -ga[k]);
#pragma unroll
    for (int qv = 0; qv < 2; ++qv) {
      double bp[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        bp[k] = __dadd_rn(bd[k], qv ? gb[k] : -gb[k]);
      bool side[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int j = m, k = m == 2 ? 0 : m + 1;
        const double p = __dmul_rn(ap[j], bp[k]), q = __dmul_rn(ap[k], bp[j]);
        const double det = __dsub_rn(p, q);
        const double u = __ddiv_rn(
            __dsub_rn(__dmul_rn(bp[j], cd[k]), __dmul_rn(bp[k], cd[j])), det);
        const double v = __ddiv_rn(
            __dsub_rn(__dmul_rn(ap[k], cd[j]), __dmul_rn(ap[j], cd[k])), det);
        ok = ok && fabs(det) > __dmul_rn(__dadd_rn(fabs(p), fabs(q)),
                                         kCoverSin) &&
             isfinite(u) && isfinite(v);
        side[m] = det > 0.0;
        umin = fmin(umin, u);
        umax = fmax(umax, u);
        vmin = fmin(vmin, v);
        vmax = fmax(vmax, v);
      }
      ok = ok && side[0] == side[1] && side[1] == side[2];
    }
  }
  if (!ok) return make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  auto pad = [](double x) {
    return __dadd_rn(kCoverPad, __dmul_rn(fabs(x), kCoverPadRel));
  };
  return make_float4(__double2float_rn(__dsub_rn(umin, pad(umin))),
                     __double2float_rn(__dadd_rn(umax, pad(umax))),
                     __double2float_rn(__dsub_rn(vmin, pad(vmin))),
                     __double2float_rn(__dadd_rn(vmax, pad(vmax))));
}

// Idx: the faces' index type (int32_t, or int64_t as the mesh holds
// them).  vbox and flag are K10's, null for K1 and K6: vbox takes each
// face's screen box, and flag (the overflow flag, which bin_count_kernel
// then raises) is zeroed.
template <typename Idx>
__global__ void __launch_bounds__(kCull)
face_setup_kernel(const float* __restrict__ proj,      // (B, V, 3)
                  const Idx* __restrict__ faces,       // (F, 3)
                  float* __restrict__ rows,            // (B, F, 16)
                  float* __restrict__ boxes,           // (B, F, 4)
                  float* __restrict__ cbox,            // (B, nc, 4)
                  float* __restrict__ vbox,            // (B, F, 4) or null
                  int32_t* __restrict__ flag,          // (1,) or null
                  int V, int F) {
  __shared__ float s_part[4][kCull / 32];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int f = blockIdx.x * kCull + tid;
  if (flag != nullptr && f == 0 && b == 0) *flag = 0;
  float4 box = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  if (f < F) {
    const float* pb = proj + (size_t)b * V * 3;
    const float* p0 = pb + 3 * faces[3 * f];
    const float* p1 = pb + 3 * faces[3 * f + 1];
    const float* p2 = pb + 3 * faces[3 * f + 2];
    const float u0 = p0[0], v0 = p0[1], z0 = p0[2];
    const float u1 = p1[0], v1 = p1[1], z1 = p1[2];
    const float u2 = p2[0], v2 = p2[1], z2 = p2[2];
    const float c0 = __fsub_rn(__fmul_rn(u1, v2), __fmul_rn(u2, v1));
    const float c1 = __fsub_rn(__fmul_rn(u2, v0), __fmul_rn(u0, v2));
    const float c2 = __fsub_rn(__fmul_rn(u0, v1), __fmul_rn(u1, v0));
    const float A = __fadd_rn(__fadd_rn(c0, c1), c2);   // 2x signed area
    const bool valid = fabsf(A) > 1e-9f;
    const float sgn = (A > 0.f ? 1.f : 0.f) - (A < 0.f ? 1.f : 0.f);
    const float a0 = __fmul_rn(__fsub_rn(v1, v2), sgn);
    const float a1 = __fmul_rn(__fsub_rn(v2, v0), sgn);
    const float a2 = __fmul_rn(__fsub_rn(v0, v1), sgn);
    const float b0 = __fmul_rn(__fsub_rn(u2, u1), sgn);
    const float b1 = __fmul_rn(__fsub_rn(u0, u2), sgn);
    const float b2 = __fmul_rn(__fsub_rn(u1, u0), sgn);
    const float c0s = __fmul_rn(c0, sgn);
    const float c1s = __fmul_rn(c1, sgn);
    const float c2s = __fmul_rn(c2, sgn);
    const float w = __fmul_rn(sgn, valid ? __frcp_rn(A) : 0.f);
    const float az = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(a0, z0),
                                                   __fmul_rn(a1, z1)),
                                         __fmul_rn(a2, z2)), w);
    const float bz = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(b0, z0),
                                                   __fmul_rn(b1, z1)),
                                         __fmul_rn(b2, z2)), w);
    const float cz = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(c0s, z0),
                                                   __fmul_rn(c1s, z1)),
                                         __fmul_rn(c2s, z2)), w);
    float4* row = reinterpret_cast<float4*>(rows) + ((size_t)b * F + f) * 4;
    row[0] = make_float4(a0, b0, c0s, a1);
    row[1] = make_float4(b1, c1s, a2, b2);
    row[2] = make_float4(c2s, az, bz, cz);
    row[3] = make_float4(valid ? 1.f : 0.f, 0.f, 0.f, 0.f);
    float4 screen = box;
    if (valid) {
      screen = make_float4(fminf(fminf(u0, u1), u2), fmaxf(fmaxf(u0, u1), u2),
                           fminf(fminf(v0, v1), v2), fmaxf(fmaxf(v0, v1), v2));
      const float ea[3] = {a0, a1, a2}, eb[3] = {b0, b1, b2};
      const float ec[3] = {c0s, c1s, c2s};
      box = cover_box(ea, eb, ec, screen);
    }
    reinterpret_cast<float4*>(boxes)[(size_t)b * F + f] = box;
    if (vbox != nullptr)
      reinterpret_cast<float4*>(vbox)[(size_t)b * F + f] = screen;
  }
  // the chunk box: the union over the block's faces
  float4 r = box;
  for (int off = 16; off > 0; off >>= 1) {
    r.x = fminf(r.x, __shfl_xor_sync(0xffffffffu, r.x, off));
    r.y = fmaxf(r.y, __shfl_xor_sync(0xffffffffu, r.y, off));
    r.z = fminf(r.z, __shfl_xor_sync(0xffffffffu, r.z, off));
    r.w = fmaxf(r.w, __shfl_xor_sync(0xffffffffu, r.w, off));
  }
  if ((tid & 31) == 0) {
    s_part[0][tid >> 5] = r.x;
    s_part[1][tid >> 5] = r.y;
    s_part[2][tid >> 5] = r.z;
    s_part[3][tid >> 5] = r.w;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kCull / 32; ++k) {
      r.x = fminf(r.x, s_part[0][k]);
      r.y = fmaxf(r.y, s_part[1][k]);
      r.z = fminf(r.z, s_part[2][k]);
      r.w = fmaxf(r.w, s_part[3][k]);
    }
    reinterpret_cast<float4*>(cbox)[(size_t)b * gridDim.x + blockIdx.x] = r;
  }
}

// Launch the set-up over B images of V vertices and F faces on stream.
template <typename Idx>
int launch_face_setup(const float* proj, const Idx* faces, float* rows,
                      float* boxes, float* cbox, int B, int V, int F,
                      void* stream, float* vbox = nullptr,
                      int32_t* flag = nullptr) {
  const dim3 grid((F + kCull - 1) / kCull, B);
  face_setup_kernel<Idx><<<grid, kCull, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      proj, faces, rows, boxes, cbox, vbox, flag, V, F);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBin = 16;             // K10's tile side, rasterize.BIN_TILE
constexpr int kBinAhead = 8;         // chunks a bin count loads at once

// One block of kBin^2 = kCull threads per (image, 16x16 tile) of a
// row-major H x W sample layout (pix sample p of image b at
// pix[b * sb + p * sp], its v one float on): the tile's sample box
// (fminf / fmaxf, exact as amin / amax are) into tbox = (umin, umax,
// vmin, vmax), and into counts the faces whose screen box (vbox) meets it
// inclusively, with no margin.  A chunk box (which holds its faces'
// screen boxes) that misses it skips its 256 faces; the others are
// counted a face a thread, by ballot and popc, the screen boxes of
// kBinAhead chunks in flight at once (MANO's 1554 faces: all 7).  A count
// above cap raises flag (a plain store of 1: the same in any order).
// Invalid faces have empty boxes, which meet nothing.
__global__ void __launch_bounds__(kCull)
bin_count_kernel(const float* __restrict__ pix,     // see above
                 const float4* __restrict__ vbox,   // (B, F)
                 const float4* __restrict__ cbox,   // (B, nc)
                 float4* __restrict__ tbox,         // (B, G)
                 int32_t* __restrict__ counts,      // (B, G)
                 int32_t* __restrict__ flag,        // (1,)
                 int sb, int sp, int F, int W, int cap) {
  static_assert(kBin * kBin == kCull, "a tile's samples fill the block");
  constexpr int kWarps = kCull / 32;
  __shared__ float s_part[4][kWarps];
  __shared__ int s_n[kWarps];
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = W / kBin;
  const int x = (blockIdx.x % tiles_x) * kBin + (tid % kBin);
  const int y = (blockIdx.x / tiles_x) * kBin + tid / kBin;
  const float* uv = pix + (long long)b * sb + ((long long)y * W + x) * sp;
  float r0 = uv[0], r1 = r0, r2 = uv[1], r3 = r2;
  for (int off = 16; off > 0; off >>= 1) {
    r0 = fminf(r0, __shfl_xor_sync(0xffffffffu, r0, off));
    r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, off));
    r2 = fminf(r2, __shfl_xor_sync(0xffffffffu, r2, off));
    r3 = fmaxf(r3, __shfl_xor_sync(0xffffffffu, r3, off));
  }
  if (lane == 0) {
    s_part[0][warp] = r0;
    s_part[1][warp] = r1;
    s_part[2][warp] = r2;
    s_part[3][warp] = r3;
  }
  __syncthreads();
  for (int k = 0; k < kWarps; ++k) {
    r0 = fminf(r0, s_part[0][k]);
    r1 = fmaxf(r1, s_part[1][k]);
    r2 = fminf(r2, s_part[2][k]);
    r3 = fmaxf(r3, s_part[3][k]);
  }

  const int nc = (F + kCull - 1) / kCull;
  const float4* bb = vbox + (size_t)b * F;
  const float4* cb = cbox + (size_t)b * nc;
  const float4 none = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  int n = 0;                                    // this warp's count
  for (int c0 = 0; c0 < nc; c0 += kBinAhead) {
    // the face boxes of kBinAhead chunks loaded at once, then tested
    float4 fb[kBinAhead];
#pragma unroll
    for (int k = 0; k < kBinAhead; ++k) {
      const int c = c0 + k, f = c * kCull + tid;
      fb[k] = c < nc && f < F && meets(cb[c], r0, r1, r2, r3) ? bb[f] : none;
    }
#pragma unroll
    for (int k = 0; k < kBinAhead; ++k)
      n += __popc(__ballot_sync(0xffffffffu, meets(fb[k], r0, r1, r2, r3)));
  }
  if (lane == 0) s_n[warp] = n;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int k = 0; k < kWarps; ++k) total += s_n[k];
    const size_t g = (size_t)b * gridDim.x + blockIdx.x;
    tbox[g] = make_float4(r0, r1, r2, r3);
    counts[g] = total;
    if (total > cap) *flag = 1;
  }
}

// K10's set-up: the face set-up (which zeroes flag), then the bins of the
// B x (H / 16) x (W / 16) tiles.
template <typename Idx>
int launch_bin_setup(const float* proj, const Idx* faces, const float* pix,
                     float* rows, float* boxes, float* cbox, float* vbox,
                     float* tbox, int32_t* counts, int32_t* flag, int B,
                     int V, int F,
                     int H, int W, int sb, int sp, int cap,
                     void* stream) {
  const int err = launch_face_setup(proj, faces, rows, boxes, cbox, B, V, F,
                                    stream, vbox, flag);
  if (err != 0) return err;
  const dim3 grid((H / kBin) * (W / kBin), B);
  bin_count_kernel<<<grid, kCull, 0, static_cast<cudaStream_t>(stream)>>>(
      pix, reinterpret_cast<const float4*>(vbox),
      reinterpret_cast<const float4*>(cbox), reinterpret_cast<float4*>(tbox),
      counts, flag, sb, sp, F, W, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dsf_raster
