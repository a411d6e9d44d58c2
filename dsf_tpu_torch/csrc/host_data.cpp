// host_data: the loader's host-side library (not a GPU kernel).
//
// A copy of the JAX package's native/dsf_host.cpp (the depth-aware crop,
// its batched forms with and without normalization, the fused post-warp
// thresholds and normalization, the NYU byte unpack), plus what the JAX
// package takes from OpenCV on the same path:
//
//   * png_nyu_depth / png_gray: the PNG row unfilter (all five filter
//     types, as libpng writes them through cv2.imwrite) fused with the
//     unpack of NYU's packed depth (G * 256 + B) or of a single-band
//     8- or 16-bit depth image (ICVL, SHREC, DHG; PIL's read of them);
//   * warp_affine_nearest / warp_perspective_nearest: cv2.warpAffine and
//     cv2.warpPerspective with INTER_NEAREST and BORDER_CONSTANT, rounding
//     as OpenCV 5 does (below);
//   * rotation_matrix_2d: cv2.getRotationMatrix2D.
//
// OpenCV 5's nearest warps invert the 2x3 / 3x3 matrix in double (the
// closed forms of warpAffine and of cv::invert for 3x3), cast it to float,
// and map each destination pixel in float: the row's base y*M1 + M2 (two
// roundings), then fma(M0, x, base); the perspective warp divides the two
// coordinates by fma(M6, x, y*M7 + M8); each coordinate rounds half to
// even.  (OpenCV up to 4.10 rounded in 10-bit fixed point for the affine
// warp and in double for the perspective one; tests/test_torch_data_nyu.py
// holds these against the cv2 installed beside the JAX package.)
//
// Build: dsf_tpu_torch/kernels/build.py compiles this file at first use
// with the host C++ compiler (c++ -O3 -shared -fPIC -pthread
// -ffp-contract=off); dsf_tpu_torch/data/native.py binds it with ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// comToBounds crop -> aspect-preserving nearest resize -> centered paste
// into (dsize x dsize); writes the 3x3 matrix M (row major) mapping
// full-frame px -> crop px (ref render_loader.py:748).
void crop_deep_pp(const float* depth, int H, int W, const float* com,
                  const float* cube, const float* paras, int dsize,
                  float* out_img, float* out_M) {
  const float fx = paras[0], fy = paras[1];
  const float u = com[0], v = com[1], z = com[2];
  const float sx = cube[0], sy = cube[1], sz = cube[2];

  const float zstart = z - sz / 2.f;
  const float zend = z + sz / 2.f;
  const int xstart = (int)std::floor((u * z / fx - sx / 2.f) / z * fx + 0.5f);
  const int xend = (int)std::floor((u * z / fx + sx / 2.f) / z * fx + 0.5f);
  const int ystart = (int)std::floor((v * z / fy - sy / 2.f) / z * fy + 0.5f);
  const int yend = (int)std::floor((v * z / fy + sy / 2.f) / z * fy + 0.5f);

  const int ch = yend - ystart;
  const int cw = xend - xstart;

  // crop with zero padding + z-threshold (getCrop semantics)
  std::vector<float> cropped((size_t)ch * cw, 0.f);
  for (int r = 0; r < ch; ++r) {
    const int src_r = ystart + r;
    if (src_r < 0 || src_r >= H) continue;
    for (int c = 0; c < cw; ++c) {
      const int src_c = xstart + c;
      if (src_c < 0 || src_c >= W) continue;
      float d = depth[(size_t)src_r * W + src_c];
      if (d != 0.f && d < zstart) d = zstart;
      else if (d != 0.f && d > zend) d = 0.f;
      cropped[(size_t)r * cw + c] = d;
    }
  }

  int szw, szh;
  if (cw > ch) { szw = dsize; szh = (int)((int64_t)ch * dsize / cw); }
  else { szh = dsize; szw = (int)((int64_t)cw * dsize / ch); }

  float scale;
  if (ch > cw) scale = (float)szh / (float)ch;
  else scale = (float)szw / (float)cw;

  // nearest resize as cv2's resizeNN: src = floor(dst * ifx) with
  // ifx = 1.0/((double)dst/src), both in double (at 186->128,
  // 64*(186.0/128) == 93 exactly but 64*(1/(128.0/186)) rounds below it)
  const double ify = 1.0 / ((double)szh / ch), ifx = 1.0 / ((double)szw / cw);
  std::vector<float> rz((size_t)szh * szw, 0.f);
  for (int r = 0; r < szh; ++r) {
    int sr = (int)((double)r * ify);
    if (sr >= ch) sr = ch - 1;
    for (int c = 0; c < szw; ++c) {
      int sc = (int)((double)c * ifx);
      if (sc >= cw) sc = cw - 1;
      rz[(size_t)r * szw + c] = cropped[(size_t)sr * cw + sc];
    }
  }

  std::memset(out_img, 0, sizeof(float) * (size_t)dsize * dsize);
  const int px = (int)std::floor(dsize / 2.f - szw / 2.f);
  const int py = (int)std::floor(dsize / 2.f - szh / 2.f);
  for (int r = 0; r < szh; ++r)
    std::memcpy(out_img + (size_t)(py + r) * dsize + px,
                rz.data() + (size_t)r * szw, sizeof(float) * szw);

  out_M[0] = scale; out_M[1] = 0.f; out_M[2] = scale * (float)(-xstart) + px;
  out_M[3] = 0.f; out_M[4] = scale; out_M[5] = scale * (float)(-ystart) + py;
  out_M[6] = 0.f; out_M[7] = 0.f; out_M[8] = 1.f;
}

// premax/0 -> far plane, clamp to the cube, map to [-1, 1], in place
// (ref render_loader.py:738-745)
void normalize_depth(float* img, int n, float premax, float com_z,
                     float cube_z) {
  const float far_v = com_z + cube_z / 2.f;
  const float near_v = com_z - cube_z / 2.f;
  for (int k = 0; k < n; ++k) {
    float d = img[k];
    if (d == premax || d == 0.f) d = far_v;
    if (d >= far_v) d = far_v;
    if (d <= near_v) d = near_v;
    img[k] = (d - com_z) / (cube_z / 2.f);
  }
}

// run body(b) for b in [0, B) on nthreads workers
template <class F>
void for_batch(int B, int nthreads, F body) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int b = next.fetch_add(1);
      if (b >= B) return;
      body(b);
    }
  };
  if (nthreads <= 1) { worker(); return; }
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; ++t) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

inline int round_half_even(float x) { return (int)std::nearbyint(x); }

inline float sample(const float* src, int H, int W, int x, int y,
                    float border) {
  return (x >= 0 && x < W && y >= 0 && y < H) ? src[(size_t)y * W + x]
                                                : border;
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the PNG row filters (None, Sub, Up, Average, Paeth) of H rows of
// a filter byte and rb bytes, the filters looking back bpp bytes (the
// bytes of a whole pixel: 3 for RGB, 2 for 16-bit gray), handing each
// unfiltered row to emit(r, row).  Returns 0, or the 1-based row whose
// filter byte is not 0-4.
template <class Emit>
int unfilter_rows(const uint8_t* raw, int H, int rb, int bpp, Emit emit) {
  std::vector<uint8_t> prev(rb, 0), cur(rb);
  for (int r = 0; r < H; ++r) {
    const uint8_t* line = raw + (size_t)r * (rb + 1);
    const uint8_t* x = line + 1;
    switch (line[0]) {
      case 0:
        std::memcpy(cur.data(), x, rb);
        break;
      case 1:
        for (int i = 0; i < rb; ++i)
          cur[i] = (uint8_t)(x[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < rb; ++i) cur[i] = (uint8_t)(x[i] + prev[i]);
        break;
      case 3:
        for (int i = 0; i < rb; ++i)
          cur[i] = (uint8_t)(x[i] + (((i >= bpp ? cur[i - bpp] : 0)
                                      + prev[i]) >> 1));
        break;
      case 4:
        for (int i = 0; i < rb; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int c = i >= bpp ? prev[i - bpp] : 0;
          cur[i] = (uint8_t)(x[i] + paeth(a, prev[i], c));
        }
        break;
      default:
        return r + 1;
    }
    emit(r, cur.data());
    std::swap(prev, cur);
  }
  return 0;
}

}  // namespace

extern "C" {

// crop + normalize for B samples on nthreads workers
void batch_crop_normalize(const float* depths, int B, int H, int W,
                          const float* coms, const float* cubes,
                          const float* paras, int dsize, float* out_imgs,
                          float* out_Ms, int nthreads) {
  for_batch(B, nthreads, [&](int b) {
    float* img = out_imgs + (size_t)b * dsize * dsize;
    crop_deep_pp(depths + (size_t)b * H * W, H, W, coms + 3 * b,
                 cubes + 3 * b, paras, dsize, img, out_Ms + 9 * b);
    float premax = 0.f;
    for (int k = 0; k < dsize * dsize; ++k) premax = std::max(premax, img[k]);
    normalize_depth(img, dsize * dsize, premax, coms[3 * b + 2],
                    cubes[3 * b + 2]);
  });
}

// crop WITHOUT normalization: the augmented path warps the raw-depth crop
// first and normalizes last (crop.augment_crop's order)
void batch_crop_raw(const float* depths, int B, int H, int W,
                    const float* coms, const float* cubes, const float* paras,
                    int dsize, float* out_imgs, float* out_Ms, int nthreads) {
  for_batch(B, nthreads, [&](int b) {
    crop_deep_pp(depths + (size_t)b * H * W, H, W, coms + 3 * b,
                 cubes + 3 * b, paras, dsize,
                 out_imgs + (size_t)b * dsize * dsize, out_Ms + 9 * b);
  });
}

// post-warp floor threshold + z-window + normalize, one pass per sample.
// flags bit0: x < floor -> 0; bit1: (x < zstart, x != 0) -> zstart and
// (x > zend, x != 0) -> 0.  Each cast point of the numpy per-sample path
// is mirrored: f32 pixels against f64 thresholds, f64 values stored into
// f32, the f32 com_z subtracted in f32, the f64 half-cube divided in f64.
void batch_finish_aug(float* imgs, int B, int n, const unsigned char* flags,
                      const float* floors, const double* zwins,
                      const float* premaxes, const float* com_zs,
                      const double* cube_zs, int nthreads) {
  for_batch(B, nthreads, [&](int b) {
    float* img = imgs + (size_t)b * n;
    if (flags[b] & 1) {
      const float fl = floors[b];
      for (int k = 0; k < n; ++k)
        if (img[k] < fl) img[k] = 0.f;
    }
    if (flags[b] & 2) {
      const double zs = zwins[2 * b], ze = zwins[2 * b + 1];
      const float zs_store = (float)zs;
      for (int k = 0; k < n; ++k) {
        const float d = img[k];
        if (d != 0.f && (double)d < zs) img[k] = zs_store;
        else if (d != 0.f && (double)d > ze) img[k] = 0.f;
      }
    }
    const float premax = premaxes[b];
    const float com_z = com_zs[b];
    const double cube_half = cube_zs[b] / 2.0;
    const double far64 = (double)com_z + cube_half;
    const double near64 = (double)com_z - cube_half;
    const float far_store = (float)far64;
    const float near_store = (float)near64;
    for (int k = 0; k < n; ++k) {
      float d = img[k];
      if (d == premax || d == 0.f) d = far_store;
      if ((double)d >= far64) d = far_store;
      if ((double)d <= near64) d = near_store;
      d = d - com_z;
      img[k] = (float)((double)d / cube_half);
    }
  });
}

// NYU packed depth (B + G * 256) from interleaved BGR bytes
void nyu_unpack(const uint8_t* bgr, int H, int W, float* out) {
  for (size_t k = 0; k < (size_t)H * W; ++k)
    out[k] = (float)bgr[3 * k] + (float)bgr[3 * k + 1] * 256.f;
}

// The inflated IDAT stream of an 8-bit RGB (channels 3) or RGBA (4) PNG,
// H rows of a filter byte and W * channels bytes, unfiltered row by row
// into NYU's depth G * 256 + B (the channels cv2.imread returns as
// [:, :, 1] and [:, :, 0]).  Returns 0, or the 1-based row whose filter
// byte is not 0-4.
int png_nyu_depth(const uint8_t* raw, int H, int W, int channels,
                  float* out) {
  return unfilter_rows(raw, H, W * channels, channels,
                       [&](int r, const uint8_t* cur) {
    float* o = out + (size_t)r * W;
    for (int k = 0; k < W; ++k)
      o[k] = (float)cur[k * channels + 2] + (float)cur[k * channels + 1] * 256.f;
  });
}

// The inflated IDAT stream of a single-band (grayscale) PNG of 8 (bytes
// 1) or 16 (bytes 2) bits a sample, unfiltered with the filters looking
// back one sample's bytes, into float32: 8-bit samples as they are,
// 16-bit ones big-endian (PNG's byte order).  Returns as png_nyu_depth.
int png_gray(const uint8_t* raw, int H, int W, int bytes, float* out) {
  return unfilter_rows(raw, H, W * bytes, bytes,
                       [&](int r, const uint8_t* cur) {
    float* o = out + (size_t)r * W;
    if (bytes == 1) {
      for (int k = 0; k < W; ++k) o[k] = (float)cur[k];
    } else {
      for (int k = 0; k < W; ++k)
        o[k] = (float)(((unsigned)cur[2 * k] << 8) | cur[2 * k + 1]);
    }
  });
}

// cv2.getRotationMatrix2D(center, angle, scale) -> 2x3, row major
void rotation_matrix_2d(float cx, float cy, double angle, double scale,
                        double* out) {
  angle *= M_PI / 180;
  const double alpha = std::cos(angle) * scale;
  const double beta = std::sin(angle) * scale;
  out[0] = alpha; out[1] = beta;
  out[2] = (1 - alpha) * (double)cx - beta * (double)cy;
  out[3] = -beta; out[4] = alpha;
  out[5] = beta * (double)cx + (1 - alpha) * (double)cy;
}

// cv2.warpAffine(src, M, (dW, dH), INTER_NEAREST, BORDER_CONSTANT, border)
// for a (H, W) float image; M (2x3, row major) maps src px -> dst px
void warp_affine_nearest(const float* src, int H, int W, const double* M0,
                         int dH, int dW, float border, float* dst) {
  double m[6];
  std::memcpy(m, M0, sizeof m);
  double D = m[0] * m[4] - m[1] * m[3];
  D = D != 0 ? 1. / D : 0;
  const double A11 = m[4] * D, A22 = m[0] * D;
  m[0] = A11; m[1] *= -D;
  m[3] *= -D; m[4] = A22;
  const double b1 = -m[0] * m[2] - m[1] * m[5];
  const double b2 = -m[3] * m[2] - m[4] * m[5];
  m[2] = b1; m[5] = b2;
  float f[6];
  for (int i = 0; i < 6; ++i) f[i] = (float)m[i];
  for (int y = 0; y < dH; ++y) {
    const float yf = (float)y;
    const float bx = yf * f[1] + f[2], by = yf * f[4] + f[5];
    float* o = dst + (size_t)y * dW;
    for (int x = 0; x < dW; ++x) {
      const float xf = (float)x;
      o[x] = sample(src, H, W, round_half_even(std::fmaf(f[0], xf, bx)),
                    round_half_even(std::fmaf(f[3], xf, by)), border);
    }
  }
}

// cv2.warpPerspective(src, M, (dW, dH), INTER_NEAREST, BORDER_CONSTANT,
// border) for a (H, W) float image; M (3x3, row major) maps src -> dst.
// Returns 1 (and writes nothing) where M is singular.
int warp_perspective_nearest(const float* src, int H, int W,
                             const double* S, int dH, int dW, float border,
                             float* dst) {
  // cv::invert's 3x3 closed form (DECOMP_LU, double)
  double d = S[0] * (S[4] * S[8] - S[5] * S[7])
           - S[1] * (S[3] * S[8] - S[5] * S[6])
           + S[2] * (S[3] * S[7] - S[4] * S[6]);
  if (d == 0.) return 1;
  d = 1. / d;
  const double t[9] = {
      (S[4] * S[8] - S[5] * S[7]) * d, (S[2] * S[7] - S[1] * S[8]) * d,
      (S[1] * S[5] - S[2] * S[4]) * d, (S[5] * S[6] - S[3] * S[8]) * d,
      (S[0] * S[8] - S[2] * S[6]) * d, (S[2] * S[3] - S[0] * S[5]) * d,
      (S[3] * S[7] - S[4] * S[6]) * d, (S[1] * S[6] - S[0] * S[7]) * d,
      (S[0] * S[4] - S[1] * S[3]) * d};
  float f[9];
  for (int i = 0; i < 9; ++i) f[i] = (float)t[i];
  for (int y = 0; y < dH; ++y) {
    const float yf = (float)y;
    const float bx = yf * f[1] + f[2], by = yf * f[4] + f[5],
                bw = yf * f[7] + f[8];
    float* o = dst + (size_t)y * dW;
    for (int x = 0; x < dW; ++x) {
      const float xf = (float)x;
      const float w = std::fmaf(f[6], xf, bw);
      const float sx = std::fmaf(f[0], xf, bx) / w;
      const float sy = std::fmaf(f[3], xf, by) / w;
      // beyond int range (w near 0, or NaN) is outside the image
      const bool in = std::fabs(sx) < 2e9f && std::fabs(sy) < 2e9f;
      o[x] = in ? sample(src, H, W, round_half_even(sx), round_half_even(sy),
                         border)
                : border;
    }
  }
  return 0;
}

}  // extern "C"
