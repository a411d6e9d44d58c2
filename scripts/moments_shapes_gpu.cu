// Candidate layouts of K2 that scripts/moments_shapes_gpu.py times beside
// the library's own.  The library's source is included whole (design (a):
// pixel-major, a warp's own copy of the sums, the CTAs of an image merged
// in a cluster); its template dsf_moments::launch takes any warp count,
// rounds a step and split.  This adds design (b), face-major:
//  * a range kernel finds each face's first and last pixel with integer
//    atomicMin (on p and on ~p, over a table set to 0xFF bytes), whose
//    result does not depend on their order;
//  * a walk kernel gives each (image, face) one warp, which reads the ids
//    from the face's first pixel to its last, 128 a step (4 a lane, one
//    16-byte load where the ids are aligned), and adds the rows of the
//    pixels that hold the face in ascending pixel order: the order of a
//    sequential scatter, so the sums equal index_add_'s on the CPU
//    bitwise.  K2 is given flat ids, so a face's range spans whole image
//    rows: a face that meets r rows walks about r image widths.
// candidate runs a layout of (a), with the library's quads (vec) or every
// pixel single; range_candidate runs the three steps of (b) (memset,
// range, walk).  The script adds one extern "C" instantiation of each
// layout and builds it with the library's flags.

#include "../dsf_tpu_torch/csrc/moments.cu"

namespace dsf_moments {

// grid (ceil(P / 256), B)
__global__ void range_kernel(const int32_t* __restrict__ idx,
                             unsigned* __restrict__ rng, int P, int T) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int f = idx[static_cast<size_t>(b) * P + p];
  if (static_cast<unsigned>(f) < static_cast<unsigned>(T)) {
    unsigned* r = rng + 2 * (static_cast<size_t>(b) * T + f);
    atomicMin(r, static_cast<unsigned>(p));
    atomicMin(r + 1, ~static_cast<unsigned>(p));
  }
}

// WPB warps a block, one (image, face) a warp
template <int WPB>
__global__ void __launch_bounds__(WPB * 32)
walk_kernel(const int32_t* __restrict__ idx, const float* __restrict__ upd,
            const unsigned* __restrict__ rng, float* __restrict__ out, int B,
            int P, int T) {
  const int lane = threadIdx.x & 31;
  const size_t gw = static_cast<size_t>(blockIdx.x) * WPB + (threadIdx.x >> 5);
  if (gw >= static_cast<size_t>(B) * T) return;
  const int b = static_cast<int>(gw / T), f = static_cast<int>(gw % T);
  const int32_t* ib = idx + static_cast<size_t>(b) * P;
  const float* ub = upd + static_cast<size_t>(b) * P * 3;
  const unsigned lo = rng[2 * gw], hi = ~rng[2 * gw + 1];
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  if (lo != 0xffffffffu) {
    const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
    const int first = vec ? static_cast<int>(lo & ~3u) : static_cast<int>(lo);
    const int step = vec ? 128 : 32;
    for (int base = first; base <= static_cast<int>(hi); base += step) {
      int id[4] = {-1, -1, -1, -1};
      const int p0 = base + (vec ? 4 * lane : lane);
      if (vec && p0 <= static_cast<int>(hi)) {
        const int4 t = __ldg(reinterpret_cast<const int4*>(ib + p0));
        id[0] = t.x; id[1] = t.y; id[2] = t.z; id[3] = t.w;
      } else if (!vec && p0 <= static_cast<int>(hi)) {
        id[0] = __ldg(ib + p0);
      }
      // ascending pixel order: lane by lane, each lane's pixels in turn
      const unsigned any = __ballot_sync(
          0xffffffffu, id[0] == f || id[1] == f || id[2] == f || id[3] == f);
      float r[4][3];
      for (int i = 0; i < 4; ++i) {
        if (id[i] == f) {
          const float* q = ub + 3 * static_cast<size_t>(p0 + i);
          r[i][0] = __ldg(q); r[i][1] = __ldg(q + 1); r[i][2] = __ldg(q + 2);
        } else {
          r[i][0] = r[i][1] = r[i][2] = 0.f;
        }
      }
      const unsigned hits = (id[0] == f ? 1u : 0u) | (id[1] == f ? 2u : 0u)
                            | (id[2] == f ? 4u : 0u) | (id[3] == f ? 8u : 0u);
      for (unsigned m = any; m; m &= m - 1) {
        const int l = __ffs(m) - 1;
        const unsigned hl = __shfl_sync(0xffffffffu, hits, l);
        for (int i = 0; i < 4; ++i) {
          const float a0 = __shfl_sync(0xffffffffu, r[i][0], l);
          const float a1 = __shfl_sync(0xffffffffu, r[i][1], l);
          const float a2 = __shfl_sync(0xffffffffu, r[i][2], l);
          if (hl >> i & 1u) {
            s0 += a0;
            s1 += a1;
            s2 += a2;
          }
        }
      }
    }
  }
  if (lane == 0) {
    float* o = out + 3 * gw;
    o[0] = s0;
    o[1] = s1;
    o[2] = s2;
  }
}

template <int WARPS, int U, bool PF>
int candidate(const int32_t* idx, const float* upd, float* out, int B, int P,
              int T, int split, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) return launch<WARPS, U, PF>(idx, upd, out, B, P, T, split, st);
  return launch_n<WARPS, 1, U, PF>(idx, upd, out, B, P, T, split, st);
}

// rng: B * T * 2 unsigned of scratch
template <int WPB>
int range_candidate(const int32_t* idx, const float* upd, float* out,
                    unsigned* rng, int B, int P, int T, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      rng, 0xff, static_cast<size_t>(B) * T * 2 * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  range_kernel<<<dim3((P + 255) / 256, B), 256, 0, st>>>(idx, rng, P, T);
  const size_t warps = static_cast<size_t>(B) * T;
  walk_kernel<WPB><<<static_cast<unsigned>((warps + WPB - 1) / WPB),
                     WPB * 32, 0, st>>>(idx, upd, rng, out, B, P, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dsf_moments
