// K8 — culled point -> mesh nearest-face argmin.
//
// Replaces: dsf_tpu/ops/pallas_point_mesh.py:argmin_faces_pallas_culled
// (body _kernel_culled, constants _face_constants), selected by
// dsf_tpu/ops/point_mesh.py:USE_CULLED_KERNEL.
//
// Function: for each point p of cloud n (points sorted by part and nearest
// face chunk), the index of the nearest face among those admissible for p
// (bit parts[n, p] of words[t]) over the (128-point tile, 128-face chunk)
// blocks that run[n, tile, chunk] keeps, and its squared distance.  The
// wrapper's set-up (ops/point_mesh.py:culled_tables) keeps every block
// that can hold a point's nearest admissible face, from bounding spheres
// of the chunks, so the skip is exact.  Ties go to the lowest face index;
// a point with no block or no admissible face gets (1e10, 0).  Un-sorting
// the points and un-permuting the faces is the wrapper's.
//
// Distance form: the TPU kernel's 16 constants per face, a(3) ab(3) ac(3)
// ab.a ac.a ab.b ac.b ab.c ac.c a.a, three per-pair dot products
// s1 = ab.p, s2 = ac.p, pa = a.p, the Ericson region tests on
// d_k = s_i - const, the barycentric closest point q = a + v ab + w ac with
// divides, and d = p.p - 2 p.q + q.q in the order of _kernel_culled
// (plain version: ops/point_mesh.py:culled_sqdist).
//
// What bounds it on this card: operations over the admissible pairs of the
// blocks that run (~70 float operations a pair, with 5 divides).
//
// Design: K3's layout.  One block per (cloud, 128-point tile), one thread
// per point.  For every chunk the tile keeps (a uniform branch on one int
// of the run table), the block stages the chunk's 128 face rows (8 KB,
// float4 reads) and part words in shared memory, and every thread walks
// them in index order with a strict '<'.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;        // points per block (the run tile)
constexpr int kChunk = 128;          // faces per run entry
constexpr int kRow4 = 4;             // float4 per face row (16 floats)
constexpr float kInf = 1e10f;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float safe_div(float n, float d) {
  return n / (fabsf(d) < kEps ? kEps : d);
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

__global__ void __launch_bounds__(kThreads)
point_mesh_culled_kernel(const float* __restrict__ points,     // (N, P, 3)
                         const float4* __restrict__ fc,        // (N, T, 4)
                         const uint32_t* __restrict__ words,   // (T,)
                         const int32_t* __restrict__ parts,    // (N, P)
                         const int32_t* __restrict__ run,      // (N, NT, G)
                         float* __restrict__ dmin,             // (N, P)
                         int32_t* __restrict__ imin,           // (N, P)
                         int P, int T) {
  __shared__ float4 s_fc[kChunk * kRow4];
  __shared__ uint32_t s_w[kChunk];
  const int n = blockIdx.y;
  const int NT = gridDim.x;
  const int G = (T + kChunk - 1) / kChunk;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < P;
  const int32_t* run_t = run + ((size_t)n * NT + blockIdx.x) * G;

  float px = 0.f, py = 0.f, pz = 0.f;
  uint32_t bit = 0u;                  // a padding thread admits nothing
  if (live) {
    const float* q = points + ((size_t)n * P + p) * 3;
    px = q[0];
    py = q[1];
    pz = q[2];
    bit = 1u << (parts[(size_t)n * P + p] & 31);
  }
  const float pp = px * px + py * py + pz * pz;
  float best = kInf;
  int arg = 0;

  const float4* fcn = fc + (size_t)n * T * kRow4;
  for (int g = 0; g < G; ++g) {
    if (run_t[g] == 0) continue;          // uniform over the block
    const int t0 = g * kChunk;
    const int nf = min(kChunk, T - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nf * kRow4; i += kThreads)
      s_fc[i] = fcn[(size_t)t0 * kRow4 + i];
    for (int i = threadIdx.x; i < nf; i += kThreads) s_w[i] = words[t0 + i];
    __syncthreads();

    for (int f = 0; f < nf; ++f) {
      if (!(s_w[f] & bit)) continue;
      const float* c = reinterpret_cast<const float*>(s_fc + f * kRow4);
      // rows: a(0-2) ab(3-5) ac(6-8) | ab.a ac.a ab.b ac.b ab.c ac.c
      // (9-14) | a.a (15)
      const float ab_a = c[9], ac_a = c[10], ab_b = c[11], ac_b = c[12];
      const float ab_c = c[13], ac_c = c[14], aa = c[15];
      const float abab = ab_b - ab_a, acac = ac_c - ac_a, abac = ac_b - ac_a;
      const float s1 = px * c[3] + py * c[4] + pz * c[5];
      const float s2 = px * c[6] + py * c[7] + pz * c[8];
      const float pa = px * c[0] + py * c[1] + pz * c[2];
      const float d1 = s1 - ab_a, d2 = s2 - ac_a, d3 = s1 - ab_b;
      const float d4 = s2 - ac_b, d5 = s1 - ab_c, d6 = s2 - ac_c;
      const float vc = d1 * d4 - d3 * d2;
      const float vb = d5 * d2 - d1 * d6;
      const float va = d3 * d6 - d5 * d4;
      const float den = va + vb + vc;
      float v = safe_div(vb, den);
      float w = safe_div(vc, den);
      if (va <= 0.f && d4 - d3 >= 0.f && d5 - d6 >= 0.f) {
        const float t = clamp01(safe_div(d4 - d3, (d4 - d3) + (d5 - d6)));
        v = 1.f - t;
        w = t;
      }
      if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) {
        v = 0.f;
        w = clamp01(safe_div(d2, d2 - d6));
      }
      if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) {
        v = clamp01(safe_div(d1, d1 - d3));
        w = 0.f;
      }
      if (d6 >= 0.f && d5 <= d6) { v = 0.f; w = 1.f; }
      if (d3 >= 0.f && d4 <= d3) { v = 1.f; w = 0.f; }
      if (d1 <= 0.f && d2 <= 0.f) { v = 0.f; w = 0.f; }
      const float qq = aa + v * (2.f * ab_a + v * abab)
                       + w * (2.f * ac_a + w * acac) + 2.f * v * w * abac;
      float d = pp - 2.f * (pa + v * s1 + w * s2) + qq;
      d = fmaxf(d, 0.f);
      if (d < best) {
        best = d;
        arg = t0 + f;
      }
    }
  }
  if (live) {
    dmin[(size_t)n * P + p] = best;
    imin[(size_t)n * P + p] = arg;
  }
}

}  // namespace

extern "C" int dsf_point_mesh_argmin_culled(const float* points,
                                            const float* fc,
                                            const int32_t* words,
                                            const int32_t* parts,
                                            const int32_t* run, float* dmin,
                                            int32_t* imin, int N, int P,
                                            int T, void* stream) {
  const dim3 grid((P + kThreads - 1) / kThreads, N);
  point_mesh_culled_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      points, reinterpret_cast<const float4*>(fc),
      reinterpret_cast<const uint32_t*>(words), parts, run, dmin, imin, P,
      T);
  return static_cast<int>(cudaGetLastError());
}
