// K3 — point -> mesh nearest-face argmin under a factorized part mask.
//
// Replaces: dsf_tpu/ops/pallas_point_mesh.py:argmin_faces_pallas (body
// _kernel, region math _region_sqdist, constants _face_constants27), the
// argmin pass behind every ICP term of the self-supervised steps
// (dsf_tpu/ops/point_mesh.py:point_face_distance).
//
// Function: for each point p of cloud n, the index of the nearest face t
// among those admissible for p (mask[t, parts[n, p]]), and its squared
// distance.  Ties go to the lowest face index; a point whose part lies
// outside [0, K) admits no face and gets (1e10, 0), as the JAX paths'
// initial values do.  Distance: the divide-free 27-constant form of
// point_tri27.cuh; the plain version (ops/point_mesh.py:
// argmin_faces_plain) divides for the closest point instead, so the two
// agree to float32 rounding and near-ties may pick another face of
// (almost) the same distance.
//
// What bounds it on this card: operations.  At the FinetuneStage step's
// shape (128 clouds x 2048 points x 1554 faces: 64 full clouds whose
// points admit every face, 64 joint clouds whose points admit their
// bone's 171-371 faces) the function needs 2.4e8 admissible pairs, 63
// float operations each: ~0.22 ms at the 67 TFLOP/s float32 rate.
//
// Design: two launches.  dsf_point_mesh_setup (argmin_setup.cuh) builds
// the face rows, the part lists and each cloud's points grouped by part
// into tiles; dsf_point_mesh_argmin (argmin_body.cuh, Form27) walks each
// tile's part list, kGroups groups of kThreads threads of kR points a
// block.  Of the shapes scripts/argmin_shapes_gpu.py times, this one took
// the least time at the FinetuneStage step's shape (PERF.md §6).

#include <cuda_runtime.h>
#include <cstdint>

#include "argmin_body.cuh"
#include "argmin_setup.cuh"

namespace {

constexpr int kThreads = 64;         // threads a group: a tile of 192 points
constexpr int kR = 3;                // points a thread
constexpr int kGroups = 4;           // groups a block, each a quarter list

}  // namespace

extern "C" int dsf_point_mesh_setup(const float* points, const float* tris,
                                    const uint8_t* mask, const int64_t* parts,
                                    float* rows, int32_t* fword,
                                    int32_t* lists, int32_t* lens,
                                    int32_t* choff, int32_t* key,
                                    int32_t* perm, int32_t* tiles,
                                    int32_t* tcount, int N, int P, int T,
                                    int K, int TP, int maxT, void* stream) {
  return dsf_argmin::launch_setup27(points, tris, mask, parts, rows, fword,
                                    lists, lens, choff, key, perm, tiles,
                                    tcount, N, P, T, K, TP, maxT, stream);
}

extern "C" int dsf_point_mesh_argmin(const float* points, const float* rows,
                                     const int32_t* lists,
                                     const int32_t* lens,
                                     const int32_t* perm,
                                     const int32_t* tiles,
                                     const int32_t* tcount, float* dmin,
                                     int32_t* imin, int N, int P, int T,
                                     int maxT, void* stream) {
  return dsf_argmin::launch_argmin<dsf_argmin::Form27, kThreads, kR,
                                   kGroups>(
      points, rows, lists, lens, nullptr, nullptr, perm, tiles, tcount, dmin,
      imin, N, P, T, maxT, stream);
}
