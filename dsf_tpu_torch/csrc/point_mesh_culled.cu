// K8 — culled point -> mesh nearest-face argmin.
//
// Replaces: dsf_tpu/ops/pallas_point_mesh.py:argmin_faces_pallas_culled
// (body _kernel_culled, constants _face_constants), selected by
// dsf_tpu/ops/point_mesh.py:USE_CULLED_KERNEL.
//
// Function: K3's (the nearest admissible face per point), over faces in
// the stable order of their first admissible part, with blocks of pairs
// skipped where 128-face chunk bounding spheres prove that no point of a
// tile has its nearest admissible face in the chunk (the bounds of
// ops/point_mesh.py:culled_needed, widened by CULL_MARGIN, so the skip is
// exact).  Ties go to the lowest index in the part order; the face ids come
// back in the caller's order; a point that admits no face gets (1e10,
// fperm[0]), as the JAX kernel gives it.  Distance: the TPU kernel's 16
// constants per face and closest point by region, with one reciprocal a
// pair (argmin_body.cuh:culled_sqdist16; plain version
// ops/point_mesh.py:culled_sqdist).
//
// What bounds it on this card: operations, K3's bound (the same function):
// 63 float operations per admissible pair.  The cull evaluates fewer pairs
// than that count.
//
// Design: two launches for the set-up (argmin_setup.cuh): the face order
// and part lists, then the rows in that order, each cloud's chunk spheres,
// its points' bounds, need words and keys (part x G + nearest admissible
// chunk), their stable order and the tiles with their run words.  Then the
// body (argmin_body.cuh, Form16) walks the kept stretches of each tile's
// part list, K3's shape.

#include <cuda_runtime.h>
#include <cstdint>

#include "argmin_body.cuh"
#include "argmin_setup.cuh"

namespace {

constexpr int kThreads = 64;         // threads a group: a tile of 192 points
constexpr int kR = 3;                // points a thread
constexpr int kGroups = 4;           // groups a block, each a quarter list

}  // namespace

extern "C" int dsf_point_mesh_culled_setup(
    const float* points, const float* tris, const uint8_t* mask,
    const int64_t* parts, float* rows, int32_t* fword, int32_t* fkey,
    int32_t* fperm, int32_t* lists, int32_t* lens, int32_t* choff,
    int32_t* key, int32_t* need, int32_t* perm, int32_t* tiles,
    int32_t* tcount, int N, int P, int T, int K, int TP, int maxT,
    void* stream) {
  return dsf_argmin::launch_setup16(points, tris, mask, parts, rows, fword,
                                    fkey, fperm, lists, lens, choff, key,
                                    need, perm, tiles, tcount, N, P, T, K, TP,
                                    maxT, stream);
}

extern "C" int dsf_point_mesh_argmin_culled(
    const float* points, const float* rows, const int32_t* lists,
    const int32_t* choff, const int32_t* fperm, const int32_t* perm,
    const int32_t* tiles, const int32_t* tcount, float* dmin, int32_t* imin,
    int N, int P, int T, int maxT, void* stream) {
  return dsf_argmin::launch_argmin<dsf_argmin::Form16, kThreads, kR,
                                   kGroups>(
      points, rows, lists, nullptr, choff, fperm, perm, tiles, tcount, dmin,
      imin, N, P, T, maxT, stream);
}
