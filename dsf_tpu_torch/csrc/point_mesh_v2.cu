// K7 — point -> mesh nearest-face argmin with an admissibility skip mask.
//
// Replaces: dsf_tpu/ops/pallas_point_mesh.py:argmin_faces_pallas_v2 (body
// _kernel_v2, region math _region_sqdist, constants _face_constants27,
// skip flags :554-566), selected by dsf_tpu/ops/point_mesh.py:
// USE_V2_KERNEL (DSF_ICP_KERNEL=v2), with the face sort of
// point_mesh._static_part_perm.  The TPU variant's MXU dot products
// (use_mxu) are not ported: the TPU measured them slower, and this card
// has no use for a depth-4 product.
//
// Function: K3's (csrc/point_mesh.cu), the index of the nearest face among
// those admissible for each point and its squared distance, in the same
// divide-free form (point_tri27.cuh), over the faces in the stable order of
// their first admissible part (so a 128-face chunk holds one part or few).
// The skip word of each (cloud, 128-point tile in the caller's order) has
// bit g set when some point of the tile admits some face of chunk g; a
// clear bit is a block of pairs that are all inadmissible, and the block
// skips it whole.  Ties go to the lowest index in the part order; the ids
// come back in the caller's order; a point that admits no face in the
// chunks its tile runs gets (1e10, fperm[0]).
//
// What bounds it on this card: operations, as K3: 63 float adds and
// multiplies per admissible pair.  The skip removes blocks, not pairs: in
// a block that runs, the inadmissible pairs of a warp that some lane
// admits still cost their distance.
//
// Design: two launches of the set-up (argmin_setup.cuh, K7 mode): the face
// order, the face words and the chunk ORs; then the 28-float rows in that
// order, the points' parts and the skip words.  Then the body
// (argmin_body.cuh:argmin_v2_kernel): one block per tile, kGroups groups
// of kThreads threads of kR points, each group a segment of the run
// chunks' faces, a warp skipping the faces none of its lanes admits, the
// distance of every other pair with its admissibility selected in.  Of the
// shapes scripts/argmin_shapes_gpu.py times, this one took the least time
// at the FinetuneStage step's shape (PERF.md §6).

#include <cuda_runtime.h>
#include <cstdint>

#include "argmin_body.cuh"
#include "argmin_setup.cuh"
#include "point_tri27.cuh"

namespace {

constexpr int kThreads = 32;         // threads a group: one warp
constexpr int kR = 4;                // points a thread (kThreads x kR = 128)
constexpr int kGroups = 4;           // groups a block, each a quarter
constexpr bool kSelect = true;       // admissibility selected, not branched

}  // namespace

extern "C" int dsf_point_mesh_v2_setup(const float* tris, const uint8_t* mask,
                                       const int64_t* parts, float* rows,
                                       int32_t* fword, int32_t* fkey,
                                       int32_t* fperm, int32_t* words,
                                       int32_t* cor, int32_t* parts32,
                                       int32_t* skip, int N, int P, int T,
                                       int K, void* stream) {
  return dsf_argmin::launch_setup_v2(tris, mask, parts, rows, fword, fkey,
                                     fperm, words, cor, parts32, skip, N, P,
                                     T, K, stream);
}

extern "C" int dsf_point_mesh_argmin_v2(const float* points,
                                        const float* rows,
                                        const int32_t* words,
                                        const int32_t* parts,
                                        const int32_t* skip,
                                        const int32_t* fperm, float* dmin,
                                        int32_t* imin, int N, int P, int T,
                                        void* stream) {
  return dsf_argmin::launch_argmin_v2<kThreads, kR, kGroups, kSelect>(
      points, rows, words, parts, skip, fperm, dmin, imin, N, P, T, stream);
}
