// K10 — binned raster: nearest-face depth and face id per pixel, each
// 16x16 pixel tile against its own list of faces.
//
// Replaces: dsf_tpu/ops/pallas_raster.py:raster_pallas_tiles, the binned
// route of dsf_tpu/ops/rasterize.py:_raster_forward (a pixel layout given
// as tile_hw, with the skip raster switched off).  Its body _kernel_binned
// and its caller's face_coeff_rows are defined nowhere in the JAX package,
// so this kernel follows the CPU semantics of rasterize._raster_binned
// (rasterize.py:257-343).
//
// Function: rasterize.raster_binned_plain's over rasterize.binned_tables.
// Tile g's list holds, in ascending order, the valid faces whose screen
// box meets the box of the tile's own samples (inclusive, no margin), at
// most BIN_CAP = 512 of them.  Per pixel, the least depth z > 0 over the
// valid faces of its tile's list whose three edge values are >= 0 there,
// and the lowest face id at that depth; (0, -1) where none covers it.
// Where a face's rounded edges pass a pixel outside its screen box (near
// a needle, up to pixels beyond its tip) and its box misses the pixel's
// tile, the list leaves it out, as the JAX package's does: there the
// answer can differ from raster_scan's.  When any tile of the batch
// holds more than the cap, every tile takes the dense answer
// (raster_scan's), as the JAX package's whole-batch lax.cond gives it;
// the flag is read on the device, so nothing waits on the host.
//
// What bounds it on this card: at the serving shape (B=32, 64x64, 1554
// faces) the bytes (face rows, positions, outputs: ~4.6 MB); the
// operations (~16 per pixel in a face's box) take less.  What the design
// has to keep small is everything else: the tables (in PyTorch, a
// (B, G, F) box test, a cumsum and a scatter into (B, G, 512) lists,
// about 15 times the raster), (pixel, face) pairs that cannot hit, and the
// tiles where the hand's faces pile up (up to ~750 faces), which set the
// time of a grid that fills the card a few times.
//
// Design (three launches, no PyTorch op between):
//  * dsf_raster_binned_setup, raster_setup.cuh: the face set-up of K1 and
//    K6 (rows bitwise as rasterize.face_rows, cover boxes, 256-face chunk
//    boxes) plus each face's screen box (it also zeroes the overflow
//    flag), then bin_count_kernel, one block per (image, 16x16 tile): the
//    tile's sample box, its face count and the overflow flag.  No list
//    goes to device memory: at 128x128 the (B, G, 512) lists would be
//    4 MB, more than every other byte of the function; each raster block
//    rebuilds its part of one in shared memory instead.
//  * dsf_raster_binned: one block per (image, 4 x 16 pixel sub-tile), one
//    thread per pixel, four blocks to a tile.  raster_rows.cuh:scan_culled
//    (K1's body) walks, in ascending order with a strict '<', the faces
//    whose screen box meets the parent tile's sample box (exactly the
//    tile's list, since no tile overflowed) and whose cover box meets the
//    block's own sample box (the others cover none of its pixels).  So
//    zbuf and ids are bitwise the list's answer.  When the flag is set,
//    the block runs K1's body as it is: raster_scan's answer.
//    The 4 x 16 sub-tile quarters each block's box and quadruples the
//    blocks, so the tiles where faces pile up spread over more SMs; of the
//    shapes scripts/raster_shapes_gpu.py times, it is the one chosen
//    (PERF.md).
// Positions are read through their strides (the crop rays are a slice of
// (B, P, 3) rows), and the faces in the mesh's own int64 or in int32, so
// the route copies and casts nothing.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "raster_rows.cuh"
#include "raster_setup.cuh"

namespace {

// the block: kTileX columns x kTileY rows of pixels inside one 16x16 tile
constexpr int kTileX = 4;
constexpr int kTileY = 16;
using dsf_raster::kBin;
using dsf_raster::kRow;

template <int TX, int TY>
__global__ void __launch_bounds__(TX * TY)
raster_binned_kernel(const float* __restrict__ rows,       // (B, F, 16)
                     const float* __restrict__ boxes,      // (B, F, 4)
                     const float* __restrict__ cbox,       // (B, nc, 4)
                     const float* __restrict__ vbox,       // (B, F, 4)
                     const float* __restrict__ tbox,       // (B, G, 4)
                     const float* __restrict__ pix,        // strided
                     const int32_t* __restrict__ overflow, // (1,)
                     float* __restrict__ zbuf,             // (B, H*W)
                     int32_t* __restrict__ idx,            // (B, H*W)
                     int sb, int sp, int F, int H, int W) {
  static_assert(kBin % TX == 0 && kBin % TY == 0, "a block in one tile");
  __shared__ dsf_raster::CullShared<TX * TY> s;
  const int b = blockIdx.z;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  const int nc = (F + dsf_raster::kCull - 1) / dsf_raster::kCull;
  const int G = (H / kBin) * (W / kBin);
  const int g = (blockIdx.y * TY / kBin) * (W / kBin) + blockIdx.x * TX / kBin;
  const long long p = (long long)y * W + x;
  const float* uv = pix + (long long)b * sb + p * sp;

  const bool active[1] = {true};
  float u[1] = {uv[0]}, v[1] = {uv[1]}, best[1] = {dsf_raster::kInf};
  int best_i[1] = {-1};
  const float* img_rows = rows + (size_t)b * F * kRow;
  const float4* img_boxes =
      reinterpret_cast<const float4*>(boxes) + (size_t)b * F;
  const float4* img_cbox =
      reinterpret_cast<const float4*>(cbox) + (size_t)b * nc;
  if (overflow[0] != 0) {   // every face: K1's body, raster_scan's answer
    dsf_raster::scan_culled<TX * TY, 1>(img_rows, img_boxes, img_cbox, F, u,
                                        v, active, tid, s, best, best_i);
  } else {                  // the parent tile's list
    const dsf_raster::TileList listed{
        reinterpret_cast<const float4*>(vbox) + (size_t)b * F,
        reinterpret_cast<const float4*>(tbox)[(size_t)b * G + g]};
    dsf_raster::scan_culled<TX * TY, 1>(img_rows, img_boxes, img_cbox, F, u,
                                        v, active, tid, s, best, best_i,
                                        listed);
  }
  dsf_raster::store(best[0], best_i[0], zbuf, idx, b * ((long long)H * W) + p);
}

template <int TX, int TY>
int launch_raster_binned(const float* rows, const float* boxes,
                         const float* cbox, const float* vbox,
                         const float* tbox, const float* pix,
                         const int32_t* overflow,
                         float* zbuf, int32_t* idx, int B, int F, int H,
                         int W, int sb, int sp, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid(W / TX, H / TY, B);
  raster_binned_kernel<TX, TY>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          rows, boxes, cbox, vbox, tbox, pix, overflow, zbuf, idx, sb, sp, F,
          H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows (B, F, 16), cover boxes (B, F, 4), cbox (B, nc, 4), screen boxes
// vbox (B, F, 4), tbox (B, G, 4), counts (B, G) and the overflow flag (1,)
// from proj (B, V, 3) and faces (F, 3), int64 when faces64 is set, else
// int32; sample p of image b at pix[b * sb + p * sp] (u, then v); H and W
// multiples of 16.
extern "C" int dsf_raster_binned_setup(
    const float* proj, const void* faces, const float* pix, float* rows,
    float* boxes, float* cbox, float* vbox, float* tbox, int32_t* counts,
    int32_t* overflow, int faces64, int B, int V, int F, int H, int W,
    int sb, int sp, int cap, void* stream) {
  if (faces64)
    return dsf_raster::launch_bin_setup(
        proj, static_cast<const int64_t*>(faces), pix, rows, boxes, cbox,
        vbox, tbox, counts, overflow, B, V, F, H, W, sb, sp, cap, stream);
  return dsf_raster::launch_bin_setup(
      proj, static_cast<const int32_t*>(faces), pix, rows, boxes, cbox, vbox,
      tbox, counts, overflow, B, V, F, H, W, sb, sp, cap, stream);
}

extern "C" int dsf_raster_binned(const float* rows, const float* boxes,
                                 const float* cbox, const float* vbox,
                                 const float* tbox, const float* pix,
                                 const int32_t* overflow, float* zbuf,
                                 int32_t* idx, int B, int F, int H, int W,
                                 int sb, int sp, void* stream) {
  return launch_raster_binned<kTileX, kTileY>(rows, boxes, cbox, vbox, tbox,
                                              pix, overflow, zbuf, idx, B, F,
                                              H, W, sb, sp, stream);
}
