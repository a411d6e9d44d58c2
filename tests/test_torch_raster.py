"""Port parity: the plain raster of dsf_tpu_torch (the K1 kernel's plain
version) against dsf_tpu's CPU raster (``_raster_binned``, the scan the
renderer takes on the CPU) and against the Pallas skip-raster
``raster_pallas_skip`` run in interpret mode, on the same projected
vertices and sample positions.

Coverage and face ids are held equal.  zbuf is held to 1e-5 relative, not
bitwise, for a measured reason: XLA on the CPU contracts the depth plane
``u*az + v*bz + cz`` into ``fma(u, az, v*bz) + cz``, while the port rounds
each product and sum on its own (as its CUDA kernel does, with
__fmul_rn/__fadd_rn, so that kernel and plain version are bitwise-equal on
the card).  The plane's terms are ~1e5 and cancel to a depth of ~700 mm,
so that one skipped rounding shows as up to ~3e-6 relative on MANO
scenes (~2e-3 mm) and ~6e-6 on the random mesh below.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from dsf_tpu import geometry as JG
from dsf_tpu.mano import model as JM, synthetic as JS
from dsf_tpu.ops import rasterize as JR
from dsf_tpu_torch import kernels
from dsf_tpu_torch.ops import rasterize as TR
from dsf_tpu_torch.ops import raster_kernel
from raster_needles import add_needles

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
Z_RTOL = 1e-5


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    import dsf_tpu.ops.pallas_raster as PR
    monkeypatch.setattr(PR.pl, "pallas_call", patched)
    yield


@pytest.fixture(scope="module")
def mano(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    return JM.load_model(path)


def _posed_scene(mano, crop, stride, seed, B=2):
    """Seeded MANO poses placed in front of the NYU camera, their crop
    matrices, and the (B, P, 2) crop sample rays."""
    rng = np.random.RandomState(seed)
    para = np.zeros((B, 62), np.float32)
    para[:, :48] = rng.randn(B, 48).astype(np.float32) * 0.3
    para[:, 58] = rng.uniform(0.9, 1.1, B)
    center = rng.uniform([-30, -30, 650], [30, 30, 850], (B, 3)).astype(np.float32)
    cube = np.full((B, 3), 250.0, np.float32)
    verts, _ = JM.get_mano_vertices(mano, *JM.split_params(jnp.asarray(para)),
                                    global_scale=1.0 / 125.0)
    verts = verts * cube[:, None] / 2.0 + center[:, None]
    com = JG.xyz_to_uvd(jnp.asarray(center)[:, None], PARAS)[:, 0]
    M = JG.crop_matrix(com, jnp.asarray(cube), PARAS, (crop, crop))
    rays = JR.crop_pixel_rays(M, (crop, crop), stride)
    proj = JR.project_verts(verts, PARAS)
    return verts, np.asarray(M), np.asarray(rays), np.asarray(proj)


def _port(proj, rays, faces):
    z, i = TR.raster_scan(torch.from_numpy(np.array(proj)),
                          torch.from_numpy(np.array(rays)),
                          torch.from_numpy(np.asarray(faces, np.int64)))
    return z.numpy(), i.numpy()


def _assert_raster_equal(z_port, i_port, z_ref, i_ref):
    z_ref, i_ref = np.asarray(z_ref), np.asarray(i_ref)
    np.testing.assert_array_equal(z_port > 0, z_ref > 0)       # coverage
    np.testing.assert_array_equal(i_port, i_ref)               # face ids
    np.testing.assert_allclose(z_port, z_ref, rtol=Z_RTOL, atol=0)


@pytest.mark.parametrize("crop,stride", [(64, 1), (64, 2), (128, 2)])
def test_plain_raster_matches_cpu_reference(mano, crop, stride):
    """The renderer's own path: rasterize_depth with the tile layout,
    which the JAX package runs as _raster_binned on the CPU."""
    verts, M, rays, proj = _posed_scene(mano, crop, stride, seed=crop + stride)
    H = W = crop // stride
    z_ref, i_ref = JR.rasterize_depth(verts, mano.faces, jnp.asarray(rays),
                                      PARAS, return_idx=True, tile_hw=(H, W))
    z, i = _port(proj, rays, mano.faces)
    assert (z > 0).mean() > 0.05, "scene must cover a real share of the crop"
    _assert_raster_equal(z, i, z_ref, i_ref)
    # the port's sample rays are the JAX package's, bitwise
    rays_t = TR.crop_pixel_rays(torch.from_numpy(M.copy()), (crop, crop), stride)
    np.testing.assert_array_equal(rays_t.numpy(), rays)


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_raster_matches_pallas_skip_interpret(mano, interpret_pallas,
                                                    stride):
    """The TPU kernel itself (16x16 tiles, 64-face chunks, as production
    dispatches it), in interpret mode."""
    from dsf_tpu.ops.pallas_raster import raster_pallas_skip
    crop = 64
    _, _, rays, proj = _posed_scene(mano, crop, stride, seed=10 + stride)
    H = W = crop // stride
    z_ref, i_ref = raster_pallas_skip(jnp.asarray(proj), jnp.asarray(rays),
                                      mano.faces, fc=64, tile_hw=(H, W),
                                      block=(16, 16))
    z, i = _port(proj, rays, mano.faces)
    _assert_raster_equal(z, i, z_ref, i_ref)


def test_plain_raster_random_mesh_matches_scan():
    """Random overlapping faces (many depth ties between chunks): the
    chunk-major strict `<` and first-argmin-in-chunk choice must pick the
    same winners as the JAX scan."""
    rng = np.random.RandomState(1)
    B, V, F = 2, 80, 300
    paras = (100.0, 100.0, 32.0, 32.0)
    verts = (rng.randn(B, V, 3) * 10 + [0, 0, 100]).astype(np.float32)
    faces = np.stack([rng.choice(V, 3, replace=False)
                      for _ in range(F)]).astype(np.int32)
    pix = np.asarray(JR.full_frame_pixel_rays((64, 64)))
    pix = np.broadcast_to(pix, (B, 4096, 2))
    proj = np.asarray(JR.project_verts(jnp.asarray(verts), paras))
    z_ref, i_ref = JR._raster_scan(jnp.asarray(proj), jnp.asarray(pix),
                                   jnp.asarray(faces))
    z, i = _port(proj, pix, faces)
    _assert_raster_equal(z, i, z_ref, i_ref)


def test_chunking_does_not_change_the_plain_result(mano):
    """Any face chunk gives the same winners (the semantics, not the
    chunk size, fix the result) — the CUDA kernel walks 64-face chunks."""
    _, _, rays, proj = _posed_scene(mano, 64, 2, seed=3)
    args = (torch.from_numpy(proj), torch.from_numpy(rays),
            torch.from_numpy(np.asarray(mano.faces, np.int64)))
    z1, i1 = TR.raster_scan(*args, chunk=256)
    for chunk in (64, 1554):
        z2, i2 = TR.raster_scan(*args, chunk=chunk)
        np.testing.assert_array_equal(z1.numpy(), z2.numpy())
        np.testing.assert_array_equal(i1.numpy(), i2.numpy())


def test_skip_tables_layout(mano):
    """The plain set-up (the K1 and K6 kernels' inputs): 16-float face
    rows, each valid face's cover box (``cover_boxes``): its exact screen
    box widened, by a median of under 0.005 px and under 0.1 px for 99% of
    a posed hand's faces;
    an empty box (+inf, -inf) for each invalid face, and each 256-face
    chunk's box the union of its faces' boxes."""
    _, _, _, proj = _posed_scene(mano, 64, 2, seed=4)
    # two degenerate faces (a repeated vertex: zero area) at the end
    faces = torch.from_numpy(np.concatenate(
        [np.asarray(mano.faces, np.int64), [[0, 0, 1], [5, 5, 5]]]))
    p = torch.from_numpy(np.array(proj))
    rows, boxes, cbox = TR.skip_tables(p, faces)
    F = faces.shape[0]
    nc = -(-F // raster_kernel.CHUNK)
    assert rows.shape == (2, F, 16) and boxes.shape == (2, F, 4)
    assert cbox.shape == (2, nc, 4)
    a, b, c, az, bz, cz, valid = TR.face_coeffs(p, faces)
    np.testing.assert_array_equal(rows[..., 0:9:3].numpy(), a.numpy())
    np.testing.assert_array_equal(rows[..., 2:9:3].numpy(), c.numpy())
    np.testing.assert_array_equal(rows[..., 11].numpy(), cz.numpy())
    np.testing.assert_array_equal(rows[..., 12].numpy() == 1.0, valid.numpy())
    v = valid.numpy()
    assert v[:, :-2].all() and not v[:, -2:].any()
    tri = proj[:, faces.numpy()][..., :2]
    box = boxes.numpy()
    lo, hi = tri.min(-2), tri.max(-2)                  # (B, F, 2)
    out = np.stack([lo[..., 0] - box[..., 0], box[..., 1] - hi[..., 0],
                    lo[..., 1] - box[..., 2], box[..., 3] - hi[..., 1]],
                   -1)[v]                             # widened by, >= 0
    assert (out > 0).all() and np.median(out.max(-1)) < 0.005
    assert (out.max(-1) < 0.1).mean() > 0.99
    np.testing.assert_array_equal(
        box[~v], np.tile([np.inf, -np.inf, np.inf, -np.inf], (4, 1)))
    cb = cbox.numpy()
    for ci in range(nc):
        part = box[:, ci * raster_kernel.CHUNK:(ci + 1) * raster_kernel.CHUNK]
        np.testing.assert_array_equal(cb[:, ci, 0::2], part[..., 0::2].min(1))
        np.testing.assert_array_equal(cb[:, ci, 1::2], part[..., 1::2].max(1))


def _screen_boxes(proj, faces):
    """Each face's screen box (B, F, 4) = [umin umax vmin vmax], +inf,
    -inf for an invalid face (the tile lists' test)."""
    lo, hi = TR._face_bounds(proj, faces, TR.face_rows(proj, faces))
    return torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1)


def _edge_pass(rows, pix):
    """(B, P, F): where each valid face's three rounded edge values are
    >= 0 at each sample, as ``_depth_or_inf`` evaluates them."""
    u, v = pix[..., 0:1], pix[..., 1:2]
    out = (rows[..., 12] != 0)[:, None].expand(-1, pix.shape[1], -1)
    for k in range(3):
        e = u * rows[:, None, :, 3 * k] + v * rows[:, None, :, 3 * k + 1] \
            + rows[:, None, :, 3 * k + 2]
        out = out & (e >= 0)
    return out


def _in_boxes(pix, box, margin=0.0):
    """(B, P, F): whether each sample lies in each face's box, widened by
    ``margin`` px."""
    u, v = pix[..., 0:1], pix[..., 1:2]
    box = box[:, None]
    return ((u >= box[..., 0] - margin) & (u <= box[..., 1] + margin)
            & (v >= box[..., 2] - margin) & (v <= box[..., 3] + margin))


@pytest.mark.parametrize("case", ["hands_128", "needles_128", "needles_64",
                                  "slivers"])
def test_cover_boxes_hold_every_covered_sample(mano, case):
    """Every sample at which a face's rounded edge test passes lies in the
    face's cover box (``cover_boxes``), on posed hands' crops, on needles
    0.001-0.005 px wide through the crops' samples at 128^2 and 64^2 and
    on the random slivers and faces under a pixel.  On the needles the
    test also passes samples more than a pixel outside the face's screen
    box, which the cull's old premise (a margin of one pixel) missed."""
    if case == "slivers":
        proj, pix, faces = map(torch.from_numpy, _small_faces_scene(seed=7))
    else:
        stride = 2 if case.endswith("64") else 1
        _, _, pix, proj = _posed_scene(mano, 128, stride, seed=20 + stride)
        proj = torch.from_numpy(np.array(proj))
        pix = torch.from_numpy(np.array(pix))
        faces = torch.from_numpy(np.asarray(mano.faces, np.int64))
        if case.startswith("needles"):
            proj, faces = add_needles(proj, pix, faces, (128 // stride,) * 2,
                                      seed=5)
    rows, boxes, _ = TR.skip_tables(proj, faces)
    hit = _edge_pass(rows, pix)
    assert hit.sum() > 1000
    assert not (hit & ~_in_boxes(pix, boxes)).any()
    beyond = hit & ~_in_boxes(pix, _screen_boxes(proj, faces), margin=1.0)
    assert bool(beyond.any()) == case.startswith("needles")


def _meets(bx, box):
    """Face boxes bx (F, 4) against one box [umin umax vmin vmax],
    inclusive: the kernels' ``meets``."""
    return ((bx[:, 0] <= box[1]) & (bx[:, 1] >= box[0])
            & (bx[:, 2] <= box[3]) & (bx[:, 3] >= box[2]))


def _culled_scan(proj, pix, faces, blocks, margin=0.0, list_box=None):
    """A plain model of the raster kernels' cull (csrc/raster_rows.cuh:
    scan_culled): per image and block of samples (``blocks`` (nb, S) int64
    sample indices, -1 for none), the box of the block's samples (widened
    by ``margin`` px: the kernels' is 0), the faces whose cover box
    (``skip_tables``) meets it and, where a ``list_box`` (B, nb, 4) is
    given (K10's tile list), whose screen box meets the block's, in
    ascending order, and ``scan_rows`` over their rows; a block that meets
    no face is background."""
    rows, boxes, _ = TR.skip_tables(proj, faces)
    B, P = pix.shape[0], pix.shape[1]
    zbuf = torch.zeros((B, P), dtype=torch.float32)
    idx = torch.full((B, P), -1, dtype=torch.int32)
    screen = _screen_boxes(proj, faces)
    for b in range(B):
        bx = boxes[b]
        for k, blk in enumerate(blocks):
            s = blk[blk >= 0]
            uv = pix[b, s]
            lo = uv.amin(0) - margin
            hi = uv.amax(0) + margin
            meet = _meets(bx, torch.stack([lo[0], hi[0], lo[1], hi[1]]))
            if list_box is not None:
                meet &= _meets(screen[b], list_box[b, k])
            fid = torch.nonzero(meet).squeeze(1)
            if fid.numel() == 0:
                continue
            z, i = TR.scan_rows(rows[b:b + 1, fid], uv[None])
            zbuf[b, s] = z[0]
            idx[b, s] = torch.where(i[0] >= 0, fid[i[0].clamp_min(0)].int(),
                                    torch.full_like(i[0], -1))
    return zbuf, idx


def _tile_blocks(H, W, tile=raster_kernel.SKIP_TILE):
    """K1's blocks: th x tw pixel tiles of a row-major H x W layout, the
    ragged edge masked."""
    th, tw = tile
    out = []
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            blk = np.full(th * tw, -1, np.int64)
            ys, xs = np.meshgrid(np.arange(y0, min(y0 + th, H)),
                                 np.arange(x0, min(x0 + tw, W)),
                                 indexing="ij")
            ids = (ys * W + xs).reshape(-1)
            blk[:ids.size] = ids
            out.append(blk)
    return torch.from_numpy(np.stack(out))


def _run_blocks(P, n=raster_kernel.DENSE_BLOCK):
    """K6's blocks: n consecutive samples."""
    blk = np.full(-(-P // n) * n, -1, np.int64)
    blk[:P] = np.arange(P)
    return torch.from_numpy(blk.reshape(-1, n))


def _small_faces_scene(seed, B=2, size=64):
    """Random faces over a size x size frame, a third each ordinary (2-10
    px), under a pixel (0.1-0.8 px) and slivers (5-20 px long, 0.02-0.3 px
    wide), at depths 50-150 that cross: (proj (B, 3F, 3), faces (F, 3))."""
    rng = np.random.RandomState(seed)
    n = 200
    c = rng.uniform(4, size - 4, (B, 3 * n, 1, 2))
    big = rng.uniform(-5, 5, (B, n, 3, 2))
    tiny = rng.uniform(-0.4, 0.4, (B, n, 3, 2))
    ang = rng.uniform(0, np.pi, (B, n, 1))
    ax = np.stack([np.cos(ang), np.sin(ang)], -1)            # (B, n, 1, 2)
    nrm = np.stack([-np.sin(ang), np.cos(ang)], -1)
    t = np.stack([rng.uniform(-10, -2.5, (B, n)), rng.uniform(2.5, 10, (B, n)),
                  rng.uniform(-2, 2, (B, n))], -1)[..., None]
    off = np.stack([np.zeros((B, n)), np.zeros((B, n)),
                    rng.uniform(0.02, 0.3, (B, n))], -1)[..., None]
    sliver = t * ax + off * nrm
    uv = c + np.concatenate([big, tiny, sliver], 1)          # (B, 3n, 3, 2)
    z = rng.uniform(50, 150, uv.shape[:-1] + (1,))
    proj = np.concatenate([uv, z], -1).reshape(B, 9 * n, 3).astype(np.float32)
    faces = np.arange(9 * n, dtype=np.int64).reshape(3 * n, 3)
    v, u = np.meshgrid(np.arange(size, dtype=np.float32),
                       np.arange(size, dtype=np.float32), indexing="ij")
    pix = np.broadcast_to(np.stack([u.reshape(-1), v.reshape(-1)], -1),
                          (B, size * size, 2))
    return proj, np.ascontiguousarray(pix), faces


@pytest.mark.parametrize("case", ["tiles_64", "tiles_128", "tiles_ragged",
                                  "frame_strip", "slivers_tiles",
                                  "slivers_runs", "permuted_runs",
                                  "needles_tiles", "needles_runs"])
def test_culled_scan_matches_raster_scan(mano, case):
    """The per-face, per-block cull of the K1 and K6 kernels, in plain
    torch, against ``raster_scan`` bitwise (zbuf and ids): posed hands'
    crops at 64^2 and 128^2 and a 58^2 layout in K1's tiles (ragged in
    both directions); a
    full-frame strip through the hands in K6's runs of samples; random
    faces with slivers and faces under a pixel in both; the hands' crop
    samples in a random order in K6's runs (the result may not depend on
    the order); and needles 0.001-0.005 px wide through the 128^2 crop's
    samples, in front of the hands, in both (their rounded edges pass
    samples beyond their tips, outside their screen boxes and inside their
    cover boxes)."""
    faces = np.asarray(mano.faces, np.int64)
    if case.startswith("needles"):
        _, _, pix, proj = _posed_scene(mano, 128, 1, seed=21)
        H = W = 128
        p, f = add_needles(torch.from_numpy(np.array(proj)),
                           torch.from_numpy(np.array(pix)),
                           torch.from_numpy(faces), (H, W), seed=5)
        proj, faces = p.numpy(), f.numpy()
    elif case.startswith("slivers"):
        proj, pix, faces = _small_faces_scene(seed=7)
        H = W = 64
    elif case == "frame_strip":
        _, _, _, proj = _posed_scene(mano, 64, 1, seed=21)
        v, u = np.meshgrid(np.arange(200, 264, dtype=np.float32),
                           np.arange(640, dtype=np.float32), indexing="ij")
        pix = np.broadcast_to(np.stack([u.reshape(-1), v.reshape(-1)], -1),
                              (2, u.size, 2))
    else:
        crop, stride = {"tiles_64": (128, 2), "tiles_128": (128, 1),
                        "tiles_ragged": (116, 2),
                        "permuted_runs": (128, 2)}[case]
        _, _, pix, proj = _posed_scene(mano, crop, stride, seed=20 + stride)
        H = W = crop // stride
    proj_t = torch.from_numpy(np.array(proj))
    pix_t = torch.from_numpy(np.array(pix))
    faces_t = torch.from_numpy(faces)
    z_ref, i_ref = TR.raster_scan(proj_t, pix_t, faces_t)
    assert (z_ref > 0).float().mean() > 0.02
    P = pix_t.shape[1]
    if case == "permuted_runs":
        perm = torch.from_numpy(np.random.RandomState(3).permutation(P))
        pix_t, z_ref, i_ref = pix_t[:, perm], z_ref[:, perm], i_ref[:, perm]
    if case.startswith("needles"):
        assert (i_ref >= len(mano.faces)).sum() > 0     # the needles win
    blocks = (_tile_blocks(H, W) if case.startswith("tiles")
              or case.endswith("_tiles") else _run_blocks(P))
    z, i = _culled_scan(proj_t, pix_t, faces_t, blocks)
    np.testing.assert_array_equal(z.numpy(), z_ref.numpy())
    np.testing.assert_array_equal(i.numpy(), i_ref.numpy())


def _binned_scene(mano, case):
    """K10's scenes, torch tensors (proj, pix, faces, (H, W)): posed hands'
    crops at 64^2 (no tile over ``BIN_CAP``) and 128^2, a 64^2 crop whose
    busiest tile holds 584 faces (the whole batch takes the dense answer),
    the random slivers and faces under a pixel, the 128^2 crop with every
    face twice (tied depths: the lower id wins) and with needles."""
    faces = torch.from_numpy(np.asarray(mano.faces, np.int64))
    if case == "slivers":
        proj, pix, f = map(torch.from_numpy, _small_faces_scene(seed=7))
        return proj, pix, f, (64, 64)
    stride, seed = {"hands_64": (2, 23), "overflow": (2, 22)}.get(case,
                                                                  (1, 21))
    _, _, pix, proj = _posed_scene(mano, 128, stride, seed=seed)
    proj = torch.from_numpy(np.array(proj))
    pix = torch.from_numpy(np.array(pix))
    hw = (128 // stride,) * 2
    if case == "ties":
        faces = torch.cat([faces, faces])
    elif case == "needles":
        proj, faces = add_needles(proj, pix, faces, hw, seed=5)
    return proj, pix, faces, hw


def _binned_blocks(tables, hw):
    """K10's raster blocks (``raster_kernel.BINNED_BLOCK`` pixels inside a
    16x16 tile) and each block's list box: its parent tile's sample box,
    or one that every face meets when the set-up's overflow flag is set."""
    H, W = hw
    t = raster_kernel.BIN_TILE
    blocks = _tile_blocks(H, W, raster_kernel.BINNED_BLOCK)
    first = blocks[:, 0]
    box = tables.tbox[:, (first // W // t) * (W // t) + first % W // t]
    if bool(tables.overflow):
        inf = float("inf")
        box = torch.tensor([-inf, inf, -inf, inf]).expand_as(box)
    return blocks, box


BINNED_CASES = ["hands_64", "hands_128", "overflow", "slivers", "ties",
                "needles"]


@pytest.mark.parametrize("case", BINNED_CASES)
def test_binned_cull_matches_binned_plain(mano, case):
    """A plain model of the K10 kernel's walk (csrc/raster_binned.cu): per
    4x16 block, the faces whose screen box meets its parent tile's sample
    box (inclusive, no margin: the tile's list) and whose cover box meets
    the block's own sample box, in ascending order, against
    ``raster_binned_plain`` over ``binned_tables`` bitwise (zbuf and ids);
    with the overflow flag set, every face passes the first test.  The
    plain set-up's counts and flag are ``binned_tables``'."""
    proj, pix, faces, hw = _binned_scene(mano, case)
    tables = TR.binned_setup_plain(proj, faces, pix, hw)
    lists, counts, overflow = TR.binned_tables(proj, pix, faces, hw,
                                               tables.rows)
    assert torch.equal(tables.counts, counts)
    assert torch.equal(tables.overflow, overflow)
    assert bool(overflow) == (case == "overflow")
    assert int(counts.max()) > (raster_kernel.BIN_CAP if case == "overflow"
                                else 0)
    z_ref, i_ref = TR.raster_binned_plain(tables.rows, pix, hw, lists,
                                          counts, overflow)
    assert (z_ref > 0).float().mean() > 0.02
    if case == "ties":
        assert (i_ref < len(mano.faces)).all()
    blocks, box = _binned_blocks(tables, hw)
    z, i = _culled_scan(proj, pix, faces, blocks, list_box=box)
    np.testing.assert_array_equal(z.numpy(), z_ref.numpy())
    np.testing.assert_array_equal(i.numpy(), i_ref.numpy())


def test_binned_cull_fails_with_a_narrower_block_box(mano):
    """The model above is sensitive to its block box: narrowed by 0.5 px,
    it drops faces that cover samples of the sliver scene."""
    proj, pix, faces, hw = _binned_scene(mano, "slivers")
    tables = TR.binned_setup_plain(proj, faces, pix, hw)
    z_ref, i_ref = TR.raster_binned_plain(
        tables.rows, pix, hw,
        *TR.binned_tables(proj, pix, faces, hw, tables.rows))
    blocks, box = _binned_blocks(tables, hw)
    z, i = _culled_scan(proj, pix, faces, blocks, margin=-0.5, list_box=box)
    assert (i != i_ref).sum() > 0


@pytest.mark.parametrize("case", BINNED_CASES)
def test_binned_plain_matches_raster_scan(mano, case):
    """``raster_binned_plain`` over ``binned_tables`` against
    ``raster_scan``: a pixel's answers differ exactly where the scan's
    winner is not in the pixel's tile list (its screen box misses the
    tile's sample box: a face whose rounded edges pass the pixel outside
    its screen box).  That happens on the needles alone, as in the JAX
    package's ``_raster_binned``; the two are bitwise equal on every other
    scene, and where a tile overflows (the dense answer)."""
    proj, pix, faces, hw = _binned_scene(mano, case)
    rows = TR.face_rows(proj, faces)
    tables = TR.binned_tables(proj, pix, faces, hw, rows)
    z_b, i_b = TR.raster_binned_plain(rows, pix, hw, *tables)
    z_s, i_s = TR.raster_scan(proj, pix, faces)
    differ = (z_b != z_s) | (i_b != i_s)
    tile = TR.tile_boxes(pix, hw)                    # (B, G, 4)
    t = raster_kernel.BIN_TILE
    p = torch.arange(pix.shape[1])
    g = (p // hw[1] // t) * (hw[1] // t) + p % hw[1] // t
    win = _screen_boxes(proj, faces).gather(
        1, i_s.clamp_min(0).long()[..., None].expand(-1, -1, 4))
    tb = tile[:, g]
    listed = ((win[..., 0] <= tb[..., 1]) & (win[..., 1] >= tb[..., 0])
              & (win[..., 2] <= tb[..., 3]) & (win[..., 3] >= tb[..., 2]))
    if not bool(tables[2]):
        assert torch.equal(differ, (i_s >= 0) & ~listed)
    assert bool(differ.any()) == (case == "needles")
    if case == "needles":
        assert (i_s >= len(mano.faces)).sum() > 0


def test_cpu_tensors_take_the_plain_version(mano):
    _, _, rays, proj = _posed_scene(mano, 64, 2, seed=5)
    faces = torch.from_numpy(np.asarray(mano.faces, np.int64))
    before = kernels.LAUNCHES["raster_skip"]
    z, i = TR.raster_skip(torch.from_numpy(proj), torch.from_numpy(rays),
                          faces, (32, 32))
    z2, i2 = TR.raster_scan(torch.from_numpy(proj), torch.from_numpy(rays),
                            faces)
    assert kernels.LAUNCHES["raster_skip"] == before
    np.testing.assert_array_equal(z.numpy(), z2.numpy())
    np.testing.assert_array_equal(i.numpy(), i2.numpy())
