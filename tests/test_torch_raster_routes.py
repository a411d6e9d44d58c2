"""Port parity for the raster routes of ``rasterize_depth`` against
dsf_tpu: the dense route's plain version (K6's) against ``raster_pallas``
in interpret mode and against ``_raster_scan``; the binned route's plain
version (K10's) and ``rasterize_depth(tile_hw=...)`` against JAX's
``_raster_binned`` on the CPU, with a tile that overflows ``BIN_CAP`` and
with tied faces; the route dispatch; and the renderer's crop raster
without the skip route.  The kernels run on the card only
(test_torch_kernels_cuda.py).

XLA on the CPU contracts the depth plane into a fused multiply-add and
the port rounds each product on its own, so the two depths differ by a
few float32 ulps and an edge pixel may flip.  Each side is held against
the port's float64 raster, and the two against each other."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from dsf_tpu.ops import pallas_raster as JPR
from dsf_tpu.ops import rasterize as JR
from dsf_tpu_torch import demo
from dsf_tpu_torch.mano import model as TM, synthetic as TS
from dsf_tpu_torch.ops import rasterize as R
from dsf_tpu_torch.render import renderer as TRN

torch.set_num_threads(2)

PARAS = (100.0, 100.0, 32.0, 32.0)
# float32 depth against float64: the face coefficients' float32 rounding,
# which 1/A amplifies on small triangles, the same on both sides (measured
# up to 5.4e-5 relative, port and JAX alike)
Z64_RTOL = 1e-4
# float32 depth of one side against the other's: the FMA against the
# separately rounded products (measured up to 1.1e-6 relative)
Z_RTOL = 2e-6
# pixels whose face id may differ: edge pixels that a rounding puts on the
# other side (measured: none here)
FLIP_SHARE = 2e-3


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(JPR.pl, "pallas_call", patched)
    yield


def _hold(name, z, i, z64, i64, rtol=Z64_RTOL):
    """zbuf and ids of one side against the float64 raster (or against the
    other side, at ``Z_RTOL``)."""
    z, i = np.asarray(z), np.asarray(i)
    same = (i == i64) & (i >= 0)
    assert (i != i64).mean() <= FLIP_SHARE, (name, (i != i64).mean())
    rel = np.abs(z - z64)[same] / z64[same]
    assert rel.max() <= rtol, (name, rel.max())
    assert (z[i < 0] == 0).all()


def _float64(proj, pix, faces):
    z, i = R.raster_scan(torch.from_numpy(np.asarray(proj)).double(),
                         torch.from_numpy(np.asarray(pix)).double(),
                         torch.from_numpy(np.asarray(faces)))
    return z.numpy(), i.numpy()


def _random_mesh(seed, B=2, V=60, F=130):
    rng = np.random.RandomState(seed)
    verts = (rng.randn(B, V, 3) * 10 + [0, 0, 100]).astype(np.float32)
    faces = np.stack([rng.choice(V, 3, replace=False)
                      for _ in range(F)]).astype(np.int64)
    return verts, faces


def test_dense_plain_matches_raster_pallas_and_scan(interpret_pallas):
    """K6's plain version (``raster_scan``, the dense route of
    ``rasterize_depth``) against the Pallas dense kernel (interpret mode,
    its 1024-pixel tiles padding a 60x50 frame) and XLA's ``_raster_scan``,
    each against float64."""
    verts, faces = _random_mesh(0)
    B = verts.shape[0]
    pix = np.broadcast_to(np.asarray(JR.full_frame_pixel_rays((60, 50))),
                          (B, 3000, 2))
    assert np.array_equal(R.full_frame_pixel_rays((60, 50)).numpy(), pix[0])
    proj = np.asarray(JR.project_verts(jnp.asarray(verts), PARAS))
    z_p, i_p = R.rasterize_depth(torch.from_numpy(verts),
                                 torch.from_numpy(faces),
                                 R.full_frame_pixel_rays((60, 50)), PARAS,
                                 return_idx=True)
    z_k, i_k = JPR.raster_pallas(jnp.asarray(proj), jnp.asarray(pix),
                                 jnp.asarray(faces))
    z_s, i_s = JR._raster_scan(jnp.asarray(proj), jnp.asarray(pix),
                               jnp.asarray(faces))
    z64, i64 = _float64(proj, pix, faces)
    assert (i64 >= 0).mean() > 0.2
    for name, z, i in (("port", z_p.numpy(), i_p.numpy()),
                       ("raster_pallas", z_k, i_k), ("_raster_scan", z_s, i_s)):
        _hold(name, z, i, z64, i64)
        if name != "port":
            _hold(name, z_p.numpy(), i_p.numpy(), np.asarray(z), np.asarray(i),
                  Z_RTOL)


def _tiles_mesh(kind, B=2, H=64, W=64):
    """Small triangles in front of a 64x64 frame, one set of three vertices
    each: "spread" over the frame (no 16x16 tile holds 512 faces),
    "overflow" with 600 of them over one tile, "ties" as "spread" with
    every face twice (equal depths: the lower index must win)."""
    rng = np.random.RandomState({"spread": 1, "overflow": 2, "ties": 3}[kind])
    F = 300 if kind == "ties" else 700
    lo, hi = ((20, 30) if kind == "overflow" else (-2, 66))
    c = rng.uniform(lo, hi, (B, F, 1, 2))
    uv = c + rng.uniform(-4, 4, (B, F, 3, 2))
    z = rng.uniform(50, 150, (B, F, 1, 1)) + rng.uniform(-3, 3, (B, F, 3, 1))
    # back-project through PARAS: u = x fx / z + cx
    xy = (uv - [PARAS[2], PARAS[3]]) * z / [PARAS[0], PARAS[1]]
    verts = np.concatenate([xy, z], -1).reshape(B, F * 3, 3).astype(np.float32)
    faces = np.arange(F * 3).reshape(F, 3)
    if kind == "ties":
        faces = np.concatenate([faces, faces])
    return verts, faces.astype(np.int64)


@pytest.mark.parametrize("kind", ["spread", "overflow", "ties"])
def test_binned_matches_jax_binned(kind, monkeypatch):
    """K10's plain version, through ``rasterize_depth(tile_hw=...)`` with
    the skip route off and on its own over ``binned_tables``, against
    JAX's ``_raster_binned`` on the CPU: the tile lists against numpy
    (ascending face ids, the faces whose bbox meets the tile's samples'),
    the overflow flag, zbuf and ids against float64 on both sides, and the
    port bitwise-equal to its own dense scan.  With tied faces both sides
    pick the first copy."""
    monkeypatch.setattr(R, "USE_PALLAS_SKIP", False)
    verts, faces = _tiles_mesh(kind)
    B, H, W = verts.shape[0], 64, 64
    pix = np.broadcast_to(np.asarray(JR.full_frame_pixel_rays((W, H))),
                          (B, H * W, 2))
    proj = np.asarray(JR.project_verts(jnp.asarray(verts), PARAS))
    z_j, i_j = JR._raster_binned(jnp.asarray(proj), jnp.asarray(pix),
                                 jnp.asarray(faces), (H, W))
    z_p, i_p = R.rasterize_depth(torch.from_numpy(verts),
                                 torch.from_numpy(faces),
                                 torch.from_numpy(pix[0].copy()), PARAS,
                                 return_idx=True, tile_hw=(H, W))
    proj_t = torch.from_numpy(proj)
    pix_t = torch.from_numpy(pix.copy())
    faces_t = torch.from_numpy(faces)
    rows = R.face_rows(proj_t, faces_t)
    lists, counts, overflow = R.binned_tables(proj_t, pix_t, faces_t, (H, W),
                                              rows)
    z_b, i_b = R.raster_binned_plain(rows, pix_t, (H, W), lists, counts,
                                     overflow)
    z_d, i_d = R.raster_scan(proj_t, pix_t, faces_t)
    assert torch.equal(z_b, z_p) and torch.equal(i_b, i_p)
    assert torch.equal(z_b, z_d) and torch.equal(i_b, i_d)

    # the lists, by numpy
    t = R.BIN_TILE
    puv = pix.reshape(B, H // t, t, W // t, t, 2).transpose(0, 1, 3, 2, 4, 5)
    puv = puv.reshape(B, -1, t * t, 2)
    tmin, tmax = puv.min(2), puv.max(2)
    tri = proj[:, faces][..., :2]
    fmin, fmax = tri.min(2), tri.max(2)
    valid = rows[..., 12].numpy() != 0
    inter = (((fmin[:, None] <= tmax[:, :, None])
              & (fmax[:, None] >= tmin[:, :, None])).all(-1)
             & valid[:, None])
    assert np.array_equal(counts.numpy(), inter.sum(-1))
    assert bool(overflow.item()) == (kind == "overflow")
    for b in range(B):
        for g in range(inter.shape[1]):
            got = lists[b, g].numpy()
            want = np.nonzero(inter[b, g])[0][:R.BIN_CAP]
            assert np.array_equal(got[:len(want)], want)
            assert (got[len(want):] == -1).all()

    z64, i64 = _float64(proj, pix, faces)
    assert (i64 >= 0).mean() > 0.05
    for name, z, i in (("port", z_p.numpy(), i_p.numpy()),
                       ("jax", np.asarray(z_j), np.asarray(i_j))):
        _hold(name, z, i, z64, i64)
    _hold("port vs jax", z_p.numpy(), i_p.numpy(), np.asarray(z_j),
          np.asarray(i_j), Z_RTOL)
    if kind == "ties":
        F = faces.shape[0] // 2
        assert (np.asarray(i_j)[np.asarray(i_j) >= 0] < F).all()
        assert (i_p.numpy()[i_p.numpy() >= 0] < F).all()


def test_routes_follow_the_switches(monkeypatch):
    """``rasterize_depth`` picks the JAX package's route on the CPU as on a
    card: skip with a 16-aligned layout (``tile_hw`` or ``layout_hw``),
    binned with ``tile_hw`` and the skip switch off, dense without a
    layout or for a layout that is not 16-aligned, binned falling back to
    dense at most ``BIN_CAP`` faces; ``return_idx``'s skip route reads
    ``layout_hw`` alone."""
    calls = []
    for name in ("skip_forward", "binned_forward", "dense_forward"):
        orig = getattr(R, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(R, name, spy)
    verts, faces = _tiles_mesh("spread")
    v, f = torch.from_numpy(verts), torch.from_numpy(faces)

    def route(faces=f, **kw):
        hw = kw.get("tile_hw") or kw.get("layout_hw") or (64, 64)
        calls.clear()
        R.rasterize_depth(v, faces, R.full_frame_pixel_rays(hw[::-1]), PARAS,
                          **kw)
        return list(calls)

    assert route(tile_hw=(64, 64)) == ["skip_forward"]
    assert route(layout_hw=(64, 64)) == ["skip_forward"]
    assert route() == ["dense_forward"]
    assert route(return_idx=True, tile_hw=(64, 64)) == ["binned_forward"]
    assert route(tile_hw=(64, 60)) == ["binned_forward", "dense_forward"]
    monkeypatch.setattr(R, "USE_PALLAS_SKIP", False)
    assert route(tile_hw=(64, 64)) == ["binned_forward"]
    assert route(layout_hw=(64, 64)) == ["dense_forward"]
    assert route(faces=f[:R.BIN_CAP], tile_hw=(64, 64)) == [
        "binned_forward", "dense_forward"]


@pytest.fixture(scope="module")
def renderer(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    TS.save_synthetic_mano(path)
    return TRN.Renderer.create(TM.load_model(path, device="cpu"), "nyu",
                               demo.PARAS, (640, 480), (128, 128))


@pytest.mark.parametrize("stride", [1, 2])
def test_crop_raster_unchanged_without_skip(renderer, stride, monkeypatch):
    """The renderer's crop raster (rasterize_depth with tile_hw, as JAX's
    renderer calls it) with ``USE_PALLAS_SKIP`` off takes the binned route
    (K10's plain version) and gives the skip route's depth bit for bit,
    and its gradient in the MANO parameters."""
    para, center, cube = demo.posed_params(renderer, 3,
                                           np.random.RandomState(stride))
    out = []
    for skip in (True, False):
        monkeypatch.setattr(R, "USE_PALLAS_SKIP", skip)
        p = para.clone().requires_grad_(True)
        img, _, _, _ = TRN.render_params(renderer, p, center, cube,
                                         img_stride=stride)
        (img * torch.linspace(0, 1, img.numel()).reshape(img.shape)).sum(
            ).backward()
        out.append((img.detach(), p.grad))
    assert (out[0][0] < 0.99).float().mean() > 0.02
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
