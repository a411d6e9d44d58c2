"""Port parity for the library surface around the kernels, against dsf_tpu
on the CPU from the same numpy-seeded inputs: geometry's grids and
``xyz_nl_to_uvd_nl``, the MANO finger tables, ``warp_perspective`` and
``roi_align``, ``splat_points_min``, ``pcl_to_img``, ``img_to_pcl``'s fixed
scores, the skeleton-interpolation labelers, the codec dispatchers,
``data/pcl_utils``, ``depth_loss_select`` and ``surface_loss``.  The JAX
side is jitted once per call site (eager dispatch compiles every op and
costs ten times the time), except where the port is held bit for bit to
an expression whose multiply-adds XLA's fused code would round once:
there it runs eagerly, op by op, as the port rounds.

Tolerances: integer labels, scatters and index grids bitwise; sums and
interpolations to float32 rounding, stated at each test."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dsf_tpu import geometry as JG
from dsf_tpu.data import pcl_utils as JU
from dsf_tpu.losses import basic as JB, icp as JI
from dsf_tpu.mano import model as JM, synthetic as JS
from dsf_tpu.ops import cloud as JC, image as JIm, offset_codec as JO
from dsf_tpu.ops import rasterize as JR
from dsf_tpu_torch import geometry as TG
from dsf_tpu_torch.data import pcl_utils as TU
from dsf_tpu_torch.losses import basic as TB, icp as TI
from dsf_tpu_torch.mano import model as TM
from dsf_tpu_torch.ops import cloud as TC, image as TIm, offset_codec as TO
from dsf_tpu_torch.ops import rasterize as TR

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S = 32
B = 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def crop():
    """Two crops of S^2 on the NYU camera: skeletons in normalized units,
    their centres and cubes, the crop matrices, normalized depth images
    with some background rows and the foreground mask of JAX's
    joint_to_bk_seg."""
    rng = np.random.RandomState(3)
    joint = rng.uniform(-0.6, 0.6, (B, 21, 3)).astype(np.float32)
    center = np.stack([rng.uniform(-30, 30, B), rng.uniform(-30, 30, B),
                       rng.uniform(700, 800, B)], -1).astype(np.float32)
    cube = np.full((B, 3), 250.0, np.float32)
    com = _np(JG.xyz_to_uvd(jnp.asarray(center), PARAS))
    M = _np(JG.crop_matrix(jnp.asarray(com), jnp.asarray(cube), PARAS,
                           (S, S)))
    img = rng.uniform(-1, 1, (B, 1, S, S)).astype(np.float32)
    img[:, :, :4] = 1.0
    return dict(joint=joint, center=center, cube=cube, M=M, img=img)


def _cam(c):
    return [c[k] for k in ("center", "M", "cube")]


@pytest.mark.parametrize("n", [8, 31, 64])
def test_grids_match_jax_bitwise(n):
    """norm_grid_center / norm_grid_corner, and the two grids the port
    builds from them (the cloud's uvd grid, the codec's coordinates),
    bit for bit."""
    for tf, jf in ((TG.norm_grid_center, JG.norm_grid_center),
                   (TG.norm_grid_corner, JG.norm_grid_corner)):
        for g, r in zip(tf(n), jf(n)):
            np.testing.assert_array_equal(g.numpy(), _np(r))
    depth = np.random.RandomState(n).uniform(-1, 1, (2, 1, n, n)).astype(
        np.float32)
    np.testing.assert_array_equal(
        TC.uvd_image_grid(_t(depth), n).numpy(),
        _np(JC.uvd_image_grid(jnp.asarray(depth), n)))
    np.testing.assert_array_equal(TO._coords(_t(depth), n).numpy(),
                                  _np(JO._coords(jnp.asarray(depth), n)))


def test_xyz_nl_to_uvd_nl_matches_jax(crop):
    """To 1e-5 (float32 rounding of values of order 1), and the inverse of
    uvd_nl_to_xyz_nl to 1e-4."""
    xyz = crop["joint"]
    args = [_t(x) for x in _cam(crop)]
    got = TG.xyz_nl_to_uvd_nl(_t(xyz), args[0], args[1], args[2], PARAS, S)
    ref = jax.jit(lambda *a: JG.xyz_nl_to_uvd_nl(*a, PARAS, S))(
        xyz, *_cam(crop))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0, atol=1e-5)
    back = TG.uvd_nl_to_xyz_nl(got, args[0], args[1], args[2], PARAS, S)
    np.testing.assert_allclose(back.numpy(), xyz, rtol=0, atol=1e-4)


def test_mano_finger_tables_match_jax(tmp_path):
    path = str(tmp_path / "syn.npz")
    JS.save_synthetic_mano(path)
    tm, jm = TM.load_model(path, device="cpu"), JM.load_model(path)
    for name in ("finger_seg", "finger_face_mask", "vertex_seg",
                 "joint_face_mask"):
        got, ref = getattr(tm, name).numpy(), _np(getattr(jm, name))
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref)
    assert tm.finger_face_mask.shape == (tm.faces.shape[0], 5)
    assert tm.finger_face_mask.any(0).all()


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_warp_perspective_matches_jax(crop, mode):
    """A 480x640 frame warped into S^2 crops: nearest bitwise, bilinear to
    1e-6 of the image's range (four float32 products summed)."""
    rng = np.random.RandomState(4)
    frame = rng.uniform(0, 1, (B, 1, 480, 640)).astype(np.float32)
    got = TIm.warp_perspective(_t(frame), _t(crop["M"]), (S, S), mode)
    ref = JIm.warp_perspective(jnp.asarray(frame), jnp.asarray(crop["M"]),
                               (S, S), mode)
    assert got.shape == (B, 1, S, S) and (got.numpy() > 0).mean() > 0.9
    if mode == "nearest":
        np.testing.assert_array_equal(got.numpy(), _np(ref))
    else:
        np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0, atol=1e-6)


def test_roi_align_matches_jax():
    """Boxes inside, across and outside the image's edges, at two scales
    and two sampling ratios, each side held against the port in float64:
    to 4e-6 (bilinear weights and a mean of s^2 samples of values in
    [-1, 1]; XLA's fused multiply-adds put JAX's 2.5e-6 from the port's
    float32, measured)."""
    rng = np.random.RandomState(5)
    img = rng.uniform(-1, 1, (2, 3, 20, 24)).astype(np.float32)
    rois = np.array([[0, 2.3, 1.7, 15.2, 12.9], [1, -3.0, -2.5, 10.0, 8.0],
                     [1, 18.5, 14.0, 30.0, 26.0], [0, 5.0, 5.0, 5.5, 5.5]],
                    np.float32)
    for scale in (1.0, 0.5):
        for s in (1, 2):
            got = TIm.roi_align(_t(img), _t(rois), (7, 5), scale, s).numpy()
            ref = np.asarray(jax.jit(lambda a, r: JIm.roi_align(
                a, r, (7, 5), scale, s))(img, rois))
            g64 = TIm.roi_align(_t(img).double(), _t(rois).double(), (7, 5),
                                scale, s).numpy()
            assert got.shape == (4, 3, 7, 5) and np.abs(g64).max() > 0.1
            for x in (got, ref):
                np.testing.assert_allclose(x, g64, rtol=0, atol=4e-6)


def test_splat_points_min_matches_jax_bitwise():
    """300 points per cloud into 16^2, many sharing a pixel, some off the
    image (clamped): the least depth per pixel, background elsewhere."""
    rng = np.random.RandomState(6)
    uvd = np.concatenate([rng.uniform(-2, 18, (B, 300, 2)),
                          rng.uniform(100, 900, (B, 300, 1))],
                         -1).astype(np.float32)
    for bg in (0.0, -1.0):
        got = TR.splat_points_min(_t(uvd), 16, bg).numpy()
        ref = _np(jax.jit(lambda u: JR.splat_points_min(u, 16, bg))(uvd))
        np.testing.assert_array_equal(got, ref)
        assert (got == bg).sum() > 0 and (got != bg).mean() > 0.5


def test_pcl_to_img_matches_jax_bitwise(crop):
    """256 points into 16^2 and 32^2 images: on a pixel that several
    points hit, the last point's depth, bitwise (the port finds the last
    writer by a scatter-max of point indices)."""
    rng = np.random.RandomState(7)
    pcl = rng.uniform(-0.9, 0.9, (B, 256, 3)).astype(np.float32)
    for fs in (16, 32):
        got = TC.pcl_to_img(_t(pcl), fs, *map(_t, _cam(crop)), PARAS, S)
        ref = JC.pcl_to_img(jnp.asarray(pcl), fs,
                            *map(jnp.asarray, _cam(crop)), PARAS, S)
        np.testing.assert_array_equal(got.numpy(), _np(ref))
        assert got.shape == (B, 1, fs, fs) and (got.numpy() != 1).sum() > 100


def test_img_to_pcl_fixed_scores_match_jax(crop):
    """img_to_pcl(None, ...): the scores are JAX's uint32 Weyl sequence,
    bitwise, so the same pixels are taken in the same order; the points
    agree to 1e-5 (float32 rounding of the unprojection).  An empty image
    gives zeros on both sides."""
    n = 64 * 64
    i = np.arange(n, dtype=np.uint32)
    weyl = ((i * np.uint32(2654435761)) >> 8).astype(np.float32) / (1 << 24)
    np.testing.assert_array_equal(TC.weyl_scores(n).numpy(), weyl)
    img = crop["img"].copy()
    img[1] = 1.0
    got = TC.img_to_pcl(None, _t(img), *map(_t, _cam(crop)), PARAS, S,
                        sample_num=300, feature_size=S)
    ref = jax.jit(lambda *a: JC.img_to_pcl(None, *a, PARAS, S, sample_num=300,
                                           feature_size=S))(img, *_cam(crop))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0, atol=1e-5)
    assert (got[1] == 0).all() and (got[0] != 0).any()


@pytest.mark.parametrize("interval", [4, 6])
def test_interpolation_joint_and_tables_match_jax(crop, interval):
    """The densified skeleton bitwise (the interpolation weights are
    jnp.linspace's, i / (n - 1) in float32), and both label tables."""
    got = TC.interpolation_joint(_t(crop["joint"]), interval)
    ref = JC.interpolation_joint(jnp.asarray(crop["joint"]), interval)
    np.testing.assert_array_equal(got.numpy(), _np(ref))
    assert got.shape == (B, 1 + 5 * interval + 15 * (interval + 1), 3)
    np.testing.assert_array_equal(TC._finger_label_table(interval),
                                  JC._finger_label_table(interval))
    np.testing.assert_array_equal(TC._joint_label_table(interval),
                                  JC._joint_label_table(interval))


@pytest.mark.parametrize("interval", [4, 6])
def test_labelers_match_jax_bitwise(crop, interval):
    """joint_to_bk_seg, joint_to_finger_seg, joint_to_joint_seg and
    pcl_to_joint_seg: the same label at every pixel and point, each label
    set used."""
    img, joint = _t(crop["img"]), _t(crop["joint"])
    cam_t, cam_j = list(map(_t, _cam(crop))), list(map(jnp.asarray,
                                                        _cam(crop)))
    jimg, jjoint = jnp.asarray(crop["img"]), jnp.asarray(crop["joint"])
    bk = TC.joint_to_bk_seg(img, joint, *cam_t, PARAS, S)
    jbk = jax.jit(lambda *a: JC.joint_to_bk_seg(*a, PARAS, S))(
        jimg, jjoint, *cam_j)
    np.testing.assert_array_equal(bk.numpy(), _np(jbk))
    assert 0.1 < bk.numpy().mean() < 0.9
    for tf, jf, bg in ((TC.joint_to_finger_seg, JC.joint_to_finger_seg, 6),
                       (TC.joint_to_joint_seg, JC.joint_to_joint_seg, 21)):
        got = tf(img, joint, *cam_t, PARAS, S, interval, bk)
        ref = jax.jit(lambda i, j, c, m, cu, bk_: jf(
            i, j, c, m, cu, PARAS, S, interval, bk_))(jimg, jjoint, *cam_j,
                                                      jbk)
        np.testing.assert_array_equal(got.numpy(), _np(ref))
        assert (got.numpy() == bg).any() and len(np.unique(got.numpy())) > 4
    rng = np.random.RandomState(8)
    pcl = rng.uniform(-0.8, 0.8, (B, 256, 3)).astype(np.float32)
    mask = np.ones((B, 256), np.int32)
    mask[:, :8] = 0
    got = TC.pcl_to_joint_seg(_t(pcl), joint, interval, _t(mask))
    ref = jax.jit(lambda p, j, m: JC.pcl_to_joint_seg(p, j, interval, m))(
        pcl, jjoint, mask)
    np.testing.assert_array_equal(got.numpy(), _np(ref))
    assert (got.numpy()[:, :8] == 21).all()


@pytest.mark.parametrize("types,paras", [(("offset",), (0.8,)),
                                         (("heatmap", "offset"), (0.3, 0.6)),
                                         (("heatmap",), (0.8,))])
def test_codec_dispatchers_match_jax(types, paras):
    """joint2feature / feature2joint take the last "offset" entry's
    parameter and give None without one; the feature and the decoded
    joints to 1e-5 (the codec tests' tolerance)."""
    rng = np.random.RandomState(9)
    joint = rng.uniform(-0.7, 0.7, (B, 21, 3)).astype(np.float32)
    img = rng.uniform(-1, 1, (B, 1, 64, 64)).astype(np.float32)
    img[:, :, :10] = 1.0
    got = TO.joint2feature(_t(joint), _t(img), paras, S, types)
    ref = jax.jit(lambda j, i: JO.joint2feature(j, i, paras, S, types))(
        joint, img)
    if "offset" not in types:
        assert got is None and ref is None
        assert TO.feature2joint(_t(img), _t(img), types, paras) is None
        return
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0, atol=1e-5)
    jg = TO.feature2joint(_t(img), got, types, paras)
    jr = jax.jit(lambda i, f: JO.feature2joint(i, f, types, paras))(img, ref)
    np.testing.assert_allclose(jg.numpy(), _np(jr), rtol=0, atol=1e-5)
    assert jg.shape == (B, 21, 3)


def test_pcl_utils_match_jax():
    """The numpy copy: every function's output equal to the JAX package's
    for the same inputs and seeds (the same numpy code and RandomState)."""
    rng = np.random.RandomState(10)
    dpt = rng.uniform(500, 900, (S, S))
    dpt[:8] = 0.0
    M = np.array([[0.5, 0, -10], [0, 0.5, -20], [0, 0, 1]])
    for f in (lambda U: U.depth_to_pcl(dpt, M, PARAS, -1.0),
              lambda U: U.get_pcl(dpt / 1000.0 - 0.2, np.array([5., 8., 700.]),
                                  np.array([250., 250., 250.]), M, PARAS)):
        np.testing.assert_array_equal(f(TU), f(JU))
    xyz = rng.randn(400, 3)
    joint = rng.randn(21, 3) * 20
    for seed in (0, 3):
        np.testing.assert_array_equal(TU.farthest_point_sample(xyz, 64, seed),
                                      JU.farthest_point_sample(xyz, 64, seed))
        np.testing.assert_array_equal(
            TU.farthest_point_sample(xyz[:30], 64, seed),
            JU.farthest_point_sample(xyz[:30], 64, seed))
        np.testing.assert_array_equal(TU.joint_to_pc(joint, 512, 15.0, seed),
                                      JU.joint_to_pc(joint, 512, 15.0, seed))
        for pts in (xyz, xyz[:200], xyz[:5]):
            for g, r in zip(TU.pca_point(pts, joint, 256, seed),
                            JU.pca_point(pts, joint, 256, seed)):
                np.testing.assert_array_equal(g, r)


def test_save_label_matches_jax(tmp_path):
    lab = np.random.RandomState(11).uniform(0, 640, (3, 21, 3))
    TU.save_label(str(tmp_path / "t.txt"), lab)
    JU.save_label(str(tmp_path / "j.txt"), lab)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_depth_loss_select_matches_jax(crop):
    """To 1e-6 relative (a float32 sum over the batch in another order),
    and 0 where no pixel is foreground in both."""
    rng = np.random.RandomState(12)
    real = crop["img"]
    synth = np.where(rng.rand(*real.shape) < 0.3, 1.0,
                     real + rng.randn(*real.shape) * 0.05).astype(np.float32)
    got = TB.depth_loss_select(_t(real), _t(synth))
    ref = jax.jit(JB.depth_loss_select)(real, synth)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    ones = np.ones_like(real)
    assert float(TB.depth_loss_select(_t(real), _t(ones))) == 0.0


def test_surface_loss_matches_jax(crop):
    """surface_loss with the scores JAX draws from PRNGKey(0) (its default
    when given no key) and the gradient in the vertices: to 1e-5 relative
    (a chamfer of float32 squared distances, means in another order).
    chamfer_distance alone likewise."""
    rng = np.random.RandomState(13)
    verts = rng.uniform(-0.7, 0.7, (B, 200, 3)).astype(np.float32)
    score = _t(jax.random.uniform(jax.random.PRNGKey(0), (B, S * S)))
    v = _t(verts).requires_grad_(True)
    got = TB.surface_loss(score, _t(crop["img"]), v, *map(_t, _cam(crop)),
                          PARAS, S, sample_num=300)
    got.backward()
    ref, gref = jax.jit(jax.value_and_grad(
        lambda vv: JB.surface_loss(jnp.asarray(crop["img"]), vv,
                                   *map(jnp.asarray, _cam(crop)), PARAS, S,
                                   sample_num=300)))(verts)
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(v.grad.numpy(), _np(gref), rtol=0,
                               atol=1e-5 * np.abs(_np(gref)).max())
    x = rng.randn(B, 50, 3).astype(np.float32)
    np.testing.assert_allclose(
        TI.chamfer_distance(_t(x), _t(verts)).numpy(),
        _np(jax.jit(JI.chamfer_distance)(x, verts)),
        rtol=1e-5)


def test_draw_scores_shape_and_support():
    gen = torch.Generator().manual_seed(0)
    s = TC.draw_scores(gen, 3, 16)
    assert s.shape == (3, 256) and 0 <= float(s.min()) and float(s.max()) < 1
