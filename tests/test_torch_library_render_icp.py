"""Port parity for the reference's other renders and the losses around
them, against dsf_tpu on the CPU from the same numpy-seeded inputs:
``normal_render``, ``m_render``, ``mesh_to_img`` and ``get_depth`` (each
through the crop raster, with the skip route's plain version and, with
``USE_PALLAS_SKIP`` off, the binned one; ``get_depth``'s gradient through
the per-face moments), ``synth2real``, ``patch_gaussian``,
``mass_center``, the sphere part labels and distances, and the three ICP
losses under each argmin switch (K3's, K7's and K8's plain versions), on
the synthetic MANO hand.  Draws are jax.random's, handed to the port as
tensors.  The JAX side is jitted once per function and shared by the
tests."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dsf_tpu import geometry as JG
from dsf_tpu.losses import icp as JI
from dsf_tpu.mano import model as JM, spheres as JSP, synthetic as JS
from dsf_tpu.render import renderer as JR
from dsf_tpu_torch.losses import icp as TI
from dsf_tpu_torch.mano import model as TM, spheres as TSP
from dsf_tpu_torch.ops import point_mesh as PM, rasterize as TRas
from dsf_tpu_torch.render import renderer as TR
from torch_parity import jax_mask_draws

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S, B, P = 64, 2, 256


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Both packages' renderers on the NYU camera at S^2; two hands as
    raw-unit parameters (mm, translated to their crop centres), their
    world vertices and joints, the crop matrices, and normalized-unit
    parameters for normal_render."""
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    tm, jm = TM.load_model(path, device="cpu"), JM.load_model(path)
    tr = TR.Renderer.create(tm, "nyu", PARAS, (640, 480), (S, S))
    jr = JR.Renderer.create(jm, "nyu", PARAS, (640, 480), (S, S))
    rng = np.random.RandomState(20)
    center = np.stack([rng.uniform(-30, 30, B), rng.uniform(-30, 30, B),
                       rng.uniform(650, 800, B)], -1).astype(np.float32)
    cube = np.full((B, 3), 250.0, np.float32)
    raw = np.zeros((B, 62), np.float32)
    raw[:, :48] = rng.randn(B, 48) * 0.3
    raw[:, 58] = 1.0
    raw[:, 59:] = center
    norm = np.zeros((B, 62), np.float32)
    norm[:, :48] = rng.randn(B, 48) * 0.3
    norm[:, 58] = 1.0
    norm[:, 59:] = rng.randn(B, 3) * 0.05 - 0.8
    com = _np(JG.xyz_to_uvd(jnp.asarray(center), PARAS))
    M = _np(JG.crop_matrix(jnp.asarray(com), jnp.asarray(cube), PARAS,
                           (S, S)))
    verts, joints = TM.get_mano_vertices(tm, *TM.split_params(_t(raw)))
    rot = (rng.randn(B, 3) * 0.3).astype(np.float32)
    return dict(tm=tm, jm=jm, tr=tr, jr=jr, center=center, cube=cube, raw=raw,
                norm=norm, M=M, verts=_np(verts), joints=_np(joints), rot=rot,
                key=jax.random.PRNGKey(21), rng=rng)


def _float(model, dtype):
    """``model`` with its float constants in ``dtype``."""
    return dataclasses.replace(model, **{
        f.name: getattr(model, f.name).to(dtype)
        for f in dataclasses.fields(model)
        if torch.is_tensor(getattr(model, f.name))
        and getattr(model, f.name).is_floating_point()})


def _render_args(sc, name):
    """(port callable, JAX callable, numpy inputs) of one render."""
    c, cu, M = sc["center"], sc["cube"], sc["M"]
    if name == "normal_render":
        return (lambda r, *a: TR.normal_render(r, *a),
                lambda r, *a: JR.normal_render(r, *a), [sc["norm"], c, cu])
    if name == "m_render":
        draws = jax_mask_draws(sc["key"], B)
        return (lambda r, *a: TR.m_render(r, *a, mask=draws),
                lambda r, *a: JR.m_render(r, sc["key"], *a, mask=True),
                [sc["raw"], c, cu, M])
    if name == "mesh_to_img":
        return (lambda r, *a: TR.mesh_to_img(r, *a),
                lambda r, *a: JR.mesh_to_img(r, *a), [sc["verts"], c, cu])
    return (lambda r, *a: TR.get_depth(r, *a),
            lambda r, *a: JR.get_depth(r, *a),
            [sc["verts"], sc["joints"], c, cu, M, sc["rot"]])


RENDERS = ("normal_render", "m_render", "mesh_to_img", "get_depth")


@pytest.fixture(scope="module")
def jax_renders(scene):
    """Each render's JAX outputs (the CPU's binned raster), one jit each;
    get_depth's with the gradient of its image sum in the vertices."""
    out = {}
    for name in RENDERS[:-1]:
        _, jf, ins = _render_args(scene, name)
        res = jax.jit(lambda *a: jf(scene["jr"], *a))(*ins)
        out[name] = [np.asarray(x) for x in
                     (res if isinstance(res, tuple) else (res,))]
    _, jf, ins = _render_args(scene, "get_depth")

    def img_sum(v, *a):
        img, juvd = jf(scene["jr"], v, *a)
        return img.sum(), (img, juvd)

    (_, res), grad = jax.jit(jax.value_and_grad(img_sum, has_aux=True))(*ins)
    out["get_depth"] = [np.asarray(x) for x in res]
    out["get_depth_grad"] = np.asarray(grad)
    return out


def _hold_image(got, ref):
    """The raster is discontinuous at silhouettes and occluding edges, and
    the two LBS implementations' rounding (~6e-5 mm) moves a few pixels
    across them (test_torch_train_render.py): coverage and the occlusion
    spheres differ on at most 1 pixel in 4096, and at most 0.2% of the
    pixels lie beyond 1e-3 (0.125 mm)."""
    assert got.shape == ref.shape
    assert ((got < 0.99) != (ref < 0.99)).mean() <= 1 / 4096
    assert ((got == 1.0) != (ref == 1.0)).mean() <= 1 / 4096
    assert (np.abs(got - ref) > 1e-3).mean() <= 2e-3


@pytest.mark.parametrize("route", ["skip", "binned"])
def test_renders_match_jax(scene, jax_renders, route, monkeypatch):
    """The four renders, the port's crop raster on the skip route (K1's
    plain version) and, with USE_PALLAS_SKIP off, the binned one (K10's),
    against JAX's binned raster: images held as ``_hold_image`` says, with
    the hand covering part of each crop; the labels (joint uvd and xyz)
    to 1e-5 (float32 LBS in another order)."""
    monkeypatch.setattr(TRas, "USE_PALLAS_SKIP", route == "skip")
    for name in RENDERS:
        tf, _, ins = _render_args(scene, name)
        with torch.no_grad():
            res = tf(scene["tr"], *map(_t, ins))
        got = [_np(x) for x in (res if isinstance(res, tuple) else (res,))]
        ref = jax_renders[name]
        assert len(got) == len(ref), name
        _hold_image(got[0], ref[0])
        assert (got[0] < 0.99).mean() > 0.02, name
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5, err_msg=name)
    assert (jax_renders["m_render"][0] == 1.0).sum() > (
        jax_renders["mesh_to_img"][0] == 1.0).sum()


def test_get_depth_gradient_matches_jax(scene, jax_renders):
    """d/d verts of get_depth's image summed: the hard raster gradient
    through each pixel's face plane, from the per-face moments (K2's plain
    version, index_add_), against jax.grad, with the same coverage.

    That gradient is ill-conditioned in float32: a face seen nearly edge-on
    after the view rotation has depth-plane coefficients of order 1/area,
    and rounding in its projection moves them (measured here: the port's
    own float32 and float64 gradients 4.8% apart in relative L2, JAX's
    float32 1.5% from the port's float64, the port's and JAX's float32
    4.6% apart).  So each pair is held where the rounding does not reach:
    at most 1% of the entries beyond 1e-3 of the largest (measured 0.4% to
    0.5%), and within 10% relative L2."""
    sc = scene
    args = [sc["joints"], sc["center"], sc["cube"], sc["M"], sc["rot"]]

    def port(dtype):
        r = TR.Renderer.create(_float(sc["tm"], dtype), "nyu", PARAS,
                               (640, 480), (S, S))
        v = _t(sc["verts"]).to(dtype).requires_grad_(True)
        img, _ = TR.get_depth(r, v, *[_t(a).to(dtype) for a in args])
        img.sum().backward()
        return _np(img), v.grad.double().numpy()

    img, g = port(torch.float32)
    _, g64 = port(torch.float64)
    g_ref = jax_renders["get_depth_grad"]
    np.testing.assert_array_equal(img < 0.99,
                                  jax_renders["get_depth"][0] < 0.99)
    assert (np.abs(g_ref).sum(-1) > 0).mean() > 0.2
    tol = 1e-3 * np.abs(g64).max()
    for a, b in ((g, g_ref), (g, g64), (g_ref, g64)):
        assert (np.abs(a - b) > tol).mean() <= 0.01
        assert np.linalg.norm(a - b) <= 0.1 * np.linalg.norm(b)


def test_synth2real_and_patch_gaussian_match_jax(jax_renders):
    """The noise draws jax.random took, handed over, on normal_render's
    image: synth2real to 1e-6 (a 5x5 float32 convolution of values of
    order 1, the port's own float64 result within 1e-6 too) and without
    the blur, like patch_gaussian, bitwise."""
    img = jax_renders["normal_render"][0]
    key = jax.random.PRNGKey(23)
    normal = _t(jax.random.normal(key, (B, 1, S // 2, S // 2)))
    for sigma in (1.7, 0.0):
        ref = np.asarray(jax.jit(lambda k, x: JR.synth2real(
            k, x, sigma=sigma))(key, img) if sigma else
            JR.synth2real(key, jnp.asarray(img), sigma=sigma))
        got = TR.synth2real(normal, _t(img), sigma=sigma).numpy()
        if sigma:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
            g64 = TR.synth2real(normal.double(), _t(img).double(),
                                sigma=sigma).numpy()
            np.testing.assert_allclose(got, g64, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, ref)
            assert (got != img).mean() > 0.02
    ref = np.asarray(JR.patch_gaussian(key, jnp.asarray(img)))
    uni = _t(jax.random.uniform(key, (B, 1, S // 8, S // 8)))
    got = TR.patch_gaussian(uni, _t(img)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != img).mean() > 0.02


def test_draws_have_jax_shapes_and_supports():
    gen = torch.Generator().manual_seed(0)
    n = TR.draw_synth2real(gen, (3, 1, 64, 64))
    assert n.shape == (3, 1, 32, 32) and abs(float(n.mean())) < 0.1
    u = TR.draw_patch_gaussian(gen, (3, 1, 64, 64))
    assert u.shape == (3, 1, 8, 8) and 0 <= float(u.min()) < float(u.max()) < 1


def test_mass_center_matches_jax(scene):
    """To 1e-6 relative (means of float32 products in another order); an
    image with no pixel above 0 gives NaN on both sides."""
    rng = np.random.RandomState(24)
    img = rng.uniform(-1, 1, (3, 1, 24, 32)).astype(np.float32)
    img[2] = -1.0
    got = TR.mass_center(_t(img)).numpy()
    ref = np.asarray(jax.jit(JR.mass_center)(img))
    assert np.isnan(got[2]).all() and np.isnan(ref[2]).all()
    np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-6)


@pytest.fixture(scope="module")
def hand(scene):
    """The normalized hand of the sphere and ICP tests: the MANO joints
    and mesh of the normalized parameters, the pixel branch's joints
    moved a little, a cloud near the mesh, and its part labels of the
    three kinds (from the JAX package)."""
    tm, jm, rng = scene["tm"], scene["jm"], scene["rng"]
    joints, mesh = TR.get_mesh_xyz(scene["tr"], _t(scene["norm"]))
    joints, mesh = _np(joints), _np(mesh)
    jxyz = (joints + rng.randn(B, 21, 3) * 0.02).astype(np.float32)
    idx = rng.randint(0, 778, (B, P))
    pcl = (np.take_along_axis(mesh, idx[..., None], 1)
           + rng.randn(B, P, 3) * 0.02).astype(np.float32)
    segs = {n: np.asarray(jax.jit(lambda *a: f(jm, *a))(jxyz, joints, mesh,
                                                        pcl))
            for n, f in (("15", JSP.seg_pcl), ("21", JSP.seg_pcl_21),
                         ("finger", JSP.seg_pcl_finger))}
    return dict(joints=joints, mesh=mesh, jxyz=jxyz, pcl=pcl, segs=segs,
                w=rng.rand(B, 20).astype(np.float32))


def test_sphere_part_labels_match_jax(scene, hand):
    """seg_pcl_21 and seg_pcl_finger: every point's label equal (the
    argmins take the first minimum on both sides)."""
    args = [_t(hand[k]) for k in ("jxyz", "joints", "mesh", "pcl")]
    for name, f in (("21", TSP.seg_pcl_21), ("finger", TSP.seg_pcl_finger)):
        got = f(scene["tm"], *args).numpy()
        np.testing.assert_array_equal(got, hand["segs"][name])
        assert len(np.unique(got)) >= 5 and (got == 0).any()


SPHERE_DISTANCES = (("point2mesh_part_distance", "15"),
                    ("point2sphere_distance", "15"),
                    ("point2sphere_distance_21", "21"),
                    ("point2sphere_distance_finger", "finger"))


@pytest.mark.parametrize("name,seg", SPHERE_DISTANCES)
def test_sphere_part_distances_match_jax(scene, hand, name, seg):
    """Each part distance and its gradient in the cloud, the mesh and (for
    the sphere ones) the joints, against jax.grad: values to 1e-5
    relative, gradients to 1e-5 of their largest entry (float32 sums and
    means in other orders; point2mesh_part_distance keeps the reference's
    0-based parts and its 1e5 for a point of another part)."""
    sc = scene
    pcl_seg = hand["segs"][seg]
    tf, jf = getattr(TSP, name), getattr(JSP, name)
    mesh_only = name == "point2mesh_part_distance"
    ins = [hand["mesh"], hand["pcl"]] if mesh_only else \
        [hand["joints"], hand["mesh"], hand["pcl"]]
    w = hand["w"]

    def jloss(*a):
        d = jf(sc["jm"], *a, jnp.asarray(pcl_seg))
        return jnp.sum(d * w[:, :d.shape[1]]), d

    (_, d_ref), g_ref = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(ins))), has_aux=True))(*ins)
    leaves = [_t(x).requires_grad_(True) for x in ins]
    d = tf(sc["tm"], *leaves, _t(pcl_seg))
    (d * _t(w)[:, :d.shape[1]]).sum().backward()
    d_ref = np.asarray(d_ref)
    assert (d_ref > 0).mean() > 0.3
    np.testing.assert_allclose(_np(d), d_ref, rtol=1e-5, atol=1e-12)
    for x, g in zip(leaves, g_ref):
        g = np.asarray(g)
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())


ICP_LOSSES = ("icp_loss", "joint_icp_loss", "finger_icp_loss")


def _icp_inputs(scene, hand):
    tm = scene["tm"]
    return ([hand["mesh"], hand["pcl"]], tm.faces.numpy(),
            {"joint_icp_loss": (tm.joint_face_mask.numpy(),
                                hand["segs"]["15"]),
             "finger_icp_loss": (tm.finger_face_mask.numpy(),
                                 hand["segs"]["finger"])})


def _icp_total(mod, losses, mesh, pcl, faces, tables, w, asarray):
    """Each loss and the weighted sum of all three (the gradient's
    objective)."""
    vals = [mod.icp_loss(mesh, pcl, asarray(faces))]
    for name in ICP_LOSSES[1:]:
        table, seg = tables[name]
        vals.append(getattr(mod, name)(mesh, pcl, asarray(faces),
                                       asarray(table), asarray(seg)))
    total = sum((v * w[:, :v.shape[1]] if v.ndim == 2 else v * w[:, 0]).sum()
                for v in vals)
    return total, vals


@pytest.fixture(scope="module")
def jax_icp(scene, hand):
    """The three ICP losses and their gradients in the mesh and the cloud,
    JAX's.  On the CPU every switch takes JAX's one XLA argmin (v2 sorts
    the faces by part first, which changes no distance, only which of two
    tied faces wins), so one run serves the three."""
    ins, faces, tables = _icp_inputs(scene, hand)
    (_, vals), grads = jax.jit(jax.value_and_grad(
        lambda m, p: _icp_total(JI, ICP_LOSSES, m, p, faces, tables,
                                hand["w"], np.asarray),
        argnums=(0, 1), has_aux=True))(*ins)
    return [np.asarray(v) for v in vals], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("switch", ["v1", "v2", "culled"])
def test_icp_losses_under_each_switch_match_jax(scene, hand, jax_icp, switch,
                                                monkeypatch):
    """icp_loss (no part table), joint_icp_loss (15 columns) and
    finger_icp_loss (5 columns) through the port's argmin under each
    switch (K3's, K7's and K8's plain versions, which build their tables
    from these), against JAX's (``jax_icp``) and the port in
    float64: each loss to 1e-5 relative; the gradients in the mesh and the
    cloud to 1e-4 of their largest entry against float64, and between the
    port and JAX as test_torch_icp_variants.py holds the fused loss (under
    culled, K8's 16-constant form may round a near-tie the other way and
    send a point's gradient through another face: 2e-3 relative L2, at
    most 1% of the entries beyond 1e-4 of the largest)."""
    monkeypatch.setattr(PM, "USE_V2_KERNEL", switch == "v2")
    monkeypatch.setattr(PM, "USE_CULLED_KERNEL", switch == "culled")
    ins, faces, tables = _icp_inputs(scene, hand)
    w = _t(hand["w"])

    def port(dtype):
        leaves = [_t(x).to(dtype).requires_grad_(True) for x in ins]
        total, vals = _icp_total(TI, ICP_LOSSES, *leaves, faces, tables,
                                 w.to(dtype), _t)
        total.backward()
        return [_np(v) for v in vals], [x.grad.numpy() for x in leaves]

    vals_j, g_j = jax_icp
    vals_p, g_p = port(torch.float32)
    vals_64, g_64 = port(torch.float64)
    assert [v.shape for v in vals_p] == [(B,), (B, 15), (B, 5)]
    assert (vals_j[1] > 0).sum() >= 10 and (vals_j[2] > 0).sum() >= 6
    for vp, vj, v64 in zip(vals_p, vals_j, vals_64):
        np.testing.assert_allclose(vp, vj, rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(vj, v64, rtol=1e-5, atol=1e-12)

    def close(a, b, tol):
        if switch != "culled":
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)
            return
        assert np.linalg.norm(a - b) <= 2e-3 * np.linalg.norm(b)
        assert (np.abs(a - b) > tol).mean() <= 0.01

    for gp, gj, g64 in zip(g_p, g_j, g_64):
        tol = 1e-4 * np.abs(g64).max()
        np.testing.assert_allclose(gp, g64, rtol=0, atol=tol)
        close(gp, gj, tol)
        close(gj, g64, tol)
