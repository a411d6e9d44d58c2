"""Port parity for the FinetuneStage step's real-image machinery against
dsf_tpu: the sphere radii and collision loss (values and gradients), the
point-cloud part segmentation, crop_hand and the uvd->xyz image, the
fixed-N cloud with JAX's own scores, the fused ICP losses (values and
gradients) on the synthetic MANO hand, and the part tables they read."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dsf_tpu.losses import icp as JI
from dsf_tpu.mano import model as JM, spheres as JSP, synthetic as JS
from dsf_tpu.ops import cloud as JC
from dsf_tpu_torch import demo
from dsf_tpu_torch.losses import icp as TI
from dsf_tpu_torch.mano import model as TM, spheres as TSP
from dsf_tpu_torch.ops import cloud as TC
from dsf_tpu_torch.render import renderer as TR

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S, B = 64, 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Two rendered hands (the port's demo.real_batch) with their MANO
    joints and mesh in normalized units, and both packages' models."""
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    tm = TM.load_model(path, device="cpu")
    r = TR.Renderer.create(tm, "nyu", PARAS, (640, 480), (S, S))
    rng = np.random.RandomState(0)
    para, center, cube = demo.posed_params(r, B, rng)
    real = demo.real_batch(r, B, np.random.RandomState(0))
    joints, mesh = TR.get_mesh_xyz(r, para)
    # the pixel branch's joints: the MANO joints moved a little
    jxyz = joints + torch.from_numpy(rng.randn(B, 21, 3).astype(np.float32) * 0.02)
    return dict(tm=tm, jm=JM.load_model(path), r=r, real=real, joints=joints,
                mesh=mesh, jxyz=jxyz, rng=rng)


def test_part_tables_match_jax(scene):
    assert np.array_equal(scene["tm"].joint_face_mask.numpy(),
                          np.asarray(scene["jm"].joint_face_mask))
    assert np.array_equal(scene["tm"].vertex_joint_mask.numpy(),
                          np.asarray(scene["jm"].vertex_joint_mask))
    assert np.array_equal(TSP.COLLISION_MASK, JSP.COLLISION_MASK)


def test_sphere_radii_and_collision_match_jax(scene):
    """Radii and the per-sample collision loss to 1e-6 relative, and the
    collision loss's gradient in the joints to 1e-5 of its largest entry
    (float32 sums in other orders).  The mesh passes detached, as the step
    passes it."""
    joints, mesh = scene["joints"], scene["mesh"]
    r_t = TSP.sphere_radii(scene["tm"], joints, mesh)
    r_j = JSP.sphere_radii(scene["jm"], _j(joints), _j(mesh))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-6)
    # joints pulled together a little: more sphere pairs overlap
    j = joints * 0.9
    jt = j.clone().requires_grad_(True)
    coll_t = TSP.collision_loss(scene["tm"], jt, mesh)
    coll_t.sum().backward()

    def f(jj):
        c = JSP.collision_loss(scene["jm"], jj, _j(mesh), keep_batch=True)
        return c.sum(), c

    (_, coll_j), g_j = jax.value_and_grad(f, has_aux=True)(_j(j))
    assert (np.asarray(coll_j) > 0).all()
    np.testing.assert_allclose(coll_t.detach().numpy(), np.asarray(coll_j),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(coll_t.mean()),
        float(JSP.collision_loss(scene["jm"], _j(j), _j(mesh))), rtol=1e-6)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(jt.grad.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())


def test_seg_pcl_matches_jax(scene):
    """Every point's part label equal (the argmins pick the first
    minimum on both sides)."""
    rng = scene["rng"]
    idx = rng.randint(0, 778, (B, 3000))
    pcl = (np.take_along_axis(scene["mesh"].numpy(), idx[..., None], 1)
           + rng.randn(B, 3000, 3) * 0.02).astype(np.float32)
    seg_t = TSP.seg_pcl(scene["tm"], scene["jxyz"], scene["joints"],
                        scene["mesh"], _t(pcl))
    seg_j = JSP.seg_pcl(scene["jm"], _j(scene["jxyz"]), _j(scene["joints"]),
                        _j(scene["mesh"]), jnp.asarray(pcl))
    assert len(np.unique(seg_t.numpy())) >= 10
    assert np.array_equal(seg_t.numpy(), np.asarray(seg_j))


def test_crop_hand_and_xyz_image_match_jax(scene):
    """The crop and the uvd->xyz image (mm and normalized) to 1e-5
    relative; crop_hand with the joints pulled in, so that it cuts some of
    the hand, equal but for pixels within rounding of its box."""
    real = scene["real"]
    img, center, M, cube = real["img"], real["center"], real["M"], real["cube"]
    xyz_t, nl_t = TC.uvd_img_to_xyz_img(img, center, M, cube, PARAS, S)
    xyz_j, nl_j = JC.uvd_img_to_xyz_img(_j(img), _j(center), _j(M), _j(cube),
                                        PARAS, S)
    np.testing.assert_allclose(xyz_t.numpy(), np.asarray(xyz_j), rtol=1e-5)
    np.testing.assert_allclose(nl_t.numpy(), np.asarray(nl_j), rtol=1e-5,
                               atol=1e-6)
    joints = scene["joints"] * 0.7
    crop_t = TC.crop_hand(img, joints, center, M, cube, PARAS, S).numpy()
    crop_j = np.asarray(JC.crop_hand(_j(img), _j(joints), _j(center), _j(M),
                                     _j(cube), PARAS, S))
    cut = (img.numpy() < 0.99) & (crop_j >= 1.0)
    assert cut.sum() > 10 and (crop_j < 0.99).sum() > 100
    assert (crop_t != crop_j).sum() <= 2


@pytest.mark.parametrize("regime", ["wrap", "truncate", "empty"])
def test_img_to_pcl_matches_jax_with_its_scores(scene, regime):
    """The fixed-N cloud from JAX's own uniform scores: with fewer
    foreground pixels than points (each is repeated in score order), with
    more (the top-scored are kept), and for an empty image (zeros).  The
    rows to 1e-6 relative of the same pixels' coordinates."""
    real = scene["real"]
    img = real["img"].clone()
    fg = int((img < 0.99).sum(dim=(1, 2, 3)).min())
    n = {"wrap": 4 * fg, "truncate": fg // 3, "empty": 64}[regime]
    if regime == "empty":
        img[0] = 1.0
    key = jax.random.PRNGKey(7)
    score = jax.random.uniform(key, (B, S * S))
    args = (real["center"], real["M"], real["cube"])
    got = TC.img_to_pcl(_t(score), img, *args, PARAS, S, n, S).numpy()
    ref = np.asarray(JC.img_to_pcl(key, _j(img), *map(_j, args), PARAS, S,
                                   n, S))
    assert got.shape == (B, n, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    if regime == "empty":
        assert (got[0] == 0).all() and np.abs(got[1]).sum() > 0


def test_icp_and_joint_icp_match_jax(scene):
    """d2m and the per-part pd2m to 1e-5 relative, and their gradients in
    the mesh (through the winning faces) to 1e-5 of the largest entry, on
    a cloud near the hand with part labels from seg_pcl (palm points,
    label 0, admit no face)."""
    rng = np.random.RandomState(3)
    mesh = scene["mesh"]
    P = 400
    idx = rng.randint(0, 778, (B, P))
    pcl = (np.take_along_axis(mesh.numpy(), idx[..., None], 1)
           + rng.randn(B, P, 3) * 0.02).astype(np.float32)
    joint_pcl = (np.take_along_axis(mesh.numpy(), idx[..., None], 1)
                 + rng.randn(B, P, 3) * 0.01).astype(np.float32)
    seg = TSP.seg_pcl(scene["tm"], scene["jxyz"], scene["joints"], mesh,
                      _t(joint_pcl))
    assert (seg == 0).any() and len(np.unique(seg.numpy())) >= 10
    w = rng.rand(B, 15).astype(np.float32)
    faces, jmask = scene["tm"].faces, scene["tm"].joint_face_mask

    m = mesh.clone().requires_grad_(True)
    d2m, pd2m = TI.icp_and_joint_icp(m, _t(pcl), _t(joint_pcl), faces, jmask,
                                     seg)
    (d2m.sum() + (pd2m * _t(w)).sum()).backward()

    def f(mm):
        a, b = JI.icp_and_joint_icp(mm, jnp.asarray(pcl),
                                    jnp.asarray(joint_pcl),
                                    scene["jm"].faces,
                                    scene["jm"].joint_face_mask, _j(seg))
        return a.sum() + (b * w).sum(), (a, b)

    (_, (d2m_j, pd2m_j)), g_j = jax.value_and_grad(f, has_aux=True)(_j(mesh))
    np.testing.assert_allclose(d2m.detach().numpy(), np.asarray(d2m_j),
                               rtol=1e-5)
    np.testing.assert_allclose(pd2m.detach().numpy(), np.asarray(pd2m_j),
                               rtol=1e-5, atol=1e-12)
    assert (np.asarray(pd2m_j) > 0).sum() >= 10
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(m.grad.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())
