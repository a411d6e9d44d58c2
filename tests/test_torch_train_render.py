"""Port parity for the Pretrain step's pieces around the net: the synth
factory (synth_sample + mask_img, with the draws jax.random took), the
view rotation, the stage-2 remap render's gradient (LBS -> raster with
its moment backward -> codec encode VJP), SmoothL1 and the mm error, each
against the JAX package on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dsf_tpu import geometry as JG
from dsf_tpu.losses import basic as JB
from dsf_tpu.mano import model as JM, synthetic as JS
from dsf_tpu.ops import offset_codec as JO
from dsf_tpu.render import renderer as JR
from dsf_tpu.training import phases as JP
from dsf_tpu_torch import geometry as TG
from dsf_tpu_torch.data.synth_params import random_param_source
from dsf_tpu_torch.losses import basic as TB
from dsf_tpu_torch.mano import model as TM
from dsf_tpu_torch.ops import offset_codec as TO
from dsf_tpu_torch.render import renderer as TR
from dsf_tpu_torch.training import phases as TP
from torch_parity import jax_mask_draws, jax_pretrain_draws

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S = 64


@pytest.fixture(scope="module")
def renderers(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    jr = JR.Renderer.create(JM.load_model(path), "nyu", PARAS, (640, 480),
                            (S, S))
    tr = TR.Renderer.create(TM.load_model(path, device="cpu"), "nyu", PARAS,
                            (640, 480), (S, S))
    return jr, tr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synth_sample_matches_jax(renderers, seed):
    """One Pretrain synth batch (B=4) from a key: the JAX factory draws from
    it, the port gets the same values as tensors.

    Labels agree to 1e-5 (the two LBS implementations sum in another
    order, ~1e-6 here), the crop matrices and centres exactly.  The image
    agrees to 1e-3 normalized (0.125 mm) on all but 0.2% of its pixels.
    The raster is discontinuous at silhouettes and occluding edges, and
    the LBS rounding (~6e-5 mm) moves a few pixels across them: measured,
    1 coverage flip in 16384 pixels and up to 2 pixels that change face
    across an occluding finger (0.077 normalized, 9.6 mm).  So coverage and
    the occlusion spheres may differ on at most 1 pixel in 4096, and the
    pixels beyond 1e-3 are counted, not bounded in size."""
    jr, tr = renderers
    B = 4
    key = jax.random.PRNGKey(seed)
    para, cube = next(random_param_source(B, seed=seed))
    draws = jax_pretrain_draws(key, B, jr.depth_range)
    k5 = jax.random.split(key, 6)[4]
    ref = jax.jit(lambda k: JR.synth_sample(
        jr, k, jnp.asarray(para), jnp.asarray(cube),
        augment_view=jnp.zeros((B, 3)), augment_shape=np.asarray(draws.shape),
        augment_center=np.asarray(draws.center),
        augment_size=np.asarray(draws.size), mask=True))(k5)
    got = TR.synth_sample(tr, torch.from_numpy(para), torch.from_numpy(cube),
                          depth_z=draws.depth_z, augment_view=torch.zeros(B, 3),
                          augment_shape=draws.shape, augment_center=draws.center,
                          augment_size=draws.size, mask=draws.mask)
    ref = [np.asarray(x) for x in ref]
    got = [x.numpy() for x in got]
    img_r, img_g = ref[0], got[0]
    assert img_g.shape == (B, 1, S, S)
    assert (img_g < 0.99).mean() > 0.05, "the hand must cover the crop"
    assert (img_g == 1.0).sum() > 0 or draws.mask.n_active == 0
    assert ((img_g < 0.99) != (img_r < 0.99)).mean() <= 1 / 4096
    assert ((img_g == 1.0) != (img_r == 1.0)).mean() <= 1 / 4096
    d = np.abs(img_g - img_r)
    assert (d > 1e-3).mean() <= 2e-3, ((d > 1e-3).sum(), d.max())
    for g, r in zip(got[1:5], ref[1:5]):            # juvd, vuvd, jxyz, vxyz
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)
    for g, r in zip(got[5:], ref[5:]):              # center, cube, M
        np.testing.assert_array_equal(g, r)


def test_mask_img_matches_jax():
    """The occlusion alone on the same image and joints: the same pixels
    are whited out."""
    rng = np.random.RandomState(3)
    B = 3
    img = rng.uniform(-1, 1, (B, 1, S, S)).astype(np.float32)
    joints = rng.uniform(-0.6, 0.6, (B, 21, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(JR.mask_img(key, jnp.asarray(img), jnp.asarray(joints),
                                 0.15, 0.3))
    got = TR.mask_img(torch.from_numpy(img), torch.from_numpy(joints),
                      jax_mask_draws(key, B)).numpy()
    assert (got == 1.0).sum() > 50
    np.testing.assert_array_equal(got, ref)


def test_draw_mask_distributions():
    """The trainer's own draws (torch.Generator) have the JAX package's
    supports: 3 <= n_active < 10, 10 distinct joints, jitter within
    +-0.15, radii in [0, 0.3)."""
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        d = TR.draw_mask(gen, 4, 21)
        assert 3 <= d.n_active < 10
        assert len(set(d.joint_ids.tolist())) == 10
        assert d.joint_ids.max() < 21
        assert d.offs.abs().max() <= 0.15 and d.offs.shape == (4, 10, 3)
        assert 0 <= d.radius.min() and d.radius.max() < 0.3
    dr = TP.draw_pretrain(gen, 4, (500.0, 1200.0))
    assert ((dr.depth_z >= 500) & (dr.depth_z <= 1200)).all()
    assert dr.center.abs().max() <= 20 and (dr.size - 1).abs().max() <= 0.2


def test_random_param_source_matches_jax():
    """The copied parameter source gives the JAX package's batches for the
    same seed, bit for bit (both are numpy)."""
    from dsf_tpu.data.synth_params import random_param_source as jsource
    ours, ref = random_param_source(5, seed=3), jsource(5, seed=3)
    for _ in range(3):
        for g, r in zip(next(ours), next(ref)):
            np.testing.assert_array_equal(g, r)


def test_rotate_points_about_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-100, 100, (2, 30, 3)).astype(np.float32) + [0, 0, 700]
    center = rng.uniform(-20, 20, (2, 3)).astype(np.float32) + [0, 0, 700]
    for rot in (np.zeros((2, 3), np.float32),
                rng.uniform(-3, 3, (2, 3)).astype(np.float32)):
        ref = np.asarray(JG.rotate_points_about(jnp.asarray(pts),
                                                jnp.asarray(center),
                                                jnp.asarray(rot)))
        got = TG.rotate_points_about(torch.from_numpy(pts.astype(np.float32)),
                                     torch.from_numpy(center.astype(np.float32)),
                                     torch.from_numpy(rot)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def _remap(render_params, joint2offset, r, para, center, cube):
    img, juvd, _, _ = render_params(r, para, center, cube, img_stride=2)
    return joint2offset(juvd, img, 0.8, S // 2), img


def test_stage2_remap_gradient_matches_jax(renderers):
    """The stage-2 input as the net builds it from the stage-1 MANO:
    render_params at stride 2 (LBS, the raster and its hard gradient
    through the per-face moments) and the codec encode of the rendered
    joints; d/d mano_para of sum(remap * cot) against jax.grad.  Coverage
    is held equal first.  The gradient agrees to 1e-3 of its largest
    entry: the image gradient reaches the vertices through depth planes
    whose coefficients are differences of ~1e2-pixel coordinates, so the
    vertex rounding of the two LBS implementations (~6e-5 mm) shows at
    ~1e-4 relative (measured)."""
    jr, tr = renderers
    rng = np.random.RandomState(5)
    B = 2
    para = np.zeros((B, 62), np.float32)
    para[:, :48] = rng.randn(B, 48).astype(np.float32) * 0.3
    para[:, 58] = 1.0
    center = rng.uniform([-30, -30, 650], [30, 30, 850], (B, 3)).astype(np.float32)
    cube = np.full((B, 3), 250.0, np.float32)
    cot = rng.randn(B, 84, S // 2, S // 2).astype(np.float32)

    def jloss(p):
        remap, _ = _remap(JR.render_params, JO.joint2offset, jr, p,
                          jnp.asarray(center), jnp.asarray(cube))
        return jnp.sum(remap * cot)

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(para)))
    _, img_ref = _remap(JR.render_params, JO.joint2offset, jr, jnp.asarray(para),
                        jnp.asarray(center), jnp.asarray(cube))
    p = torch.from_numpy(para).requires_grad_(True)
    remap, img = _remap(TR.render_params, TO.joint2offset, tr, p,
                        torch.from_numpy(center), torch.from_numpy(cube))
    np.testing.assert_array_equal(img.detach().numpy() < 1.0,
                                  np.asarray(img_ref) < 1.0)
    assert (img.detach().numpy() < 1.0).mean() > 0.05
    (remap * torch.from_numpy(cot)).sum().backward()
    g = p.grad.numpy()
    np.testing.assert_allclose(g, g_ref, rtol=0,
                               atol=1e-3 * np.abs(g_ref).max())
    # the render's own share: without the moment backward the gradient
    # reaching mano_para through the image would be missing
    p2 = torch.from_numpy(para).requires_grad_(True)
    img2, juvd2, _, _ = TR.render_params(tr, p2, torch.from_numpy(center),
                                         torch.from_numpy(cube), img_stride=2)
    (TO.joint2offset(juvd2, img2.detach(), 0.8, S // 2)
     * torch.from_numpy(cot)).sum().backward()
    assert np.abs(p2.grad.numpy() - g).max() > 1e-2 * np.abs(g).max()


def test_smooth_l1_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 7).astype(np.float32) * 0.02
    y = rng.randn(3, 5, 7).astype(np.float32) * 0.02
    ref, gref = jax.value_and_grad(
        lambda a: JB.smooth_l1(a, jnp.asarray(y)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TB.smooth_l1(xt, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref),
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_xyz2error_mm_matches_jax(seed):
    rng = np.random.RandomState(seed)
    pd = rng.uniform(-1, 1, (3, 21, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (3, 21, 3)).astype(np.float32)
    center = (rng.uniform(-50, 50, (3, 3)) + [0, 0, 700]).astype(np.float32)
    cube = rng.uniform(200, 300, (3, 3)).astype(np.float32)
    ref = np.asarray(JP.xyz2error_mm(*map(jnp.asarray, (pd, gt, center, cube))))
    got = TP.xyz2error_mm(*map(torch.from_numpy, (pd, gt, center, cube)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_mano_gradient_matches_jax(renderers):
    """LBS is differentiable in the MANO parameters (no in-place op breaks
    autograd): d/d para of the joints and mesh get_mesh_xyz returns,
    against jax.grad, to 1e-5 of the gradient's largest entry (float32
    products in another order)."""
    jr, tr = renderers
    rng = np.random.RandomState(6)
    para = (rng.randn(2, 62) * 0.3).astype(np.float32)
    para[:, 58] = 1.0
    gj = rng.randn(2, 21, 3).astype(np.float32)
    gv = rng.randn(2, 779, 3).astype(np.float32)

    def jloss(p):
        j, v = JR.get_mesh_xyz(jr, p)
        return jnp.sum(j * gj) + jnp.sum(v * gv)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(para)))
    p = torch.from_numpy(para).requires_grad_(True)
    j, v = TR.get_mesh_xyz(tr, p)
    ((j * torch.from_numpy(gj)).sum() + (v * torch.from_numpy(gv)).sum()).backward()
    np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
