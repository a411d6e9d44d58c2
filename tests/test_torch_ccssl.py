"""Port parity for the CCSSL pipeline (dsf_tpu_torch.tools.ccssl,
training.ccssl_trainer, the CCSSL step, pipelines.run_ccssl, the NYU
dataset variants, tools.ccssl_support) against the JAX package on the
CPU, from the same weights, files and random draws.

The one intended difference is the frame of the pseudo labels: the JAX
package's ``generate_pseudo_labels`` writes the crop frame's normalized
joints into ``joint_uvd.txt``, which its ``NYUCCSSLDataset`` reads as
image pixels and mm; the port writes the image frame, which both
packages' datasets read back as ``NYUDataset``'s own labels
(``test_label_frame_*``).

Shapes: the JAX package's fake NYU set (8 train, 4 test frames), 64^2
crops; one JAX compile of the labelling pass (B=4) and one of the CCSSL
step (B=2, two stages).
"""

import os
from types import SimpleNamespace

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dsf_tpu.config import Config as JConfig
from dsf_tpu.data import aug_batch as JA
from dsf_tpu.data import datasets as JD
from dsf_tpu.data.fake import make_fake_nyu
from dsf_tpu.losses import basic as JB
from dsf_tpu.mano import synthetic as JS
from dsf_tpu.models import torch_import as TI
from dsf_tpu.ops import image as JI
from dsf_tpu.tools import ccssl as JC
from dsf_tpu.tools import ccssl_support as JSup
from dsf_tpu.training import ccssl_trainer as JCC
from dsf_tpu.training.trainer import Trainer as JTrainer
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.data import datasets as TD
from dsf_tpu_torch.losses import basic as TB
from dsf_tpu_torch.models.weights import (random_reference_state_dict,
                                          state_dict_from_jax)
from dsf_tpu_torch.ops import image as TImg
from dsf_tpu_torch.tools import ccssl as TC
from dsf_tpu_torch.tools import ccssl_support as TSup
from dsf_tpu_torch.training import ccssl_trainer as TCC
from dsf_tpu_torch.training import pipelines as TPipe
from dsf_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)

S, N_TRAIN, N_TEST, J_NET = 64, 8, 4, 21
KEYS = ("img", "xyz_gt", "uvd_gt", "center", "M", "cube")


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    d = tmp_path_factory.mktemp("ccssl")
    mano = JS.save_synthetic_mano(str(d / "mano.npz"))
    make_fake_nyu(str(d / "data"), mano, n_train=N_TRAIN, n_test=N_TEST)
    return SimpleNamespace(dir=d, root=str(d / "data" / "nyu"),
                           data=str(d / "data"), mano=mano)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _gt_labels(fake, out_dir, phase="train", rng=None):
    """The port's labels of ``phase`` written from NYUDataset's own
    unaugmented crop-frame ground truth through ``crop_to_image``
    (the round trip of ``generate_pseudo_labels``' writer), with random
    weights; returns that batch of every frame."""
    ds = TD.NYUDataset(fake.root, phase, img_size=S)
    ds.augment = False
    b = ds._fetch_batch(np.arange(len(ds)))
    ds.close()
    w = (np.ones(b["uvd_gt"].shape[:2]) if rng is None
         else rng.uniform(0.2, 1.0, b["uvd_gt"].shape[:2]))
    TCC.write_labels(out_dir, TCC.crop_to_image(
        b["uvd_gt"], b["M"], b["center"], b["cube"], S), w)
    return b


# ------------------------------------------------------------ the ops

def test_weighted_smooth_l1_and_gradient():
    """The loss to 1e-6 relative and its gradient in x to 1e-6 relative
    L2, on residuals on both sides of the 0.01 split and weights in
    (0, 1)."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 21, 3).astype(np.float32) * 0.02
    y = rng.randn(4, 21, 3).astype(np.float32) * 0.02
    w = rng.uniform(0, 1, (4, 21)).astype(np.float32)
    jl, jg = jax.value_and_grad(JB.weighted_smooth_l1)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    tl = TB.weighted_smooth_l1(xt, torch.from_numpy(y), torch.from_numpy(w))
    tl.backward()
    small = np.abs(x - y) < 0.01
    assert 0.2 < small.mean() < 0.8
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert _rel(xt.grad.numpy(), np.asarray(jg)) <= 1e-6


def _theta(rng, B):
    s = rng.uniform(0.75, 1.25, B)
    rot = rng.uniform(-3, 3, B)
    th = np.zeros((B, 2, 3), np.float32)
    th[:, 0, 0], th[:, 0, 1] = s * np.cos(rot), -np.sin(rot)
    th[:, 1, 0], th[:, 1, 1] = np.sin(rot), s * np.cos(rot)
    th[:, :, 2] = rng.uniform(-0.1, 0.1, (B, 2))
    return th


def _ties(grid, H, W, eps=1e-4):
    """Output pixels whose unnormalized x or y lies within ``eps`` px of
    a .5: where a nearest sample may round either way."""
    x = TImg.unnormalize(grid[..., 0], W).double()
    y = TImg.unnormalize(grid[..., 1], H).double()
    near = lambda c: (c - torch.floor(c) - 0.5).abs() < eps
    return (near(x) | near(y)).numpy()


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_grid_sample_and_affine_warp_match_jax(mode):
    """``grid_sample`` on one grid (with exact .5 ties in it): nearest
    bitwise (both round half to even), bilinear within 1e-6.
    ``affine_warp``, whose grid each side computes: nearest bitwise but
    at counted ties (pixels whose coordinate lies within 1e-4 px of a
    .5, where the two grids' last bits decide), bilinear within 2e-5
    (the grids' rounding times the image's slope)."""
    rng = np.random.RandomState(1)
    B, C, H, W = 4, 3, 24, 32
    img = rng.randn(B, C, H, W).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (B, 10, 12, 2)).astype(np.float32)
    grid[:, 0, :, 0] = (2 * rng.randint(0, W, (B, 12)) + 2) / W - 1  # x = k+.5
    a = np.asarray(JI.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode))
    b = TImg.grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                         mode).numpy()
    if mode == "nearest":
        assert np.array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    th = _theta(rng, B)
    a = np.asarray(JI.affine_warp(jnp.asarray(img), jnp.asarray(th), mode))
    b = TImg.affine_warp(torch.from_numpy(img), torch.from_numpy(th),
                         mode).numpy()
    if mode == "nearest":
        ties = _ties(TImg.affine_grid(torch.from_numpy(th), H, W), H, W)
        diff = (a != b).any(1)
        print(f"affine_warp nearest: {int(diff.sum())} pixels differ, all at "
              f"ties; {int(ties.sum())} tie pixels of {ties.size}")
        assert not (diff & ~ties).any()
    else:
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-5)


def _narrow_net(J=4, seed=2):
    """One forward on both sides: a 3x3 stride-2 conv 1 -> 4J with
    carried numpy weights (the narrow net of the TTA tests)."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(4 * J, 1, 3, 3) * 0.5).astype(np.float32)
    bias = (rng.randn(4 * J) * 0.1).astype(np.float32)
    seen = {"jax": [], "port": []}

    def jax_fwd(x):
        seen["jax"].append(np.asarray(x))
        y = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (2, 2), ((1, 1), (1, 1)),
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=jax.lax.Precision.HIGHEST)
        return y + jnp.asarray(bias)[None, :, None, None]

    def port_fwd(x):
        seen["port"].append(x.numpy().copy())
        return torch.nn.functional.conv2d(x, torch.from_numpy(w),
                                          torch.from_numpy(bias), 2, 1)
    return jax_fwd, port_fwd, seen


def _crops(fake, n=4):
    ds = JD.NYUDataset(fake.root, "test", img_size=S)
    return next(ds.batches(n, drop_last=False))["img"]


def test_prediction_check_matches_jax(fake):
    """The score-map TTA (5 passes, JAX's draws) with the narrow net on
    both sides: each pass's warped input bitwise but at counted ties
    (theta from the same draws; cos / sin may differ in the last bit),
    joints within 1e-5 and confidences within 1e-6."""
    img = _crops(fake)
    draws = JC.ref_tta_draws(jax.random.PRNGKey(3), len(img), 5)
    jax_fwd, port_fwd, seen = _narrow_net()
    jj, jc = JC.prediction_check(None, jax_fwd, jnp.asarray(img), n_aug=5,
                                 draws=draws)
    tj, tc = TC.prediction_check(port_fwd, torch.from_numpy(img),
                                 tuple(torch.from_numpy(np.asarray(d))
                                       for d in draws))
    s, rot = (torch.from_numpy(np.asarray(d)) for d in draws)
    differ = 0
    for i, (a, b) in enumerate(zip(seen["jax"], seen["port"])):
        theta, _ = TC._ref_theta(s[i], rot[i])
        ties = _ties(TImg.affine_grid(theta, S, S), S, S)
        diff = (a != b)[:, 0]
        assert not (diff & ~ties).any(), i
        differ += int(diff.sum())
    print(f"prediction_check: {differ} warped pixels differ, all at ties")
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    assert tj.shape == (len(img), 4, 3) and tc.shape == (len(img), 4)


def test_prediction_check_joints_matches_jax_cv2(fake):
    """The host-side TTA against JAX's cv2 path, same draws (degrees
    here): every warped input bitwise (the host library's warpAffine is
    OpenCV's), joints within 1e-5, confidences within 1e-6."""
    img = _crops(fake)
    rng = np.random.RandomState(4)
    s = np.clip(rng.randn(5, len(img)) * 0.25 + 1.0, 0.75, 1.25)
    rot = np.clip(rng.randn(5, len(img)) * 30.0, -60.0, 60.0)
    s[0], rot[0] = 1.0, 0.0
    jax_fwd, port_fwd, seen = _narrow_net()
    jj, jc = JC.prediction_check_joints(None, jax_fwd, img, n_aug=5,
                                        draws=(s, rot))
    tj, tc = TC.prediction_check_joints(port_fwd, img, (s, rot))
    assert len(seen["jax"]) == len(seen["port"]) == 5
    for a, b in zip(seen["jax"], seen["port"]):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(tj, jj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
    assert cv2.__version__


def test_ref_crop_affine_and_refine_centers_match_jax(fake, tmp_path):
    """``ref_crop_affine`` bitwise over scales and angles; the exported
    refined centres bitwise and their files equal."""
    for sc, rot in ((1.0, 0.0), (0.8, 37.5), (1.2, -59.0)):
        assert np.array_equal(TC.ref_crop_affine((64, 48), sc, rot, 128),
                              JC.ref_crop_affine((64, 48), sc, rot, 128))
    ds = SimpleNamespace(paras=(588.03, 587.07, 320.0, 240.0),
                         center_xyz=JD.NYUDataset(fake.root, "test",
                                                  img_size=S).center_xyz)
    a = JC.export_refine_centers(ds, str(tmp_path / "j.txt"))
    b = TC.export_refine_centers(ds, str(tmp_path / "t.txt"))
    assert np.array_equal(a, b)
    assert (open(tmp_path / "j.txt").read()
            == open(tmp_path / "t.txt").read())


# ------------------------------------------------------- the datasets

def test_label_frame_fault_and_repair(fake, tmp_path):
    """The JAX package's fault: its ``NYUCCSSLDataset`` given crop-frame
    joints, as its ``generate_pseudo_labels`` writes them, puts every
    ``uvd_gt`` outside the crop.  The repair: the port's image-frame
    labels (``crop_to_image`` of NYUDataset's own ground truth, written by
    ``write_labels``) read back by both packages' datasets give
    NYUDataset's ``uvd_gt`` within float32 rounding of the %.5f file."""
    ref = _gt_labels(fake, str(tmp_path / "img"), "test")
    crop_dir = tmp_path / "crop"
    crop_dir.mkdir()
    np.savetxt(crop_dir / "joint_uvd.txt",
               ref["uvd_gt"].reshape(len(ref["uvd_gt"]), -1), fmt="%.5f")
    jbad = JD.NYUCCSSLDataset(fake.root, "test", str(crop_dir), img_size=S)
    jbad.augment = False
    bad = jbad._fetch_batch(np.arange(N_TEST))["uvd_gt"]
    print(f"JAX's dataset on crop-frame labels: uvd_gt in "
          f"[{bad.min():.3f}, {bad.max():.3f}]; NYUDataset's in "
          f"[{ref['uvd_gt'].min():.3f}, {ref['uvd_gt'].max():.3f}]")
    assert (np.abs(bad).max(-1) > 1.5).all()
    assert np.abs(ref["uvd_gt"]).max() < 1.0
    for ds in (JD.NYUCCSSLDataset(fake.root, "test", str(tmp_path / "img"),
                                  img_size=S),
               TD.NYUCCSSLDataset(fake.root, "test", str(tmp_path / "img"),
                                  img_size=S)):
        ds.augment = False
        got = ds._fetch_batch(np.arange(N_TEST))
        np.testing.assert_allclose(got["uvd_gt"], ref["uvd_gt"], rtol=0,
                                   atol=2e-6)
        np.testing.assert_allclose(got["xyz_gt"], ref["xyz_gt"], rtol=0,
                                   atol=2e-5)


def _jax_fast(jds, idx, draws=None):
    """The JAX package's batched path for ``jds``' frames ``idx`` (its
    ``_eval_fast_batch``, or ``augment_fast_batch`` with ``draws``)."""
    depths = np.stack([jds._read_depth(i) for i in idx])
    cubes = (jds.test_cubesize[idx] if jds.phase == "test"
             else np.tile(jds.cube_size, (len(idx), 1))).astype(np.float32)
    if draws is None:
        return jds._eval_fast_batch(idx, depths, jds.all_joints_xyz,
                                    jds.center_xyz[idx], cubes)
    return JA.augment_fast_batch(depths, jds.all_joints_xyz[idx],
                                 jds.center_xyz[idx],
                                 cubes.astype(np.float64), jds.paras,
                                 jds.flip, jds.img_size, draws)


def _equal(got, ref, keys):
    for k in keys:
        assert got[k].dtype == ref[k].dtype, k
        assert np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("augment", [False, True])
def test_ccssl_batches_match_jax(fake, tmp_path, augment):
    """``NYUCCSSLDataset`` on image-frame labels (21 joints, as the net
    writes them: the 14 ground-truth joints and 7 more), shuffled batches
    of 4: every key bitwise the JAX package's batched path on its own
    dataset (unaugmented: its ``_eval_fast_batch``; augmented: its
    ``augment_fast_batch`` with the port's draws, the dataset's
    RandomState), and ``weight`` its rows of weight.txt.  JAX's item
    path (which its subclass takes) within its own fast path's 2e-4."""
    rng = np.random.RandomState(5)
    uvd = np.concatenate([JD.NYUDataset(fake.root, "train").all_joints_uvd,
                          np.tile([[[320.0, 240.0, 700.0]]], (N_TRAIN, 7, 1))
                          + rng.randn(N_TRAIN, 7, 3) * 20], 1)
    w = rng.uniform(0, 1, (N_TRAIN, J_NET))
    np.savetxt(tmp_path / "joint_uvd.txt", uvd.reshape(N_TRAIN, -1),
               fmt="%.5f")
    np.savetxt(tmp_path / "weight.txt", w, fmt="%.5f")
    tds = TD.NYUCCSSLDataset(fake.root, "train", str(tmp_path), img_size=S,
                             seed=9)
    jds = JD.NYUCCSSLDataset(fake.root, "train", str(tmp_path), img_size=S,
                             seed=9)
    tds.augment = jds.augment = augment
    draws_rng = np.random.RandomState(9)
    order = np.random.RandomState(3).permutation(N_TRAIN)
    batches = list(tds.batches(4, shuffle=True, seed=3))
    tds.close()
    for k, got in enumerate(batches):
        idx = order[4 * k:4 * k + 4]
        draws = (JA.draw_params(draws_rng, 4, jds.aug_para) if augment
                 else None)
        ref = _jax_fast(jds, idx, draws)
        _equal(got, ref, KEYS)
        assert np.array_equal(got["weight"],
                              jds.weights[idx]) and got["xyz_gt"].shape[1] == 21
        if not augment:
            item = JD.BaseDataset._fetch_batch(jds, idx)
            for key in KEYS:
                np.testing.assert_allclose(got[key], item[key], rtol=0,
                                           atol=2e-4, err_msg=key)
            assert np.array_equal(got["weight"], item["weight"])


def test_st_modelpara_concat_testaug_match_jax(fake):
    """``NYUSTDataset`` (test split, unaugmented): its batch bitwise
    NYUDataset's fast path with ``model_para`` the JAX dataset's rows,
    and within 2e-4 of JAX's item path, which it takes;
    ``ModelParaOnlyDataset`` bitwise; ``ConcatDataset`` of the train and
    test splits bitwise each member's batch of its rows, in the batch's
    order; ``NYUTestAugDataset`` (augmented, train cubes) bitwise JAX's
    from the same seed, and its cubes the train split's."""
    jst, tst = (M.NYUSTDataset(fake.root, "test", img_size=S)
                for M in (JD, TD))
    idx = np.arange(N_TEST)
    got = tst._fetch_batch(idx)
    _equal(got, _jax_fast(JD.NYUDataset(fake.root, "test", img_size=S), idx),
           KEYS)
    item = JD.BaseDataset._fetch_batch(jst, idx)
    for k in KEYS:
        np.testing.assert_allclose(got[k], item[k], rtol=0, atol=2e-4)
    assert np.array_equal(got["model_para"], item["model_para"])
    assert got["model_para"].dtype == np.float32
    assert np.array_equal(tst.mask, jst.mask)
    for phase in ("train", "test"):
        a, b = (M.ModelParaOnlyDataset(fake.root, "nyu", phase)
                for M in (JD, TD))
        assert len(a) == len(b) and np.array_equal(a.params, b.params)
        assert all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))

    members = [TD.NYUDataset(fake.root, "test", img_size=S),
               TD.NYUDataset(fake.root, "test", view=1, img_size=S)]
    cat = TD.ConcatDataset(members)
    jcat = JD.ConcatDataset([JD.NYUDataset(fake.root, "test", img_size=S),
                             JD.NYUDataset(fake.root, "test", view=1,
                                           img_size=S)])
    assert len(cat) == len(jcat) == 2 * N_TEST
    idx = np.array([5, 0, 7, 3, 4])
    got = cat._fetch_batch(idx)
    for row, i in enumerate(idx):
        k = int(i >= N_TEST)
        ref = jcat.datasets[k]._fetch_batch(np.array([i - k * N_TEST]))
        _equal({key: v[row:row + 1] for key, v in got.items()}, ref, KEYS)
    cat.close()

    jta, tta = (M.NYUTestAugDataset(fake.root, img_size=S, seed=4)
                for M in (JD, TD))
    assert tta.augment and tta.phase == "test"
    assert np.array_equal(tta.test_cubesize, jta.test_cubesize)
    ref = list(jta.batches(2, shuffle=True, seed=1))
    got = list(tta.batches(2, shuffle=True, seed=1))
    tta.close()
    assert len(got) == len(ref) == N_TEST // 2
    for g, r in zip(got, ref):
        _equal(g, r, KEYS)


# ------------------------------------------------ labels and the step

@pytest.fixture(scope="module")
def trainers(fake):
    """The JAX trainer and the port's (CPU), B=2, 64^2, two stages, from
    the same carried weights."""
    variables = jax.tree_util.tree_map(np.array, TI.convert_mano_ocr_stage(
        random_reference_state_dict(np.random.RandomState(0)), refine=True))
    kw = dict(dataset="nyu", batch_size=2, stage_num=2, input_size=S,
              root_dir=fake.data, mano_model_path=fake.mano)
    jtr = JTrainer(JConfig(**kw), fake.mano, steps_per_epoch=4)
    tr = Trainer(Config(**kw), fake.mano, steps_per_epoch=4, device="cpu")
    return SimpleNamespace(jtr=jtr, tr=tr, variables=variables)


def _jax_state(jtr, variables, tx=None):
    st = jtr.init_state()
    st = st.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                  variables["params"]),
                    batch_stats=jax.tree_util.tree_map(
                        jnp.asarray, variables["batch_stats"]))
    return st if tx is None else st.replace(opt_state=tx.init(st.params))


def test_generate_pseudo_labels_matches_jax(fake, trainers, tmp_path):
    """The labelling pass over the unaugmented train split (B=4, two
    passes: the identity and one augmented, which keeps JAX's compile of
    the unrolled passes short; JAX's draws; the same carried weights):
    the port's crop-frame
    joints within 8e-4 of JAX's (the serving engine's stage-2 bound, 0.1
    mm, in the crop frame of a 250 mm cube; measured 8e-5), its
    confidences within 0.5% (the softmax's logits are 30x the stage-2
    heat channel, whose float32 values the two sides sum in other
    orders; measured 0.17%); its files hold the image frame
    (``crop_to_image`` of those joints: inside the 640x480 frame, depth
    within the crop's cube), JAX's the crop frame."""
    jtr, tr, v = trainers.jtr, trainers.tr, trainers.variables
    jds = JD.NYUDataset(fake.root, "train", img_size=S)
    jds.augment = False
    jj, jc = JCC.generate_pseudo_labels(jtr, _jax_state(jtr, v), jds,
                                        str(tmp_path / "jax"), batch_size=4,
                                        n_aug=2)
    key = [jax.random.PRNGKey(0)]

    def draw(b, n):                    # JAX's stream: one split a batch
        key[0], sub = jax.random.split(key[0])
        return tuple(torch.from_numpy(np.asarray(d))
                     for d in JC.ref_tta_draws(sub, b, n))

    tds = TD.NYUDataset(fake.root, "train", img_size=S)
    tds.augment = False
    img, conf, crop = TCC.generate_pseudo_labels(
        tr, tr.init_state(v), tds, str(tmp_path / "port"), batch_size=4,
        n_aug=2, draw=draw)
    print(f"pseudo labels: crop-frame joints port vs JAX max "
          f"{np.abs(crop - jj).max():.3g}, confidences "
          f"{np.abs(conf - jc).max():.3g}")
    np.testing.assert_allclose(crop, jj, rtol=0, atol=8e-4)
    np.testing.assert_allclose(conf, jc, rtol=5e-3, atol=0)
    b = tds._fetch_batch(np.arange(N_TRAIN))
    tds.close()
    np.testing.assert_allclose(img, TCC.crop_to_image(
        crop, b["M"], b["center"], b["cube"], S), rtol=0, atol=0)
    written = np.loadtxt(tmp_path / "port" / "joint_uvd.txt").reshape(
        N_TRAIN, J_NET, 3)
    np.testing.assert_allclose(written, img, rtol=0, atol=6e-6)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "port" / "weight.txt"),
                               conf, rtol=0, atol=6e-6)
    assert ((written[..., 0] > 0) & (written[..., 0] < 640)
            & (written[..., 1] > 0) & (written[..., 1] < 480)).all()
    assert (np.abs(written[..., 2] - b["center"][:, None, 2])
            <= b["cube"][:, None, 0] / 2).all()
    assert np.abs(np.loadtxt(tmp_path / "jax" / "joint_uvd.txt")).max() <= 1


def _capture_tx():
    """An optax transformation whose state after an update is the
    gradient it was given (and whose update is zero): JAX's
    ``ccssl_step_fn`` itself then returns its gradient."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return optax.GradientTransformation(
        lambda params: zeros(params),
        lambda grads, state, params=None: (zeros(grads), grads))


@pytest.fixture(scope="module")
def step(fake, trainers, tmp_path_factory):
    """One CCSSL step on both sides from the same weights and batch: the
    ground truth's 14 joints as image-frame labels (padded to the net's
    21 inside the step) with random weights, two unaugmented frames."""
    d = tmp_path_factory.mktemp("labels")
    _gt_labels(fake, str(d), rng=np.random.RandomState(6))
    ds = TD.NYUCCSSLDataset(fake.root, "train", str(d), img_size=S)
    ds.augment = False
    batch = ds._fetch_batch(np.array([1, 6]))
    ds.close()
    assert batch["uvd_gt"].shape == (2, 14, 3)
    keys = ("img", "uvd_gt", "center", "cube", "weight")
    jtr, tr, v = trainers.jtr, trainers.tr, trainers.variables
    tx = _capture_tx()
    fake_tr = SimpleNamespace(net=jtr.net, renderer=jtr.renderer,
                              cfg=jtr.cfg, tx=tx)
    jstate, jm = JCC.ccssl_step_fn(fake_tr)(
        _jax_state(jtr, v, tx), {k: jnp.asarray(batch[k]) for k in keys})
    ref_sd = state_dict_from_jax({"params": jstate.opt_state,
                                  "batch_stats": jstate.batch_stats})
    state, m = tr.ccssl_step_fn()(tr.init_state(v), {k: batch[k]
                                                     for k in keys})
    net = state.net
    return dict(loss=(float(m["loss"]), float(jm["loss"])),
                grads={n: (np.zeros(p.shape, np.float32) if p.grad is None
                           else p.grad.numpy(), ref_sd[n].numpy())
                       for n, p in net.named_parameters()},
                stats={n: (b.numpy(), ref_sd[n].numpy(),
                           state_dict_from_jax(v)[n].numpy())
                       for n, b in net.named_buffers() if "running" in n},
                state=state, terms={k: float(x) for k, x in m.items()})


def test_ccssl_step_loss_and_gradients_match_jax(step):
    """The loss within 2e-5 relative; every gradient in relative L2
    within 2e-3 at the head that feeds the loss alone (``finals_s2``)
    and 0.15 behind the BatchNorm trunks, the step tests' tolerances.
    The stage-1 MANO head is reached only through the stage-2 render and
    the stage-2 trunk, so it takes FinetuneStage's rule for it, 2e-3 +
    0.15 x its trunk share, here all of it (measured 0.088); the stage-2
    MANO head, which no term reads, exactly zero on both sides; one
    guarded update applied."""
    (loss, jloss), worst = step["loss"], {}
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(loss, jloss, rtol=2e-5)
    assert set(step["terms"]) == {"loss", "loss_0", "loss_1"}
    for name, (g, r) in step["grads"].items():
        assert np.isfinite(g).all(), name
        if name.startswith("mano_regress_s2"):
            assert not g.any() and not r.any(), name
            continue
        assert np.abs(r).max() > 0, name
        worst[name] = _rel(g, r)
        tol = (2e-3 if name.startswith("finals_s2") else 2e-3 + 0.15
               if name.startswith("mano_regress") else 0.15)
        assert worst[name] <= tol, (name, worst[name])
    head = [v for k, v in worst.items() if k.startswith("finals_s2")]
    print(f"ccssl step: gradients' relative L2, finals_s2 {max(head):.3g}, "
          f"mano_regress {worst['mano_regress.2.weight']:.3g}, median "
          f"elsewhere {np.median(list(worst.values())):.3g}")
    assert int(step["state"].updates) == 1 and step["state"].step == 1


def test_ccssl_step_batch_stats_match_jax(step):
    """The running statistics after the step (one BatchNorm group), to
    5e-5 (stage 1) and 2e-4 (stage 2) of each tensor's largest entry, as
    the other step tests; each moved."""
    for name, (b, r, before) in step["stats"].items():
        assert not np.array_equal(r, before), name
        tol = (2e-4 if "_s2" in name or name.startswith("fusion")
               else 5e-5) * np.abs(r).max()
        np.testing.assert_allclose(b, r, rtol=0, atol=tol, err_msg=name)


def test_run_ccssl_end_to_end(fake, tmp_path):
    """``run_ccssl`` on the CPU (B=4, one epoch): image-frame labels for
    the 8 train frames inside the frame, the epoch's two steps, a
    ``latest`` checkpoint that restores into a fresh trainer bitwise, a
    finite loss; then the labels kept when ``regenerate`` is False."""
    from dsf_tpu_torch.training import checkpoints as ckpt
    cfg = Config(dataset="nyu", batch_size=4, input_size=S, stage_num=2,
                 root_dir=fake.data, mano_model_path=fake.mano,
                 save_dir=str(tmp_path / "ckpt"))
    run_dir, state = TPipe.run_ccssl(cfg, epochs=1, device="cpu")
    assert run_dir == os.path.join(cfg.save_dir, "nyu",
                                   "ccssl_" + cfg.run_name())
    uvd = np.loadtxt(os.path.join(run_dir, "pseudo", "joint_uvd.txt"))
    w = np.loadtxt(os.path.join(run_dir, "pseudo", "weight.txt"))
    assert uvd.shape == (N_TRAIN, J_NET * 3) and w.shape == (N_TRAIN, J_NET)
    uvd = uvd.reshape(N_TRAIN, J_NET, 3)
    assert np.isfinite(uvd).all() and ((w > 0) & (w <= 1)).all()
    assert ((uvd[..., 0] > 0) & (uvd[..., 0] < 640) & (uvd[..., 1] > 0)
            & (uvd[..., 1] < 480) & (uvd[..., 2] > 0)).all()
    assert state.step == N_TRAIN // 4 and int(state.updates) == state.step
    tr = Trainer(cfg, fake.mano, device="cpu")
    restored, epoch = ckpt.restore(run_dir, tr, tr.init_state())
    assert epoch == 1 and restored.step == state.step
    for (n, a), b in zip(state.net.state_dict().items(),
                         restored.net.state_dict().values()):
        assert torch.equal(a, b), n
    ds = TD.NYUCCSSLDataset(fake.root, "train",
                            os.path.join(run_dir, "pseudo"), img_size=S)
    ds.augment = False
    b = ds._fetch_batch(np.arange(N_TRAIN))
    ds.close()
    assert np.abs(b["uvd_gt"]).max() < 1.5
    loss, _ = TCC.ccssl_loss(state.net, tr.renderer, {
        k: torch.from_numpy(b[k][:2]) for k in ("img", "center", "cube",
                                                "uvd_gt", "weight")}, cfg)
    assert torch.isfinite(loss)
    stamp = os.path.getmtime(os.path.join(run_dir, "pseudo", "weight.txt"))
    TPipe.run_ccssl(cfg, epochs=1, regenerate=False, device="cpu")
    assert os.path.getmtime(os.path.join(run_dir, "pseudo",
                                         "weight.txt")) == stamp


def test_ccssl_support_matches_jax(tmp_path):
    """The numpy part of ``ccssl_support`` bitwise: label maps (inside,
    at and beyond the edges, Gaussian and Cauchy), the colour map, the
    crop transforms with and without rotation, the step schedule and
    the files of save_pred / save_checkpoint."""
    import scipy.io
    assert np.array_equal(TSup.gaussian((7, 5), 1.5), JSup.gaussian((7, 5), 1.5))
    for pt in ((10.3, 12.7), (0.5, 30.0), (-5.0, 3.0), (70.0, 70.0)):
        for kind in ("Gaussian", "Cauchy"):
            a, va = JSup.draw_labelmap(np.zeros((32, 40)), pt, 2, kind)
            b, vb = TSup.draw_labelmap(np.zeros((32, 40)), pt, 2, kind)
            assert va == vb and np.array_equal(a, b)
    pts = np.random.RandomState(7).uniform(-4, 36, (6, 2))
    assert np.array_equal(TSup.gaussian_label_map(pts, 32, 1.0),
                          JSup.gaussian_label_map(pts, 32, 1.0))
    x = np.random.RandomState(8).rand(16, 16)
    assert np.array_equal(TSup.color_heatmap(x), JSup.color_heatmap(x))
    assert TSup.gauss(0.3, 1, 0.5, 0.3) == JSup.gauss(0.3, 1, 0.5, 0.3)
    img = np.random.RandomState(9).rand(1, 8, 8).astype(np.float32)
    assert np.array_equal(TSup.color_normalize(img, (0.1, 0.2, 0.3)),
                          JSup.color_normalize(img, (0.1, 0.2, 0.3)))
    for a in (img, img[None]):
        assert np.array_equal(TSup.fliplr(a), JSup.fliplr(a))
    for rot in (0, 30):
        assert np.array_equal(TSup.get_transform((50, 60), 1.3, (64, 64), rot),
                              JSup.get_transform((50, 60), 1.3, (64, 64), rot))
        assert np.array_equal(
            TSup.transform((10, 20), (50, 60), 1.3, (64, 64), 1, rot),
            JSup.transform((10, 20), (50, 60), 1.3, (64, 64), 1, rot))
    assert np.array_equal(TSup.transform_preds(pts, (50, 60), 1.3, (64, 64)),
                          JSup.transform_preds(pts, (50, 60), 1.3, (64, 64)))
    assert (TSup.adjust_learning_rate(0.1, 5, [5, 9])
            == JSup.adjust_learning_rate(0.1, 5, [5, 9]))
    assert (TSup.adjust_learning_rate(0.1, 6, [5, 9])
            == JSup.adjust_learning_rate(0.1, 6, [5, 9]))
    for mod, d in ((TSup, tmp_path / "t"), (JSup, tmp_path / "j")):
        d.mkdir()
        mod.save_pred(pts, str(d))
        mod.save_checkpoint({"epoch": 4, "w": pts}, pts, True, str(d),
                            snapshot=2)
    for name in ("preds_valid.mat", "preds.mat", "preds_best.mat"):
        assert np.array_equal(scipy.io.loadmat(tmp_path / "t" / name)["preds"],
                              scipy.io.loadmat(tmp_path / "j" / name)["preds"])
    assert (sorted(os.listdir(tmp_path / "t"))
            == sorted(os.listdir(tmp_path / "j")))
    for name in ("checkpoint.npz", "checkpoint_4.npz", "model_best.npz"):
        a, b = (np.load(tmp_path / s / name) for s in ("t", "j"))
        assert all(np.array_equal(a[k], b[k]) for k in b)
