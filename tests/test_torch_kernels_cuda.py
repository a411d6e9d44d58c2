"""The port's CUDA kernels against their plain PyTorch versions, and its
train-mode BatchNorm against the CPU's, on the card.  Every test here
needs an NVIDIA GPU and skips without one; the file imports no JAX, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(chip_smoke.py makes the same comparisons at the serving and training
shapes.)  The finite-difference checks of the autograd.Functions run on
the CPU, on their plain path, in test_torch_train_kernels.py.
"""

import numpy as np
import pytest
import torch

from dsf_tpu_torch import kernels
from dsf_tpu_torch.mano import model as mano, synthetic
from dsf_tpu_torch.ops import (codec_kernel, moments_kernel, raster_kernel,
                               tapsum, tapsum_kernel)
from dsf_tpu_torch.ops import offset_codec as oc
from dsf_tpu_torch.ops import point_mesh as pm
from dsf_tpu_torch.ops import rasterize as ras
from dsf_tpu_torch.render import renderer as rnd

pytestmark = pytest.mark.cuda

PARAS = (588.03, 587.07, 320.0, 240.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mano_path(cuda, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    synthetic.save_synthetic_mano(path)
    return path


@pytest.fixture(scope="module")
def renderer(cuda, mano_path):
    return rnd.Renderer.create(mano.load_model(mano_path, device=cuda), "nyu",
                               PARAS, (640, 480), (96, 96))


def _scene(renderer, B, seed):
    rng = np.random.RandomState(seed)
    para = np.zeros((B, 62), np.float32)
    para[:, :48] = rng.randn(B, 48).astype(np.float32) * 0.3
    para[:, 58] = 1.0
    center = rng.uniform([-30, -30, 650], [30, 30, 850], (B, 3)).astype(np.float32)
    cube = np.full((B, 3), 250.0, np.float32)
    dev = renderer.mano.device
    return [torch.from_numpy(x).to(dev) for x in (para, center, cube)]


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_raster_kernel_bitwise_equals_plain(renderer, stride):
    """96 / 3 = 32 and 96 / 1 = 96 pixels a side: full tiles only; 96 / 2 =
    48 also full.  zbuf bitwise, ids equal."""
    para, center, cube = _scene(renderer, 3, stride)
    from dsf_tpu_torch import geometry as geo
    verts, _ = mano.get_mano_vertices(renderer.mano, *mano.split_params(para),
                                      global_scale=1.0 / 125.0)
    verts = verts * cube[:, None] / 2.0 + center[:, None]
    com = geo.xyz_to_uvd(center[:, None], PARAS)[:, 0]
    M = geo.crop_matrix(com, cube, PARAS, renderer.crop_size)
    rays = ras.crop_pixel_rays(M, renderer.crop_size, stride).contiguous()
    proj = ras.project_verts(verts, PARAS)
    H = 96 // stride
    zk, ik = ras.raster_skip(proj, rays, renderer.mano.faces, (H, H))
    zp, ip = ras.raster_scan(proj, rays, renderer.mano.faces)
    assert (zp > 0).float().mean() > 0.02
    assert torch.equal(zk, zp) and torch.equal(ik, ip)


def test_raster_kernel_ragged_tiles(cuda):
    """A 40 x 24 layout (not a multiple of the 16 x 16 tile) on a random
    mesh: the kernel masks its ragged edge."""
    rng = np.random.RandomState(0)
    B, V, F = 2, 60, 150
    verts = torch.from_numpy((rng.randn(B, V, 3) * 10 + [0, 0, 100])
                             .astype(np.float32)).to(cuda)
    faces = torch.from_numpy(np.stack([rng.choice(V, 3, replace=False)
                                       for _ in range(F)])).to(cuda)
    v, u = torch.meshgrid(torch.arange(40.0, device=cuda),
                          torch.arange(24.0, device=cuda), indexing="ij")
    pix = torch.stack([u.reshape(-1), v.reshape(-1)], -1).expand(B, -1, -1)
    proj = ras.project_verts(verts, (50.0, 50.0, 12.0, 20.0))
    zk, ik = ras.raster_skip(proj, pix.contiguous(), faces, (40, 24))
    zp, ip = ras.raster_scan(proj, pix, faces)
    assert torch.equal(zk, zp) and torch.equal(ik, ip)


def test_codec_kernels_match_plain(renderer):
    para, center, cube = _scene(renderer, 4, 7)
    img, juvd, _, _ = rnd.render_params(renderer, para, center, cube,
                                        img_stride=2)
    before = dict(kernels.LAUNCHES)
    enc = oc.joint2offset(juvd, img, 0.8, 48)
    torch.testing.assert_close(enc, oc.joint2offset_plain(juvd, img, 0.8),
                               rtol=0, atol=1e-5)
    dec = oc.offset2joint_softmax(enc, img, 0.8)
    torch.testing.assert_close(dec, oc.offset2joint_plain(enc, img, 0.8),
                               rtol=0, atol=1e-5)
    assert kernels.LAUNCHES["codec_encode"] == before["codec_encode"] + 1
    assert kernels.LAUNCHES["codec_decode"] == before["codec_decode"] + 1


def test_wrapper_rejects_wrong_layouts(cuda):
    with pytest.raises(ValueError):
        raster_kernel.raster_skip_cuda(
            torch.zeros(1, 64, 16, device=cuda), torch.zeros(1, 1, 4, device=cuda),
            torch.zeros(1, 255, 2, device=cuda), (16, 16))
    with pytest.raises(ValueError, match="aligned"):
        raster_kernel.raster_skip_cuda(
            torch.zeros(64 * 16 + 1, device=cuda)[1:].view(1, 64, 16),
            torch.zeros(1, 1, 4, device=cuda),
            torch.zeros(1, 256, 2, device=cuda), (16, 16))
    with pytest.raises(ValueError):
        codec_kernel.encode_cuda(torch.zeros(1, 21, 3, device=cuda),
                                 torch.zeros(1, 1, 8, 8, device=cuda,
                                             dtype=torch.float64), 0.8)


def _grads(fn, args, cot):
    ts = [a.detach().clone().requires_grad_(True) for a in args]
    (fn(*ts) * cot).sum().backward()
    return [t.grad for t in ts]


def test_moments_kernel_matches_plain(cuda):
    """K2 against index_add_: the same sums in another order (shared-memory
    atomics), so 2e-7 relative per moment plus 2e-7 of the face's sum of
    |rows| for sums that cancel."""
    rng = np.random.RandomState(0)
    B, P, T = 4, 4096, 1554
    idx = torch.from_numpy(rng.randint(-1, T + 3, (B, P)).astype(np.int32)).to(cuda)
    upd = torch.from_numpy(rng.randn(B, P, 3).astype(np.float32)).to(cuda)
    before = kernels.LAUNCHES["raster_moments"]
    got = moments_kernel.face_moments_cuda(idx, upd, T)
    assert kernels.LAUNCHES["raster_moments"] == before + 1
    ref = moments_kernel.face_moments_plain(idx, upd, T)
    absum = moments_kernel.face_moments_plain(idx, upd.abs(), T)
    assert ((got - ref).abs() <= 2e-7 * ref.abs() + 2e-7 * absum).all()


def test_codec_vjp_kernels_match_plain(renderer):
    """K5 bwd and K4 bwd against autograd of the plain versions on the same
    rendered scene and cotangents: 1e-4 of each gradient's largest entry
    (the kernels sum over pixels and joints in other orders; near a joint
    the encode's 1/dist^2 amplifies rounding)."""
    para, center, cube = _scene(renderer, 4, 11)
    img, juvd, _, _ = rnd.render_params(renderer, para, center, cube,
                                        img_stride=2)
    img, juvd = img.contiguous(), juvd.contiguous()
    S = img.shape[-1]
    g = torch.randn(4, 84, S, S, device=img.device,
                    generator=torch.Generator(img.device).manual_seed(0))
    before = dict(kernels.LAUNCHES)
    dj, dd = codec_kernel.encode_bwd_cuda(juvd, img, g, 0.8)
    rj, rd = _grads(lambda j, d: oc.joint2offset_plain(j, d, 0.8), (juvd, img), g)
    offset = (oc.joint2offset_plain(juvd, img, 0.8) + 0.05 * g).contiguous()
    gd = torch.randn(4, 21, 3, device=img.device,
                     generator=torch.Generator(img.device).manual_seed(1))
    dx, ddd = codec_kernel.decode_bwd_cuda(offset, img, gd, 0.8, 30.0)
    rx, rdd = _grads(lambda o, d: oc.offset2joint_plain(o, d, 0.8, 30.0),
                     (offset, img), gd)
    assert kernels.LAUNCHES["codec_encode_bwd"] == before["codec_encode_bwd"] + 1
    assert kernels.LAUNCHES["codec_decode_bwd"] == before["codec_decode_bwd"] + 1
    for got, ref in ((dj, rj), (dd, rd), (dx, rx), (ddd, rdd)):
        assert ref.abs().max() > 0
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))


def test_cuda_path_carries_the_training_gradient(renderer):
    """The training path's gradients on CUDA: through the raster (K1, then
    K2 in AttachRasterGrad's backward) to the projected vertices, through
    the codec encode (K5 fwd/bwd) to the joints and the image, and through
    the decode (K4 fwd/bwd) to the offsets and the depth, against the CPU's
    plain path on the same inputs.  The same vertices give the same face
    ids (K1 is bitwise-equal to the plain scan), so the gradients agree to
    1e-4 of their largest entry (other summation orders).  The CUDA codec
    and raster used to return tensors without a gradient."""
    from dsf_tpu_torch import geometry as geo
    para, center, cube = _scene(renderer, 3, 12)
    verts, _ = mano.get_mano_vertices(renderer.mano, *mano.split_params(para),
                                      global_scale=1.0 / 125.0)
    verts = verts * cube[:, None] / 2.0 + center[:, None]
    com = geo.xyz_to_uvd(center[:, None], PARAS)[:, 0]
    M = geo.crop_matrix(com, cube, PARAS, renderer.crop_size)
    rays = ras.crop_pixel_rays(M, renderer.crop_size, 2).contiguous()
    proj = ras.project_verts(verts, PARAS)
    S = renderer.crop_size[0] // 2
    gen = torch.Generator().manual_seed(2)
    cot_z = torch.randn(3, S * S, generator=gen)
    joint = torch.rand(3, 21, 3, generator=gen) * 1.6 - 0.8
    img = torch.rand(3, 1, S, S, generator=gen) * 2.2 - 1.0
    cot_enc = torch.randn(3, 84, S, S, generator=gen)
    cot_dec = torch.randn(3, 21, 3, generator=gen)
    faces = renderer.mano.faces
    before = dict(kernels.LAUNCHES)
    out = {}
    for dev in ("cuda", "cpu"):
        leaf = lambda t: t.detach().to(dev).requires_grad_(True)
        p = leaf(proj)
        z, idx = ras.raster_skip(p, rays.to(dev), faces.to(dev), (S, S))
        (z * cot_z.to(dev)).sum().backward()
        j, d = leaf(joint), leaf(img)
        enc = oc.joint2offset(j, d, 0.8, S)
        (enc * cot_enc.to(dev)).sum().backward()
        o = leaf(enc + 0.05 * cot_enc.to(dev))
        d2 = leaf(img)
        (oc.offset2joint_softmax(o, d2, 0.8) * cot_dec.to(dev)).sum().backward()
        out[dev] = [idx.cpu()] + [t.grad.cpu() for t in (p, j, d, o, d2)]
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before} == {
        "raster_skip": 1, "raster_moments": 1, "codec_encode": 1,
        "codec_encode_bwd": 1, "codec_decode": 1, "codec_decode_bwd": 1,
        "point_mesh_argmin": 0, "tail_conv": 0}
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert (out["cpu"][0] >= 0).float().mean() > 0.05
    for got, ref in zip(out["cuda"][1:], out["cpu"][1:]):
        assert ref.abs().max() > 0
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("shape", [(4, 64, 32, 32), (32, 512, 4, 4)])
def test_train_batchnorm_on_the_card_matches_cpu(cuda, shape):
    """Train-mode BatchNorm's running statistics on the card (cuDNN's EMA,
    corrected per channel to Flax's biased variance) equal the CPU's,
    which test_torch_train_bn.py holds to Flax's: 1e-5 relative, the two
    devices reducing N*H*W values in their own orders."""
    from dsf_tpu_torch.models.layers import batch_norm
    rng = np.random.RandomState(shape[0])
    x = torch.from_numpy((rng.randn(*shape) * 2 + 0.5).astype(np.float32))
    var0 = torch.from_numpy(rng.uniform(0.5, 1.5, shape[1]).astype(np.float32))
    stats = []
    for dev in ("cpu", cuda):
        m = batch_norm(shape[1]).to(dev).train()
        with torch.no_grad():
            m.running_var.copy_(var0)
        m(x.to(dev))
        stats.append([m.running_mean.cpu().numpy(), m.running_var.cpu().numpy()])
    for got, ref in zip(stats[1], stats[0]):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_point_mesh_kernel_matches_plain(renderer):
    """K3 against its plain version on posed hands, under the ICP's
    16-column part table with parts -1 and 16 (out of range) among the
    points.  Held by the exact distance of the kernel's winning face
    against the plain minimum: 1e-5 relative plus 1e-6 (the kernel's
    divide-free form subtracts p.p + v.v ~ 1 in these unit-sized
    coordinates, so its rounding, ~1e-7, may pick a face that much
    further); the indices differ only there, and on exact ties.  A point
    that admits no face gets imin 0 from both."""
    para, center, cube = _scene(renderer, 4, 13)
    verts, _ = mano.get_mano_vertices(renderer.mano, *mano.split_params(para),
                                      global_scale=1.0 / 125.0)
    gen = torch.Generator(device=verts.device).manual_seed(3)
    B, P = 4, 2048
    idx = torch.randint(0, 778, (B, P), device=verts.device, generator=gen)
    pts = (torch.gather(verts, 1, idx[..., None].expand(B, P, 3))
           + 0.03 * torch.randn(B, P, 3, device=verts.device, generator=gen))
    tris = verts[:, renderer.mano.faces]
    T = tris.shape[1]
    table = torch.cat([renderer.mano.joint_face_mask,
                       torch.ones(T, 1, dtype=torch.bool, device=verts.device)],
                      dim=1)
    part = torch.randint(-1, 17, (B, P), device=verts.device, generator=gen)
    before = kernels.LAUNCHES["point_mesh_argmin"]
    dk, ik = pm.argmin_faces(pts, tris, table, part)
    assert kernels.LAUNCHES["point_mesh_argmin"] == before + 1
    dp, ip = pm.argmin_faces_plain(pts, tris, table, part)
    none = dp >= 1e10
    assert none.sum() > 100 and (ik[none] == 0).all() and (dk[none] >= 1e10).all()
    win = torch.gather(tris, 1, ik.long()[..., None, None].expand(B, P, 3, 3))
    d_win = pm.point_tri_sqdist(pts, win)
    torch.testing.assert_close(d_win[~none], dp[~none], rtol=1e-5, atol=1e-6)
    assert (ik == ip).float().mean() > 0.9
    assert table[ik[~none].long(), part[~none]].all()


def test_finetune_stage_step_icp_gradient_reaches_stage2_head(cuda, mano_path):
    """One FinetuneStage loss at B=2, 64^2 on the card launches K3 once, and
    the ICP terms (d2m, pd2m) move the stage-2 MANO head's gradient: with
    their weights at 0 it changes by more than 1e-3 of its size, and that
    change agrees with the CPU's (the plain argmin) to 5e-2 in relative L2
    (a few cloud points may take another part label or another nearest
    face of almost the same distance on the two devices)."""
    import dataclasses
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.training import phases
    from dsf_tpu_torch.training.trainer import Trainer
    B, S = 2, 64
    cfg = Config(dataset="nyu", batch_size=B, stage_num=2, input_size=S)
    no_icp = dataclasses.replace(cfg, model_weight=0.0, partICP_weight=0.0)
    para, cube = [torch.from_numpy(x) for x in next(random_param_source(B))]
    icp_part = {}
    for dev in (cuda, "cpu"):
        tr = Trainer(cfg, mano_path, device=dev)
        net = tr.init_state().net
        draws = tr.draw(B, "FinetuneStage").to(dev)
        real = demo.real_batch(tr.renderer, B, np.random.RandomState(4))
        head = []
        before = kernels.LAUNCHES["point_mesh_argmin"]
        for c in (cfg, no_icp):
            net.zero_grad(set_to_none=True)
            with exact_float32():
                sample = phases.finetune_stage_sample(
                    tr.renderer, draws, para.to(dev), cube.to(dev))
                loss, _ = phases.finetune_stage_loss(
                    net, tr.renderer, sample, draws.scores, real["img"],
                    real["center"], real["cube"], real["M"], real["xyz_gt"], c)
                loss.backward()
            head.append(net.mano_regress_s2[2].weight.grad.cpu())
        launched = kernels.LAUNCHES["point_mesh_argmin"] - before
        assert launched == (2 if dev == cuda else 0)
        icp_part[str(dev)] = head[0] - head[1]
        assert icp_part[str(dev)].norm() > 1e-3 * head[0].norm()
    got, ref = icp_part["cuda"], icp_part["cpu"]
    assert (got - ref).norm() <= 5e-2 * ref.norm()


@pytest.mark.parametrize("shape", [(2, 64, 134, 134), (3, 5, 45, 37)])
def test_tail_conv_kernel_matches_plain(cuda, shape):
    """K9 against its plain version (cuDNN's convolution without TF32, then
    tanh) at the generator's head shape and at a ragged one (tiles and a
    channel chunk cut short): each output within 1e-6 of the sum of its
    products' magnitudes (about 16 units of float32 rounding), the same
    float32 sum in another order (tanh has slope at most 1), as
    test_torch_cyclegan.py holds the CPU's.  The gradient of the autograd.Function is the plain
    version's (its backward recomputes through it)."""
    from dsf_tpu_torch.device import exact_float32
    gen = torch.Generator(device=cuda).manual_seed(shape[1])
    x = torch.randn(*shape, device=cuda, generator=gen)
    w = 0.1 * torch.randn(1, shape[1], 7, 7, device=cuda, generator=gen)
    b = torch.randn(1, device=cuda, generator=gen)
    with exact_float32():
        before = kernels.LAUNCHES["tail_conv"]
        got = tapsum_kernel.tail_conv_cuda(x, w, b)
        assert kernels.LAUNCHES["tail_conv"] == before + 1
        ref = tapsum.tail_conv_tanh_plain(x, w, b)
        absum = torch.nn.functional.conv2d(x.double().abs(), w.double().abs())
        assert got.shape == ref.shape == (shape[0], 1, shape[2] - 6,
                                          shape[3] - 6)
        assert ((got - ref).abs() <= 1e-6 * absum).all()
        xs = [t.clone().requires_grad_(True) for t in (x, w, b)]
        cot = torch.randn(ref.shape, device=cuda, generator=gen)
        tapsum.tail_conv_tanh(*xs).backward(cot)
        rs = [t.clone().requires_grad_(True) for t in (x, w, b)]
        tapsum.tail_conv_tanh_plain(*rs).backward(cot)
    for a, r in zip(xs, rs):
        torch.testing.assert_close(a.grad, r.grad, rtol=0,
                                   atol=1e-5 * float(r.grad.abs().max()))


def test_generator_on_the_card_matches_cpu(cuda):
    """The full-width generator (ngf 64, 9 blocks) on the stand-in weights
    at B=2, 64x64: one K9 launch, and the output within 1e-4 of the CPU's
    (cuDNN's float32 convolutions and instance norms against the CPU's,
    through 22 layers; tanh output in [-1, 1])."""
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.models.cyclegan import ResnetGenerator
    from dsf_tpu_torch.models.weights import random_generator_state_dict
    gen = ResnetGenerator.from_state_dict(
        random_generator_state_dict(np.random.RandomState(0))).eval()
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (2, 1, 64, 64)).astype(np.float32))
    with torch.no_grad(), exact_float32():
        ref = gen(x)
        before = kernels.LAUNCHES["tail_conv"]
        got = gen.to(cuda)(x.to(cuda)).cpu()
    assert kernels.LAUNCHES["tail_conv"] == before + 1
    assert ref.abs().max() > 0.5
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
