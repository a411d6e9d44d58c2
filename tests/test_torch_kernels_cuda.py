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
from dsf_tpu_torch.ops import codec_kernel, moments_kernel, raster_kernel
from dsf_tpu_torch.ops import offset_codec as oc
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
def renderer(cuda, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    synthetic.save_synthetic_mano(path)
    return rnd.Renderer.create(mano.load_model(path, device=cuda), "nyu",
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
        "codec_encode_bwd": 1, "codec_decode": 1, "codec_decode_bwd": 1}
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
