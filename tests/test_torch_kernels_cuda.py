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
from raster_needles import add_needles

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
    boxes = torch.zeros(1, 64, 4, device=cuda)
    cbox = torch.zeros(1, 1, 4, device=cuda)
    with pytest.raises(ValueError):
        raster_kernel.raster_skip_launch(
            torch.zeros(1, 64, 16, device=cuda), boxes, cbox,
            torch.zeros(1, 255, 2, device=cuda), (16, 16))
    with pytest.raises(ValueError, match="aligned"):
        raster_kernel.raster_skip_launch(
            torch.zeros(64 * 16 + 1, device=cuda)[1:].view(1, 64, 16), boxes,
            cbox, torch.zeros(1, 256, 2, device=cuda), (16, 16))
    with pytest.raises(ValueError):
        raster_kernel.raster_dense_launch(
            torch.zeros(1, 64, 16, device=cuda), boxes,
            torch.zeros(1, 2, 4, device=cuda),
            torch.zeros(1, 256, 2, device=cuda))
    with pytest.raises(ValueError, match="int32"):
        raster_kernel.face_setup_cuda(torch.zeros(1, 8, 3, device=cuda),
                                      torch.zeros(4, 3, dtype=torch.int64,
                                                  device=cuda))
    with pytest.raises(ValueError, match="16x16"):
        raster_kernel.binned_setup_cuda(
            torch.zeros(1, 8, 3, device=cuda),
            torch.zeros(4, 3, dtype=torch.int32, device=cuda),
            torch.zeros(1, 240, 2, device=cuda), (16, 15))
    with pytest.raises(ValueError, match="adjacent"):
        raster_kernel.binned_setup_cuda(
            torch.zeros(1, 8, 3, device=cuda),
            torch.zeros(4, 3, dtype=torch.int32, device=cuda),
            torch.zeros(1, 2, 256, device=cuda).transpose(1, 2), (16, 16))
    with pytest.raises(ValueError):
        codec_kernel.encode_cuda(torch.zeros(1, 21, 3, device=cuda),
                                 torch.zeros(1, 1, 8, 8, device=cuda,
                                             dtype=torch.float64), 0.8)
    with pytest.raises(ValueError, match="float32 CUDA"):
        codec_kernel.decode_cuda(torch.zeros(1, 84, 8, 8, device=cuda,
                                             dtype=torch.float64),
                                 torch.zeros(1, 1, 8, 8, device=cuda), 0.8,
                                 30.0)
    with pytest.raises(ValueError, match="stats"):
        codec_kernel.decode_bwd_cuda(torch.zeros(1, 84, 8, 8, device=cuda),
                                     torch.zeros(1, 1, 8, 8, device=cuda),
                                     torch.zeros(1, 21, 3, device=cuda),
                                     torch.zeros(1, 21, 3, device=cuda),
                                     torch.zeros(1, 21, 3, device=cuda),
                                     0.8, 30.0)


def _grads(fn, args, cot):
    ts = [a.detach().clone().requires_grad_(True) for a in args]
    (fn(*ts) * cot).sum().backward()
    return [t.grad for t in ts]


def test_moments_kernel_matches_plain(cuda):
    """K2 against index_add_: the same sums in another fixed order, so 2e-7
    relative per moment plus 2e-7 of the face's sum of |rows| for sums that
    cancel."""
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


def _moments_case(case, cuda):
    """Face ids and rows for K2's layouts: B=1; P not a multiple of 4 and
    ids starting 4 bytes past a 16-byte boundary (both single pixels);
    ids far out of range (-2^31, -5..-1, T..T+999, 2^30); an image with no
    covered pixel beside a covered one; one face covering every pixel of
    a 128x128 image beside a random one."""
    B, P = {"B1": (1, 4096), "odd P": (2, 4093), "ids unaligned": (2, 4096),
            "out of range": (2, 4096), "no covered pixel": (2, 4096),
            "whole image": (2, 128 * 128)}[case]
    T = 1554
    rng = np.random.RandomState(3)
    idx = rng.randint(-1, T, (B, P)).astype(np.int32)
    if case == "out of range":
        idx[0, ::7] = rng.randint(T, T + 1000, idx[0, ::7].shape)
        idx[1, ::5] = rng.randint(-5, 0, idx[1, ::5].shape)
        idx[1, 1] = -2 ** 31
        idx[0, 3] = 2 ** 30
    elif case == "no covered pixel":
        idx[1] = -1
    elif case == "whole image":
        idx[0] = 7
    upd = torch.from_numpy(rng.randn(B, P, 3).astype(np.float32)).to(cuda)
    shift = 1 if case == "ids unaligned" else 0
    buf = torch.empty(B * P + shift, dtype=torch.int32, device=cuda)
    t = buf[shift:].view(B, P)
    t.copy_(torch.from_numpy(idx))
    return t, upd, T


@pytest.mark.parametrize("case", ["B1", "odd P", "ids unaligned",
                                  "out of range", "no covered pixel",
                                  "whole image"])
def test_moments_kernel_layouts(cuda, case):
    """K2 where the 16-byte path does not cover the ids whole, on ids out
    of range, an image without a covered pixel and a face that covers a
    whole image: one launch a call, two runs bitwise equal, a face without
    a pixel exactly 0, and each sum within 1e-6 of the face's sum of |rows|
    of float64's (a float32 sum in a fixed order of at most a few hundred
    rows a chain)."""
    idx, upd, T = _moments_case(case, cuda)
    before = kernels.LAUNCHES["raster_moments"]
    got = moments_kernel.face_moments_cuda(idx, upd, T)
    again = moments_kernel.face_moments_cuda(idx, upd, T)
    assert kernels.LAUNCHES["raster_moments"] == before + 2
    assert torch.equal(got, again)
    ref = moments_kernel.face_moments_plain(idx, upd.double(), T)
    absum = moments_kernel.face_moments_plain(idx, upd.abs().double(), T)
    assert torch.equal(got[absum == 0], torch.zeros_like(got[absum == 0]))
    assert ((got.double() - ref).abs() <= 1e-6 * absum).all()
    if case == "no covered pixel":
        assert not got[1].any()
    if case == "whole image":
        assert got[0, 7].abs().sum() > 0 and (absum[0] > 0).sum() == 3


def test_moments_kernel_rejects_too_many_faces(cuda):
    """K2 keeps each warp's copy of the 3T sums in shared memory: above its
    cap the wrapper raises before a launch."""
    cap = moments_kernel.max_faces()
    assert cap >= 1554
    idx = torch.zeros(1, 64, dtype=torch.int32, device=cuda)
    upd = torch.zeros(1, 64, 3, device=cuda)
    before = kernels.LAUNCHES["raster_moments"]
    with pytest.raises(ValueError, match="faces"):
        moments_kernel.face_moments_cuda(idx, upd, cap + 1)
    assert kernels.LAUNCHES["raster_moments"] == before
    assert moments_kernel.face_moments_cuda(idx, upd, cap).shape == (1, cap, 3)


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
    y, stats = codec_kernel.decode_cuda(offset, img, 0.8, 30.0)
    dx, ddd = codec_kernel.decode_bwd_cuda(offset, img, gd, y, stats, 0.8,
                                           30.0)
    rx, rdd = _grads(lambda o, d: oc.offset2joint_plain(o, d, 0.8, 30.0),
                     (offset, img), gd)
    assert kernels.LAUNCHES["codec_encode_bwd"] == before["codec_encode_bwd"] + 1
    assert kernels.LAUNCHES["codec_decode_bwd"] == before["codec_decode_bwd"] + 1
    for got, ref in ((dj, rj), (dd, rd), (dx, rx), (ddd, rdd)):
        assert ref.abs().max() > 0
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))


def _decode_case(case, cuda):
    """Seeded fields (the CPU tests' recipe, J=21) for K4's layouts: B=1;
    S=31 (S^2 not a multiple of 4: single pixels only); a field starting 4
    bytes past a 16-byte boundary with the depth aligned (single pixels),
    and both starting 8 bytes past one (2 single pixels, then 16-byte
    units); the NaN case (a NaN in a unit row at a background pixel, a
    +inf in a foreground heat entry)."""
    B, S, shift, dshift = {"B1": (1, 64, 0, 0), "odd S": (2, 31, 0, 0),
                           "field unaligned": (2, 64, 1, 0),
                           "both unaligned": (2, 64, 2, 2),
                           "nan": (2, 64, 0, 0)}[case]
    rng = np.random.RandomState(7)
    off = rng.randn(B, 84, S, S).astype(np.float32) * 0.3
    off[:, 63:] = rng.uniform(-0.5, 1.0, (B, 21, S, S))
    dep = rng.uniform(-1, 1.05, (B, 1, S, S)).astype(np.float32)
    g = torch.from_numpy(rng.randn(B, 21, 3).astype(np.float32)).to(cuda)
    if case == "nan":
        bg = np.argwhere(dep[0, 0] >= 0.99)[0]
        fg = np.argwhere(dep[1, 0] < 0.99)[0]
        off[0, 13, bg[0], bg[1]] = np.nan
        off[1, 70, fg[0], fg[1]] = np.inf

    def placed(a, k):
        buf = torch.empty(a.size + k, device=cuda)
        t = buf[k:].view(a.shape)
        t.copy_(torch.from_numpy(a))
        return t

    return placed(off, shift), placed(dep, dshift), g


@pytest.mark.parametrize("case", ["B1", "odd S", "field unaligned",
                                  "both unaligned", "nan"])
def test_decode_kernels_layouts(cuda, case):
    """K4 forward and VJP at the layouts the 16-byte path does not cover
    whole, against their plain versions: y within 1e-5, the softmax max
    exactly and its mass within 1e-5 relative; dx and dd within 1e-4 of
    their largest entry, also against autograd of offset2joint_plain; in
    the NaN case the forward's non-finite entries are the plain version's
    and the VJP's those of autograd."""
    offset, depth, g = _decode_case(case, cuda)
    before = dict(kernels.LAUNCHES)
    y, stats = codec_kernel.decode_cuda(offset, depth, 0.8, 30.0)
    dx, dd = codec_kernel.decode_bwd_cuda(offset, depth, g, y, stats, 0.8,
                                          30.0)
    assert kernels.LAUNCHES["codec_decode"] == before["codec_decode"] + 1
    assert kernels.LAUNCHES["codec_decode_bwd"] == before["codec_decode_bwd"] + 1
    ry, rst = oc.decode_fwd_plain(offset, depth, 0.8, 30.0)
    rx, rd = oc.decode_bwd_plain(offset, depth, g, ry, rst, 0.8, 30.0)
    ax, ad = _grads(lambda o, d: oc.offset2joint_plain(o, d, 0.8, 30.0),
                    (offset, depth), g)
    fin = ry.isfinite()
    assert torch.equal(y.isfinite(), fin) and torch.equal(y.isnan(), ry.isnan())
    assert (case == "nan") == bool((~fin).any())
    assert (y - ry)[fin].abs().max() <= 1e-5
    ok = fin.all(-1)
    assert torch.equal(stats[..., 0][ok], rst[..., 0][ok])
    assert (((stats[..., 1] - rst[..., 1]) / rst[..., 1])[ok].abs()
            <= 1e-5).all()
    for got, ref, auto in ((dx, rx, ax), (dd, rd, ad)):
        assert torch.equal(got.isfinite(), auto.isfinite())
        m = auto.isfinite()
        for r in (ref, auto):
            scale = float(r[m].abs().max())
            assert scale > 0
            assert float((got - r)[m].abs().max()) <= 1e-4 * scale


def test_decode_kernels_repeat_bitwise(cuda):
    """Fixed merge orders: two runs of K4 give the same bits, at a batch
    where the rows are split over clusters (B=1) and where they are not."""
    for case in ("B1", "nan"):
        offset, depth, g = _decode_case(case, cuda)
        runs = []
        for _ in range(2):
            y, st = codec_kernel.decode_cuda(offset, depth, 0.8, 30.0)
            runs.append((y, st) + codec_kernel.decode_bwd_cuda(
                offset, depth, g, y, st, 0.8, 30.0))
        for a, b in zip(*runs):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())
            assert torch.equal(a.isnan(), b.isnan())


def _encode_case(case, cuda):
    """Joints, depth and a cotangent for K5 bwd's layouts: B=1; S=31 (S^2
    not a multiple of 4: single pixels only); g starting 4 bytes past a
    16-byte boundary (single pixels); the NaN case: a NaN in image 0's
    joint-5 x unit row at a pixel outside joint 5's cone, a +inf in image
    1's joint-9 heat row at a foreground pixel inside joint 9's cone."""
    B, S, shift = {"B1": (1, 64, 0), "odd S": (2, 31, 0),
                   "g unaligned": (2, 64, 1), "nan": (2, 64, 0)}[case]
    J, k = 21, 0.8
    rng = np.random.RandomState(9)
    joint = rng.uniform(-0.8, 0.8, (B, J, 3)).astype(np.float32)
    dep = rng.uniform(-1, 1.05, (B, 1, S, S)).astype(np.float32)
    g = rng.randn(B, 4 * J, S, S).astype(np.float32)
    if case == "nan":
        r = (np.arange(S) + 0.5) / S * 2 - 1
        u, v = r[None, :], r[:, None]

        def dist(b, j):
            return np.sqrt((joint[b, j, 0] - u) ** 2 + (joint[b, j, 1] - v) ** 2
                           + (joint[b, j, 2] - dep[b, 0]) ** 2)
        out = np.argwhere(dist(0, 5) > k)[0]
        inside = np.argwhere((dist(1, 9) < k) & (dep[1, 0] < 0.99))[0]
        g[0, 3 * 5, out[0], out[1]] = np.nan
        g[1, 3 * J + 9, inside[0], inside[1]] = np.inf
    buf = torch.empty(g.size + shift, device=cuda)
    gt = buf[shift:].view(g.shape)
    gt.copy_(torch.from_numpy(g))
    return (torch.from_numpy(joint).to(cuda), torch.from_numpy(dep).to(cuda),
            gt)


@pytest.mark.parametrize("case", ["B1", "odd S", "g unaligned", "nan"])
def test_encode_vjp_kernel_layouts(cuda, case):
    """K5 bwd against autograd of joint2offset_plain: one launch a call,
    two runs bitwise equal, non-finite exactly where autograd is (every
    element of g is read), and the finite entries within 1e-4 of the
    largest (sums over pixels and joints in another order)."""
    joint, dep, g = _encode_case(case, cuda)
    before = kernels.LAUNCHES["codec_encode_bwd"]
    dj, dd = codec_kernel.encode_bwd_cuda(joint, dep, g, 0.8)
    dj2, dd2 = codec_kernel.encode_bwd_cuda(joint, dep, g, 0.8)
    assert kernels.LAUNCHES["codec_encode_bwd"] == before + 2
    for a, b in ((dj, dj2), (dd, dd2)):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
        assert torch.equal(a.isnan(), b.isnan())
    rj, rd = _grads(lambda j, d: oc.joint2offset_plain(j, d, 0.8), (joint, dep),
                    g)
    assert (case == "nan") == bool((~rj.isfinite()).any())
    for got, ref in ((dj, rj), (dd, rd)):
        assert torch.equal(got.isfinite(), ref.isfinite())
        m = ref.isfinite()
        scale = float(ref[m].abs().max())
        assert scale > 0
        assert float((got - ref)[m].abs().max()) <= 1e-4 * scale


def test_encode_vjp_rejects_too_many_joints(cuda):
    """K5 bwd keeps a thread's joints' sums in registers: above its layout's
    joint count the wrapper raises before a launch."""
    J = codec_kernel.encode_bwd_max_joints() + 1
    before = kernels.LAUNCHES["codec_encode_bwd"]
    with pytest.raises(ValueError, match="joints"):
        codec_kernel.encode_bwd_cuda(torch.zeros(1, J, 3, device=cuda),
                                     torch.zeros(1, 1, 8, 8, device=cuda),
                                     torch.zeros(1, 4 * J, 8, 8, device=cuda),
                                     0.8)
    assert kernels.LAUNCHES["codec_encode_bwd"] == before


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
        "point_mesh_argmin": 0, "tail_conv": 0, "tail_conv_bf16": 0,
        "icp_argmin_v2": 0, "icp_argmin_culled": 0, "raster_dense": 0,
        "raster_binned": 0}
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


@pytest.mark.parametrize("shape", [(2, 64, 134, 134), (3, 5, 45, 37),
                                   (2, 6, 46, 72), (2, 9, 150, 140)])
def test_tail_conv_kernel_matches_plain(cuda, shape):
    """K9 against its plain version (cuDNN's convolution without TF32, then
    tanh) at the generator's head shape (one bulk copy a channel band) and
    at ragged ones, H and W not multiples of the block's 16 x 128 outputs
    (45 x 37 padded: rows of 43 floats, cp.async; 46 x 72: bulk copies, a
    short last band; 150 x 140: two column tiles, cp.async): each output
    within 1e-6 of the sum of its products' magnitudes (about 16 units of
    float32 rounding), the same float32 sum in another order (tanh has
    slope at most 1), as test_torch_cyclegan.py holds the CPU's; and, on
    the input scaled so that no output saturates, no further from the
    float64 convolution than 3x the plain version + 1e-7.  The gradient of
    the autograd.Function is the plain version's (its backward recomputes
    through it)."""
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
        b2 = b.clamp(-0.5, 0.5)
        conv = torch.nn.functional.conv2d(x.double(), w.double())
        x2 = x * (0.9 - float(b2.abs())) / float(conv.abs().max())
        exact = torch.tanh(torch.nn.functional.conv2d(x2.double(), w.double())
                           + b2.double())
        d_kernel = (tapsum_kernel.tail_conv_cuda(x2, w, b2).double()
                    - exact).abs().max()
        d_plain = (tapsum.tail_conv_tanh_plain(x2, w, b2).double()
                   - exact).abs().max()
        assert d_kernel <= 3 * d_plain + 1e-7, (float(d_kernel),
                                                 float(d_plain))
        xs = [t.clone().requires_grad_(True) for t in (x, w, b)]
        cot = torch.randn(ref.shape, device=cuda, generator=gen)
        tapsum.tail_conv_tanh(*xs).backward(cot)
        rs = [t.clone().requires_grad_(True) for t in (x, w, b)]
        tapsum.tail_conv_tanh_plain(*rs).backward(cot)
    for a, r in zip(xs, rs):
        torch.testing.assert_close(a.grad, r.grad, rtol=0,
                                   atol=1e-5 * float(r.grad.abs().max()))


def test_tail_conv_gradients_at_the_generator_shape(cuda):
    """K9 in training, as the CycleGAN trainer runs it: the generator's head
    input at B=32 (32, 64, 134, 134) through ``TailConvFn`` (the kernel
    forward, one launch), its input, weight and bias gradients for a
    random cotangent against autograd of the plain version on the card
    (the same computation: within 1e-6 of each gradient's largest entry)
    and against float64 autograd on the card (each within 1e-4 relative
    L2, no further than 2x the plain version's distance + 1e-6)."""
    from dsf_tpu_torch.device import exact_float32
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(32, 64, 134, 134, device=cuda, generator=gen)
    w = (torch.randn(1, 64, 7, 7, device=cuda, generator=gen)
         / np.sqrt(64 * 49))
    b = 0.1 * torch.randn(1, device=cuda, generator=gen)
    cot = torch.randn(32, 1, 128, 128, device=cuda, generator=gen)
    grads = {}
    with exact_float32():
        for name, fn, dt in (("kernel", tapsum_kernel.TailConvFn.apply,
                              torch.float32),
                             ("plain", tapsum.tail_conv_tanh_plain,
                              torch.float32),
                             ("float64", tapsum.tail_conv_tanh_plain,
                              torch.float64)):
            ts = [t.to(dt).clone().requires_grad_(True) for t in (x, w, b)]
            before = kernels.LAUNCHES["tail_conv"]
            fn(*ts).backward(cot.to(dt))
            assert kernels.LAUNCHES["tail_conv"] == before + (
                name == "kernel")
            grads[name] = [t.grad.double() for t in ts]
    for got, plain, exact, what in zip(*grads.values(), ("x", "w", "b")):
        assert torch.isfinite(got).all(), what
        torch.testing.assert_close(got, plain, rtol=0,
                                   atol=1e-6 * float(plain.abs().max()))
        d_got = float((got - exact).norm() / exact.norm())
        d_plain = float((plain - exact).norm() / exact.norm())
        assert d_got <= 1e-4 and d_got <= 2 * d_plain + 1e-6, (
            what, d_got, d_plain)


@pytest.mark.parametrize("shape,lead", [
    ((2, 64, 134, 134), 0), ((3, 5, 45, 37), 0), ((2, 6, 46, 72), 0),
    ((2, 9, 150, 140), 0), ((2, 5, 46, 70), 1)])
def test_tail_conv_bf16_kernel_matches_plain(cuda, shape, lead):
    """K9's bfloat16 variant against its plain version in bfloat16 (cuDNN's
    bfloat16 convolution: float32 sums rounded once, the bias added in
    bfloat16, tanh) at the generator's head shape (one bulk copy a channel
    band, widened to 16 bytes: 134-element rows of 268 bytes), a short
    last band (46 x 72), and where the copy is element-wise: rows of odd
    length (45 x 37), two column tiles (150 x 140), and x starting 8 bytes
    past 16 (a slice of a larger batch, ``lead``).  Each float32 sum runs
    in its own order, so a sum may round one bfloat16 step apart: within a
    step (2^-7 of the value) at each of the three roundings, and different
    on at most 1% of the outputs (near a sum that cancels the bias, a
    step of the sum is many steps of the output).  Against tanh of the
    float64 sum of the same bfloat16 values: within half a step (2^-8 of
    the value) at each rounding, the float32 sum within 1e-6 of the sum of
    its products' magnitudes (``chip_smoke.py``'s ``tail_bf16_bound``).  Mixed types raise; the gradient is the plain
    version's in bfloat16 (the backward recomputes through it)."""
    gen = torch.Generator(device=cuda).manual_seed(shape[1])
    big = torch.randn(shape[0] + lead, *shape[1:], device=cuda,
                      generator=gen).bfloat16()
    x = big[lead:]
    w = (0.1 * torch.randn(1, shape[1], 7, 7, device=cuda,
                           generator=gen)).bfloat16()
    b = torch.randn(1, device=cuda, generator=gen).clamp(-0.5, 0.5).bfloat16()
    if lead:
        assert x.data_ptr() % 16 == 8
    before = dict(kernels.LAUNCHES)
    got = tapsum_kernel.tail_conv_cuda(x, w, b)
    assert kernels.LAUNCHES["tail_conv_bf16"] == before["tail_conv_bf16"] + 1
    assert kernels.LAUNCHES["tail_conv"] == before["tail_conv"]
    ref = tapsum.tail_conv_tanh_plain(x, w, b)
    assert got.dtype == ref.dtype == torch.bfloat16
    assert got.shape == ref.shape == (shape[0], 1, shape[2] - 6, shape[3] - 6)
    pre = torch.nn.functional.conv2d(x.double(), w.double()) + b.double()
    y64 = torch.tanh(pre)
    absum = torch.nn.functional.conv2d(x.double().abs(), w.double().abs())

    def bound(r):
        return ((1 - y64 ** 2) * (r * (2 * pre.abs() + float(b.abs())) * 1.01
                                  + r * 2 ** 8 * 1e-6 * absum)
                + r * y64.abs() * 1.001 + 1e-6)

    assert ((got.double() - ref.double()).abs() <= bound(2.0 ** -7)).all()
    assert (got != ref).float().mean() <= 0.01
    assert ((got.double() - y64).abs() <= bound(2.0 ** -8)).all()
    assert torch.equal(got, tapsum_kernel.tail_conv_cuda(x, w, b))
    with pytest.raises(ValueError, match="bfloat16"):
        tapsum_kernel.tail_conv_cuda(x, w.float(), b)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tapsum_kernel.tail_conv_cuda(x.half(), w.half(), b.half())
    xs = [t.clone().requires_grad_(True) for t in (x, w, b)]
    cot = torch.randn(ref.shape, device=cuda, generator=gen).bfloat16()
    tapsum.tail_conv_tanh(*xs).backward(cot)
    rs = [t.clone().requires_grad_(True) for t in (x, w, b)]
    tapsum.tail_conv_tanh_plain(*rs).backward(cot)
    for a, r in zip(xs, rs):
        assert a.grad.dtype == torch.bfloat16
        torch.testing.assert_close(a.grad.float(), r.grad.float(), rtol=0,
                                   atol=1e-2 * float(r.grad.abs().max()))


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


def _icp_problem(renderer, seed):
    """Posed hands (B=4) in normalized units, 2048 points near each, the
    ICP's 16-column part table and parts -1 .. 16 per point."""
    para, _, _ = _scene(renderer, 4, seed)
    verts, _ = mano.get_mano_vertices(renderer.mano, *mano.split_params(para),
                                      global_scale=1.0 / 125.0)
    gen = torch.Generator(device=verts.device).manual_seed(seed)
    B, P = 4, 2048
    idx = torch.randint(0, 778, (B, P), device=verts.device, generator=gen)
    pts = (torch.gather(verts, 1, idx[..., None].expand(B, P, 3))
           + 0.03 * torch.randn(B, P, 3, device=verts.device, generator=gen))
    T = renderer.mano.faces.shape[0]
    table = torch.cat([renderer.mano.joint_face_mask,
                       torch.ones(T, 1, dtype=torch.bool, device=verts.device)],
                      dim=1)
    part = torch.randint(-1, 17, (B, P), device=verts.device, generator=gen)
    return verts, pts, table, part


def _hold_winners(pts, tris, ik, dp):
    """The kernel's winners by their exact distance against the plain
    minimum, as K3's test holds them."""
    B, P = ik.shape
    none = dp >= 1e10
    win = torch.gather(tris, 1, ik.long()[..., None, None].expand(B, P, 3, 3))
    d_win = pm.point_tri_sqdist(pts, win)
    torch.testing.assert_close(d_win[~none], dp[~none], rtol=1e-5, atol=1e-6)
    return none


def test_icp_v2_kernel_matches_plain(renderer):
    """K7 on faces in the caller's order (it sorts them by part inside)
    against its plain version on the part-sorted faces with the same skip
    words: the winners' exact distances as K3's, (1e10, the first face in
    the part order) where no face is admissible, admissible winners, the
    caller's face ids, one launch."""
    verts, pts, table, part = _icp_problem(renderer, 21)
    tris = verts[:, renderer.mano.faces].contiguous()
    before = kernels.LAUNCHES["icp_argmin_v2"]
    dk, ik = pm.argmin_faces_v2(pts, tris, table, part)
    assert kernels.LAUNCHES["icp_argmin_v2"] == before + 1
    fperm = pm.face_part_perm(table)
    words = pm.v2_words(table[fperm], part, 4, 2048, tris.shape[1],
                        pts.device)
    dp, ip = pm.argmin_faces_v2_plain(pts, tris[:, fperm], table[fperm],
                                      part, words)
    none = _hold_winners(pts, tris, ik, dp)
    assert none.sum() > 100 and (dk[none] >= 1e10).all()
    assert (ik[none] == fperm[0]).all()
    assert (ik == fperm[ip.long()]).float().mean() > 0.9
    assert table[ik[~none].long(), part[~none]].all()


@pytest.mark.parametrize("masked", [False, True])
def test_icp_v2_setup_matches_plain(renderer, masked):
    """K7's set-up kernel (csrc/argmin_setup.cuh, K7 mode) against
    ``point_mesh.v2_tables_plain`` on posed hands, with the ICP's
    16-column table and parts -1 .. 16 or without a table, and 2000 points
    (a ragged last tile): the face order, words, chunk ORs, point parts and
    skip words bitwise, the rows as int32 words; and the argmin on them
    against the plain dense argmin by the winners' exact distances."""
    verts, pts, table, part = _icp_problem(renderer, 32)
    pts, part = pts[:, :2000].contiguous(), part[:, :2000].contiguous()
    if not masked:
        table = part = None
    tris = verts[:, renderer.mano.faces].contiguous()
    got = pm.point_mesh_kernel.v2_setup_cuda(pts, tris, table, part)
    ref = pm.v2_tables_plain(pts, tris, table, part)
    assert torch.equal(got.rows.view(torch.int32), ref.rows.view(torch.int32))
    _tables_equal(got, ref, ("fperm", "words", "chunk_or", "parts", "skip"))
    dk, ik = pm.point_mesh_kernel.argmin_faces_v2_launch(pts, got)
    dp, _ = pm.argmin_faces_plain(pts, tris, table, part)
    none = _hold_winners(pts, tris, ik, dp)
    assert none.any() == masked


def test_icp_culled_kernel_matches_plain(renderer):
    """K8 against its plain version on the set-up kernel's own tables (the
    same 16-constant arithmetic, one reciprocal for five divides: dmin
    within 1e-6), and through the dispatch against the plain dense
    argmin by the winners' exact distances, one launch each; a point that
    admits no face gets (1e10, perm[0])."""
    verts, pts, table, part = _icp_problem(renderer, 22)
    tris = verts[:, renderer.mano.faces].contiguous()
    tables = pm.point_mesh_kernel.argmin_setup_cuda(pts, tris, table, part,
                                                    culled=True)
    before = kernels.LAUNCHES["icp_argmin_culled"]
    dk, ik = pm.point_mesh_kernel.argmin_faces_culled_launch(pts, tables)
    dq, iq = pm.argmin_faces_culled_plain(pts, tables)
    iq = tables.fperm[iq.long()]
    torch.testing.assert_close(dk, dq, rtol=0, atol=1e-6)
    assert (ik == iq).float().mean() > 0.9
    dk, ik = pm.argmin_faces_culled(pts, tris, table, part)
    assert kernels.LAUNCHES["icp_argmin_culled"] == before + 2
    dp, _ = pm.argmin_faces_plain(pts, tris, table, part)
    none = _hold_winners(pts, tris, ik, dp)
    perm0 = int(pm.face_part_perm(table)[0])
    assert none.sum() > 100
    assert (dk[none] >= 1e10).all() and (ik[none] == perm0).all()
    assert table[ik[~none].long(), part[~none]].all()
    # the share of (tile, chunk) blocks the run words keep
    run = tables.tiles[..., 3][tables.tiles[..., 2] > 0].long()
    bits = (run[:, None] >> torch.arange(13, device=run.device)) & 1
    assert 0 < float(bits.float().mean()) < 1


def _tables_equal(got, ref, names):
    for name in names:
        g, r = getattr(got, name), getattr(ref, name)
        assert torch.equal(g, r.to(g.device)), name


@pytest.mark.parametrize("culled", [False, True])
def test_argmin_setup_matches_plain(renderer, culled):
    """The set-up kernel of K3 and of K8 (csrc/argmin_setup.cuh) against
    ``point_mesh.argmin_tables_plain`` on posed hands under the ICP's
    16-column table, parts -1 .. 16: the face rows as int32 words; the part
    lists, their chunk offsets, K8's face order, and K3's keys, point order
    and tiles bitwise (integer work).  K8's keys and need words come from
    float sphere math: they may differ from the plain float32 ones only
    where a bound lies within rounding (held against the rule in float64,
    ``cull_within_rounding``; the differences are counted and printed),
    and every point's winning face lies in a chunk its tile runs."""
    verts, pts, table, part = _icp_problem(renderer, 30)
    tris = verts[:, renderer.mano.faces].contiguous()
    got = pm.point_mesh_kernel.argmin_setup_cuda(pts, tris, table, part,
                                                 culled=culled)
    ref = pm.argmin_tables_plain(pts, tris, table, part, culled=culled)
    assert torch.equal(got.rows.view(torch.int32), ref.rows.view(torch.int32))
    _tables_equal(got, ref, ("lists", "lens", "choff"))
    if not culled:
        _tables_equal(got, ref, ("key", "perm", "tiles", "tcount"))
        return
    _tables_equal(got, ref, ("fperm",))
    fperm = got.fperm.long()
    bad = pm.cull_within_rounding(pts, tris[:, fperm], table[fperm], part,
                                  got.key, got.need)
    key_diff = int((got.key != ref.key).sum())
    need_diff = int((got.need != ref.need).sum())
    print(f"K8 set-up: keys differing from the plain float32 ones "
          f"{key_diff}, need words {need_diff}, outside rounding {bad}")
    assert bad == (0, 0)
    if key_diff == 0:
        _tables_equal(got, ref, ("perm", "tcount"))
    # the winner's chunk (in the part order) is run by its point's tile
    _, win = pm.argmin_faces_plain(pts, tris[:, fperm], table[fperm], part)
    B, P = pts.shape[0], pts.shape[1]
    tile_of = torch.full((B, P), -1, dtype=torch.long, device=pts.device)
    tiles = got.tiles.long()
    for b in range(B):
        for t in range(int(got.tcount[b, 0])):
            _, first, count, _ = tiles[b, t].tolist()
            tile_of[b, got.perm[b, first:first + count].long()] = t
    live = tile_of >= 0
    run = torch.gather(tiles[..., 3], 1, tile_of.clamp(min=0))
    kept = ((run >> (win.long() // 128)) & 1).bool()
    assert kept[live].all()


@pytest.mark.parametrize("culled", [False, True])
def test_argmin_kernels_on_a_cloud_that_admits_nothing(renderer, culled):
    """K3 and K8 with one cloud whose parts are all -1 (no face admissible)
    beside clouds of parts -1 .. 16: the empty cloud gets (1e10, 0) from
    K3 and (1e10, perm[0]) from K8 everywhere and no tile; the others as
    the plain dense argmin, by the winners' exact distances."""
    verts, pts, table, part = _icp_problem(renderer, 31)
    tris = verts[:, renderer.mano.faces].contiguous()
    part[1] = -1
    if culled:
        tables = pm.point_mesh_kernel.argmin_setup_cuda(pts, tris, table,
                                                        part, culled=True)
        dk, ik = pm.point_mesh_kernel.argmin_faces_culled_launch(pts, tables)
        id0 = int(pm.face_part_perm(table)[0])
    else:
        tables = pm.point_mesh_kernel.argmin_setup_cuda(pts, tris, table,
                                                        part)
        dk, ik = pm.point_mesh_kernel.argmin_faces_launch(pts, tables)
        id0 = 0
    assert int(tables.tcount[1, 0]) == 0 and int(tables.tcount[1, 1]) == 0
    dp, _ = pm.argmin_faces_plain(pts, tris, table, part)
    none = _hold_winners(pts, tris, ik, dp)
    assert none[1].all() and (dk[none] >= 1e10).all()
    assert (ik[none] == id0).all()
    assert table[ik[~none].long(), part[~none]].all()


def test_raster_dense_kernel_bitwise_equals_plain(cuda):
    """K6 against ``raster_scan`` on a random mesh over a 60 x 50 frame
    (3000 samples, not a multiple of the 256-sample block), through the
    dense route: zbuf bitwise, ids equal, one launch."""
    rng = np.random.RandomState(4)
    B, V, F = 2, 80, 300
    verts = torch.from_numpy((rng.randn(B, V, 3) * 10 + [0, 0, 100])
                             .astype(np.float32)).to(cuda)
    faces = torch.from_numpy(np.stack([rng.choice(V, 3, replace=False)
                                       for _ in range(F)])).to(cuda)
    paras = (50.0, 50.0, 30.0, 25.0)
    pix = ras.full_frame_pixel_rays((60, 50), cuda)
    before = kernels.LAUNCHES["raster_dense"]
    zk, ik = ras.rasterize_depth(verts, faces, pix, paras, return_idx=True)
    assert kernels.LAUNCHES["raster_dense"] == before + 1
    zp, ip = ras.raster_scan(ras.project_verts(verts, paras),
                             pix.expand(B, -1, -1), faces)
    assert (zp > 0).float().mean() > 0.1
    assert torch.equal(zk, zp) and torch.equal(ik, ip)


def _crop_scene(renderer, B, seed, stride):
    """Posed hands' projected vertices and crop rays at ``stride``."""
    from dsf_tpu_torch import geometry as geo
    para, center, cube = _scene(renderer, B, seed)
    verts, _ = mano.get_mano_vertices(renderer.mano, *mano.split_params(para),
                                      global_scale=1.0 / 125.0)
    verts = verts * cube[:, None] / 2.0 + center[:, None]
    com = geo.xyz_to_uvd(center[:, None], PARAS)[:, 0]
    M = geo.crop_matrix(com, cube, PARAS, renderer.crop_size)
    rays = ras.crop_pixel_rays(M, renderer.crop_size, stride).contiguous()
    return ras.project_verts(verts, PARAS), rays


@pytest.mark.parametrize("lib", ["raster_skip", "raster_dense"])
def test_face_setup_matches_skip_tables(renderer, lib):
    """The set-up kernel (csrc/raster_setup.cuh, each library's copy)
    against ``rasterize.skip_tables`` on posed hands plus two degenerate
    faces: rows bit for bit, face and chunk boxes equal, the degenerate
    faces' boxes empty."""
    proj, _ = _crop_scene(renderer, 3, 40, 2)
    faces = torch.cat([renderer.mano.faces,
                       torch.tensor([[0, 0, 1], [5, 5, 5]],
                                    device=proj.device)])
    rows, boxes, cbox = raster_kernel.face_setup_cuda(
        proj, faces.to(torch.int32), lib)
    r_rows, r_boxes, r_cbox = ras.skip_tables(proj, faces)
    assert torch.equal(rows.view(torch.int32), r_rows.view(torch.int32))
    assert torch.equal(boxes, r_boxes) and torch.equal(cbox, r_cbox)
    assert (rows[:, -2:, 12] == 0).all() and (rows[:, :-2, 12] == 1).any()
    assert torch.isinf(boxes[:, -2:]).all()


@pytest.mark.parametrize("case", ["no_hand", "shrunk", "ragged", "permuted",
                                  "needles"])
def test_raster_culled_cases(renderer, case):
    """K1 and K6 against ``raster_scan`` (zbuf bitwise, ids equal) on the
    scenes their per-face cull could get wrong: an image without a hand
    (moved 5000 px off), hands shrunk 5x (tiles that stage more faces than
    one 256-face chunk; faces under a pixel; K10's tiles overflow), a 90 x
    94 layout (K1's tiles ragged in both directions), K6 on the samples in
    a random order, and needles 0.001-0.005 px wide through the crop's
    samples in front of the hands (their rounded edges pass samples beyond
    their tips, outside their screen boxes).  On the 16-aligned layouts, K10's
    route against ``raster_binned_plain`` the same way."""
    proj, rays = _crop_scene(renderer, 3, 41, 1)
    hw = (96, 96)
    faces = renderer.mano.faces
    if case == "needles":
        proj, faces = add_needles(proj, rays, faces, hw, seed=6)
    f32 = faces.to(torch.int32)
    if case == "no_hand":
        proj[0, :, 0] += 5000.0
    elif case == "shrunk":
        mid = proj[..., :2].mean(1, keepdim=True)
        proj[..., :2] = mid + (proj[..., :2] - mid) * 0.2
    elif case == "ragged":
        hw = (90, 94)
        rays = rays.reshape(3, 96, 96, 2)[:, :90, :94].reshape(3, -1, 2)
        rays = rays.contiguous()
    elif case == "permuted":
        perm = torch.randperm(rays.shape[1], device=rays.device,
                              generator=torch.Generator(rays.device)
                              .manual_seed(0))
        rays = rays[:, perm].contiguous()
    zp, ip = ras.raster_scan(proj, rays, faces)
    assert (ip >= 0).any()
    if case == "no_hand":
        assert not (ip[0] >= 0).any()
    if case == "needles":
        assert (ip >= len(renderer.mano.faces)).any()
    zd, i_d = raster_kernel.raster_dense_cuda(proj, f32, rays)
    assert torch.equal(zd, zp) and torch.equal(i_d, ip)
    if case != "permuted":
        zk, ik = raster_kernel.raster_skip_cuda(proj, f32, rays, hw)
        assert torch.equal(zk, zp) and torch.equal(ik, ip)
    if case in ("no_hand", "shrunk", "needles"):
        rows = ras.face_rows(proj, faces)
        tables = ras.binned_tables(proj, rays, faces, hw, rows)
        assert bool(tables[2]) == (case == "shrunk")
        zb, ib = ras.raster_binned_plain(rows, rays, hw, *tables)
        zt, it = raster_kernel.raster_binned_cuda(proj, faces, rays, hw)
        assert torch.equal(zt, zb) and torch.equal(it, ib)


@pytest.mark.parametrize("stride", [1, 2])
def test_raster_binned_kernel_bitwise_equals_plain(renderer, stride,
                                                   monkeypatch):
    """K10 on posed hands' crops through ``rasterize_depth(tile_hw=...)``
    with the skip route off, on the crop rays as the renderer makes them (a
    strided slice), against its plain version over ``binned_tables`` and
    against ``raster_scan``: zbuf bitwise, ids equal, one launch; then its
    raster on the set-up's tables the same, and with the overflow flag
    set, every tile's dense answer."""
    from dsf_tpu_torch import geometry as geo
    monkeypatch.setattr(ras, "USE_PALLAS_SKIP", False)
    para, center, cube = _scene(renderer, 3, 30 + stride)
    verts, _ = mano.get_mano_vertices(renderer.mano, *mano.split_params(para),
                                      global_scale=1.0 / 125.0)
    verts = verts * cube[:, None] / 2.0 + center[:, None]
    com = geo.xyz_to_uvd(center[:, None], PARAS)[:, 0]
    M = geo.crop_matrix(com, cube, PARAS, renderer.crop_size)
    rays = ras.crop_pixel_rays(M, renderer.crop_size, stride)
    assert not rays.is_contiguous()
    faces = renderer.mano.faces
    H = 96 // stride
    before = kernels.LAUNCHES["raster_binned"]
    zk, ik = ras.rasterize_depth(verts, faces, rays, PARAS, return_idx=True,
                                 tile_hw=(H, H))
    assert kernels.LAUNCHES["raster_binned"] == before + 1
    proj = ras.project_verts(verts, PARAS)
    rows = ras.face_rows(proj, faces)
    zb, ib = ras.raster_binned_plain(
        rows, rays, (H, H),
        *ras.binned_tables(proj, rays, faces, (H, H), rows))
    zp, ip = ras.raster_scan(proj, rays, faces)
    assert (zp > 0).float().mean() > 0.02
    assert torch.equal(zk, zb) and torch.equal(ik, ib)
    assert torch.equal(zk, zp) and torch.equal(ik, ip)
    rays = rays.contiguous()
    t = raster_kernel.binned_setup_cuda(proj, faces.to(torch.int32), rays,
                                        (H, H))
    for flag, want in ((t.overflow, (zb, ib)),
                       (torch.ones_like(t.overflow), (zp, ip))):
        z, i = raster_kernel.raster_binned_launch(
            t.rows, t.boxes, t.cbox, t.vbox, t.tbox, rays, flag, (H, H))
        assert torch.equal(z, want[0]) and torch.equal(i, want[1])


@pytest.mark.parametrize("case", ["hands", "overflow", "needles"])
def test_binned_setup_matches_tables(renderer, case):
    """K10's set-up (``binned_setup_cuda``, two launches) against its plain
    version (``binned_setup_plain``: ``skip_tables`` and ``binned_tables``)
    on posed hands plus two degenerate faces, the same hands shrunk 5x
    (a tile over ``BIN_CAP``) and with needles (cover boxes that reach past
    their tips): rows bit for bit, cover, chunk, screen and
    tile boxes equal, counts equal, the overflow flag equal, with int64 and
    int32 faces."""
    proj, rays = _crop_scene(renderer, 3, 42, 1)
    if case == "overflow":
        mid = proj[..., :2].mean(1, keepdim=True)
        proj[..., :2] = mid + (proj[..., :2] - mid) * 0.2
    faces = torch.cat([renderer.mano.faces,
                       torch.tensor([[0, 0, 1], [5, 5, 5]],
                                    device=proj.device)])
    if case == "needles":
        proj, faces = add_needles(proj, rays, faces, (96, 96), seed=7)
    ref = ras.binned_setup_plain(proj, faces, rays, (96, 96))
    assert bool(ref.overflow) == (case == "overflow")
    for f in (faces, faces.to(torch.int32)):
        got = raster_kernel.binned_setup_cuda(proj, f, rays, (96, 96))
        assert torch.equal(got.rows.view(torch.int32),
                           ref.rows.view(torch.int32))
        for name in ("boxes", "cbox", "vbox", "tbox", "counts", "overflow"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
