"""Port parity for the training path's kernels, on their plain versions:
K2 (raster-backward moments) and the raster backward it serves, and the
VJPs of the offset codec (K4 bwd, K5 bwd), against the JAX package on the
same numpy inputs and cotangents.  The JAX side runs on the CPU: its jnp
paths, and its Pallas kernels in interpret mode.  The autograd.Functions
of the CUDA path are checked here with their launchers swapped for plain
float64 versions (wiring, and a finite-difference gradcheck).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from dsf_tpu.ops import offset_codec as JO
from dsf_tpu.ops import rasterize as JR
from dsf_tpu_torch import kernels
from dsf_tpu_torch.ops import codec_kernel, moments_kernel
from dsf_tpu_torch.ops import offset_codec as TO
from dsf_tpu_torch.ops import rasterize as TR

torch.set_num_threads(2)


def _interpret(monkeypatch, module):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(module.pl, "pallas_call", patched)


@pytest.fixture()
def interpret_raster(monkeypatch):
    import dsf_tpu.ops.pallas_raster as PR
    _interpret(monkeypatch, PR)


@pytest.fixture()
def interpret_codec(monkeypatch):
    import dsf_tpu.ops.pallas_codec as PC
    _interpret(monkeypatch, PC)


# ------------------------------------------------------------------ K2

def _moment_inputs(seed, B=3, P=1000, T=333):
    rng = np.random.RandomState(seed)
    idx = rng.randint(-1, T, (B, P)).astype(np.int32)
    upd = rng.randn(B, P, 3).astype(np.float32)
    upd[idx < 0] = 0.0          # the raster backward zeroes misses (g * hit)
    return idx, upd, T


def _assert_moments_close(got, ref, upd, idx, T):
    """The per-face sums are taken in another order on each side, so they
    agree to float32 rounding of the summation order: 2e-7 relative per
    moment (the JAX package's own statement of the einsum against a
    scatter, rasterize.py:485-486), plus an absolute floor of 2e-7 times
    the face's sum of |rows| for sums that cancel to near zero."""
    absum = moments_kernel.face_moments_plain(
        torch.from_numpy(idx), torch.from_numpy(np.abs(upd)), T).numpy()
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert (err <= 2e-7 * np.abs(ref) + 2e-7 * absum + 1e-30).all(), \
        float((err / (absum + 1e-30)).max())


def test_moments_plain_matches_pallas_interpret(interpret_raster):
    from dsf_tpu.ops.pallas_raster import face_moments_pallas
    idx, upd, T = _moment_inputs(2)
    ref = np.asarray(face_moments_pallas(jnp.asarray(idx), jnp.asarray(upd), T))
    got = moments_kernel.face_moments_plain(torch.from_numpy(idx),
                                            torch.from_numpy(upd), T)
    assert got.shape == (3, T, 3)
    _assert_moments_close(got.numpy(), ref, upd, idx, T)


def test_moments_plain_matches_einsum_path():
    """The JAX raster backward's default: the chunked one-hot einsum of
    rasterize._attach_bwd (:499-511), quantity-major, HIGHEST precision."""
    idx, upd, T = _moment_inputs(5)
    upd_t = jnp.asarray(upd).transpose(0, 2, 1)                 # (B, 3, P)
    chunks = []
    for c in range(0, T, 512):
        width = min(512, T - c)
        onehot = (jnp.asarray(idx)[:, :, None]
                  == (c + jnp.arange(width))[None, None]).astype(jnp.float32)
        chunks.append(jnp.einsum("bpc,bmp->bmc", onehot, upd_t,
                                 precision=jax.lax.Precision.HIGHEST))
    ref = np.asarray(jnp.concatenate(chunks, axis=2).transpose(0, 2, 1))
    got = moments_kernel.face_moments_plain(torch.from_numpy(idx),
                                            torch.from_numpy(upd), T)
    _assert_moments_close(got.numpy(), ref, upd, idx, T)


def test_moments_plain_ignores_out_of_range_ids():
    """Ids outside [0, T) add nothing, whatever their rows hold (the kernel
    promises the same)."""
    idx = torch.tensor([[0, -1, 5, 2, 7, 2]], dtype=torch.int32)
    upd = torch.arange(18, dtype=torch.float32).reshape(1, 6, 3)
    got = moments_kernel.face_moments_plain(idx, upd, 5)
    ref = torch.zeros(1, 5, 3)
    ref[0, 0] = upd[0, 0]
    ref[0, 2] = upd[0, 3] + upd[0, 5]
    assert torch.equal(got, ref)


# ------------------------------------------------------- raster backward

def _raster_scene(seed, B=2, V=60, F=130, hw=(32, 32)):
    rng = np.random.RandomState(seed)
    verts = (rng.randn(B, V, 3) * 10 + [0, 0, 100]).astype(np.float32)
    faces = np.stack([rng.choice(V, 3, replace=False)
                      for _ in range(F)]).astype(np.int32)
    paras = (100.0, 100.0, 16.0, 16.0)
    proj = np.array(JR.project_verts(jnp.asarray(verts), paras))
    pix = np.broadcast_to(np.asarray(JR.full_frame_pixel_rays(hw)),
                          (B, hw[0] * hw[1], 2)).copy()
    cot = rng.randn(B, hw[0] * hw[1]).astype(np.float32)
    return proj, pix, faces, cot


@pytest.mark.parametrize("seed", [0, 1])
def test_raster_backward_matches_jax_grad(seed):
    """d proj of sum(zbuf * cot) through the port's raster_skip (plain scan +
    AttachRasterGrad over the plain moments) against jax.grad through
    rasterize._raster (stop-gradient scan + _attach_raster_grad, einsum
    moments).  Face ids are held equal first; then d proj agrees to 1e-4
    relative of its largest entry: both sides form the same moments and
    differentiate the same face_sum, in float32 with other summation
    orders, and the pixel-coordinate scale (~10) amplifies moment rounding
    into the vertex gradient (the JAX package holds its two moment paths
    to each other at 2e-4, tests/test_pallas_kernels.py)."""
    proj, pix, faces, cot = _raster_scene(seed)

    def jloss(p):
        return jnp.sum(JR._raster(None, p, jnp.asarray(pix), jnp.asarray(faces))
                       * cot)

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(proj)))
    _, i_ref = JR._raster_scan(jnp.asarray(proj), jnp.asarray(pix),
                               jnp.asarray(faces))
    p = torch.from_numpy(proj).requires_grad_(True)
    z, i = TR.raster_skip(p, torch.from_numpy(pix),
                          torch.from_numpy(faces.astype(np.int64)), (32, 32))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    assert (i.numpy() >= 0).mean() > 0.2
    (z * torch.from_numpy(cot)).sum().backward()
    g = p.grad.numpy()
    assert np.abs(g_ref).max() > 0
    np.testing.assert_allclose(g, g_ref, rtol=0,
                               atol=1e-4 * np.abs(g_ref).max())


def test_raster_backward_is_the_hard_depth_gradient():
    """Against a float64 finite difference of the zbuf at fixed face ids:
    moving one vertex by 1e-3 pixel moves only the pixels of its faces,
    along their depth planes (the assignment itself is not
    differentiated)."""
    proj, pix, faces, cot = _raster_scene(3, B=1)
    faces_t = torch.from_numpy(faces.astype(np.int64))
    p = torch.from_numpy(proj).requires_grad_(True)
    z, idx = TR.raster_skip(p, torch.from_numpy(pix), faces_t, (32, 32))
    (z * torch.from_numpy(cot)).sum().backward()

    def depth_at_fixed_ids(pr):
        a, b, c, az, bz, cz, _ = TR.face_coeffs(pr, faces_t)
        hit = idx[0] >= 0
        f = idx[0].long().clamp_min(0)
        u, v = torch.from_numpy(pix)[0, :, 0].double(), torch.from_numpy(pix)[0, :, 1].double()
        zz = u * az[0, f] + v * bz[0, f] + cz[0, f]
        return (torch.where(hit, zz, torch.zeros_like(zz))
                * torch.from_numpy(cot)[0].double()).sum()

    p64 = torch.from_numpy(proj).double()
    rng = np.random.RandomState(0)
    for vi in rng.choice(proj.shape[1], 5, replace=False):
        for k in range(3):
            e = torch.zeros_like(p64)
            e[0, vi, k] = 1e-3
            fd = (depth_at_fixed_ids(p64 + e)
                  - depth_at_fixed_ids(p64 - e)) / 2e-3
            assert abs(float(fd) - float(p.grad[0, vi, k])) <= (
                1e-3 * max(1.0, abs(float(fd)))), (vi, k)


# ------------------------------------------------------------- codec VJPs

def _codec_inputs(seed=0, B=2, J=21, S=16):
    rng = np.random.RandomState(seed)
    offset = rng.randn(B, 4 * J, S, S).astype(np.float32) * 0.3
    offset[:, 3 * J:] = rng.uniform(-0.5, 1.0, (B, J, S, S))
    depth = rng.uniform(-1, 1.05, (B, 1, S, S)).astype(np.float32)
    return offset, depth


def _port_grads(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    (fn(*ts) * torch.from_numpy(cot)).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("reference", ["jnp", "pallas"])
def test_decode_vjp_matches_jax(reference, interpret_codec):
    """K4 bwd's plain version (autograd of offset2joint_plain) against the
    jnp path's autodiff and decode_pallas's VJP (_decode_bwd) in interpret
    mode, with the same cotangent: d offset and d depth to 1e-4 relative
    (the JAX package holds its kernel to its jnp path so), 1e-6 absolute."""
    from dsf_tpu.ops.pallas_codec import decode_pallas
    offset, depth = _codec_inputs(1)
    cot = np.random.RandomState(2).randn(2, 21, 3).astype(np.float32)
    jfn = ((lambda o, d: JO.offset2joint_softmax(o, d, 0.8))
           if reference == "jnp" else
           (lambda o, d: decode_pallas(o, d, 0.8, 30.0)))
    go_r, gd_r = jax.grad(lambda o, d: jnp.sum(jfn(o, d) * cot),
                          argnums=(0, 1))(jnp.asarray(offset), jnp.asarray(depth))
    go, gd = _port_grads(lambda o, d: TO.offset2joint_softmax(o, d, 0.8),
                         (offset, depth), cot)
    np.testing.assert_allclose(go, np.asarray(go_r), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gd, np.asarray(gd_r), rtol=1e-4, atol=1e-6)
    assert np.abs(gd).max() > 0


@pytest.mark.parametrize("reference", ["jnp", "pallas"])
def test_encode_vjp_matches_jax(reference, interpret_codec):
    """K5 bwd's plain version (autograd of joint2offset_plain) against the
    jnp path's autodiff and encode_pallas's VJP (_encode_bwd) in interpret
    mode, both held against the port's plain VJP evaluated in float64.
    Near a joint 1/dist^2 amplifies rounding, so how far float32 lands
    from float64 depends on the order of each side's sums, which a CPU
    does not keep from run to run (once, in a -n 6 run, the two sides lay
    1.4e-4 of the largest entry apart).
    So each gradient (d joint, d img) of the port must lie from float64
    within 3x the JAX side's own distance, plus 1e-6 of the gradient's
    largest entry, and the JAX side within 1e-5 of it, which pins the
    float64 witness from both sides (measured: the port 1.0e-7 and 1.2e-7
    of it, JAX 1.5e-7 to 2.5e-7, with 1, 2 or 6 torch threads and with
    XLA's multithreading, fast math or optimisation level changed)."""
    from dsf_tpu.ops.pallas_codec import encode_pallas
    rng = np.random.RandomState(4)
    B, J, S = 2, 21, 16
    joint = rng.uniform(-0.9, 0.9, (B, J, 3)).astype(np.float32)
    img = rng.uniform(-1, 1.05, (B, 1, S, S)).astype(np.float32)
    cot = rng.randn(B, 4 * J, S, S).astype(np.float32)
    jfn = ((lambda j, d: JO.joint2offset(j, d, 0.8, S))
           if reference == "jnp" else
           (lambda j, d: encode_pallas(j, d, 0.8)))
    gj_r, gd_r = jax.grad(lambda j, d: jnp.sum(jfn(j, d) * cot),
                          argnums=(0, 1))(jnp.asarray(joint), jnp.asarray(img))
    gj, gd = _port_grads(lambda j, d: TO.joint2offset(j, d, 0.8, S),
                         (joint, img), cot)
    exact = _port_grads(lambda j, d: TO.joint2offset_plain(j, d, 0.8),
                        (joint.astype(np.float64), img.astype(np.float64)),
                        cot.astype(np.float64))
    for got, ref, g64 in ((gj, np.asarray(gj_r), exact[0]),
                          (gd, np.asarray(gd_r), exact[1])):
        scale = np.abs(g64).max()
        port_dist = np.abs(got - g64).max() / scale
        jax_dist = np.abs(ref - g64).max() / scale
        assert scale > 0 and port_dist <= 3 * jax_dist + 1e-6, (
            port_dist, jax_dist)
        assert jax_dist <= 1e-5, jax_dist


# ------------------------------------- the CUDA path's autograd.Functions

def _plain_launchers(monkeypatch, closed_form=False):
    """Swap the kernel launchers for float64-capable plain versions, so the
    autograd.Functions of the CUDA path run on CPU tensors.  K4's VJP is
    autograd of offset2joint_plain, or with ``closed_form`` its kernel's
    plain version ``decode_bwd_plain`` (from the forward's y and
    statistics)."""
    def vjp(f, args, g):
        with torch.enable_grad():
            xs = [a.detach().requires_grad_(True) for a in args]
            return torch.autograd.grad(f(*xs), xs, g)

    monkeypatch.setattr(codec_kernel, "encode_cuda", TO.joint2offset_plain)
    monkeypatch.setattr(codec_kernel, "decode_cuda", TO.decode_fwd_plain)
    monkeypatch.setattr(
        codec_kernel, "encode_bwd_cuda",
        lambda j, i, g, k: vjp(lambda a, b: TO.joint2offset_plain(a, b, k),
                               (j, i), g))
    monkeypatch.setattr(
        codec_kernel, "decode_bwd_cuda",
        TO.decode_bwd_plain if closed_form else
        (lambda o, d, g, y, st, k, s: vjp(
            lambda a, b: TO.offset2joint_plain(a, b, k, s), (o, d), g)))


def test_codec_functions_carry_the_gradient(monkeypatch):
    """The CUDA path's codec goes through EncodeFn / DecodeFn, whose
    backward launches the VJP kernels: with the launchers swapped for
    plain versions, the Functions give plain autograd's gradients to both
    inputs.  (Before the Functions existed, the CUDA codec returned
    tensors with no gradient.)"""
    _plain_launchers(monkeypatch)
    rng = np.random.RandomState(0)
    joint = rng.uniform(-0.9, 0.9, (2, 21, 3)).astype(np.float32)
    img = rng.uniform(-1, 1.05, (2, 1, 8, 8)).astype(np.float32)
    cot = rng.randn(2, 84, 8, 8).astype(np.float32)
    ref = _port_grads(lambda j, d: TO.joint2offset_plain(j, d, 0.8), (joint, img), cot)
    got = _port_grads(lambda j, d: codec_kernel.EncodeFn.apply(j, d, 0.8),
                      (joint, img), cot)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    offset, depth = _codec_inputs(3, S=8)
    cot = rng.randn(2, 21, 3).astype(np.float32)
    ref = _port_grads(lambda o, d: TO.offset2joint_plain(o, d, 0.8, 30.0),
                      (offset, depth), cot)
    got = _port_grads(lambda o, d: codec_kernel.DecodeFn.apply(o, d, 0.8, 30.0),
                      (offset, depth), cot)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_codec_functions_gradcheck_float64(monkeypatch):
    """Finite-difference check (torch.autograd.gradcheck, float64) of
    EncodeFn and DecodeFn on their plain path.  The encode's cone mask and
    the decode's foreground mask are held away from their edges, where the
    function is not differentiable.  DecodeFn's backward is K4's closed
    form (decode_bwd_plain), so the check holds that form too."""
    _plain_launchers(monkeypatch, closed_form=True)
    rng = np.random.RandomState(1)
    joint = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 2, 3))).requires_grad_(True)
    img = torch.from_numpy(rng.uniform(-0.9, 0.5, (1, 1, 4, 4))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda j, d: codec_kernel.EncodeFn.apply(j, d, 5.0), (joint, img))
    offset = torch.from_numpy(rng.randn(1, 8, 4, 4) * 0.3).requires_grad_(True)
    depth = torch.from_numpy(rng.uniform(-0.9, 0.5, (1, 1, 4, 4))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda o, d: codec_kernel.DecodeFn.apply(o, d, 0.8, 30.0),
        (offset, depth))


def test_raster_function_gradcheck_float64():
    """Finite-difference check (float64) of raster_skip's zbuf through
    AttachRasterGrad: at 1e-6 perturbations no pixel changes face, so the
    hard gradient is the derivative."""
    proj, pix, faces, _ = _raster_scene(4, B=1, V=12, F=10, hw=(16, 16))
    faces_t = torch.from_numpy(faces.astype(np.int64))
    pix_t = torch.from_numpy(pix).double()
    p = torch.from_numpy(proj).double().requires_grad_(True)
    _, idx = TR.raster_skip(p.detach(), pix_t, faces_t, (16, 16))
    assert (idx >= 0).sum() > 10
    assert torch.autograd.gradcheck(
        lambda q: TR.raster_skip(q, pix_t, faces_t, (16, 16))[0], (p,),
        atol=1e-5)


def test_plain_paths_launch_nothing():
    before = dict(kernels.LAUNCHES)
    offset, depth = _codec_inputs(6, S=8)
    o = torch.from_numpy(offset).requires_grad_(True)
    TO.offset2joint_softmax(o, torch.from_numpy(depth), 0.8).sum().backward()
    idx, upd, T = _moment_inputs(7, B=1, P=50, T=20)
    TR.face_moments(torch.from_numpy(idx), torch.from_numpy(upd), T)
    assert kernels.LAUNCHES == before
