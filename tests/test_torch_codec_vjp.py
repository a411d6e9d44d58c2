"""K4's plain versions, ``offset_codec.decode_fwd_plain`` (the joints and
the softmax statistics) and ``decode_bwd_plain`` (the VJP in closed form
from them), against the JAX package: its jnp path (offset2joint_softmax)
and decode_pallas, whose Pallas forward and VJP run in interpret mode, and
against float64.  Small shapes: J=21, S=16 at B=2 and B=1, and S=31, whose
S^2 is not a multiple of 4 (the CUDA kernel's single-pixel units)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dsf_tpu.ops import offset_codec as JO
from dsf_tpu_torch.ops import offset_codec as TO

torch.set_num_threads(2)

SHAPES = {"B2_S16": (2, 16), "B1_S16": (1, 16), "B2_S31": (2, 31)}
J, K, SCALE = 21, 0.8, 30.0


@pytest.fixture()
def interpret_codec(monkeypatch):
    import dsf_tpu.ops.pallas_codec as PC
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(PC.pl, "pallas_call", patched)


def _inputs(seed, B, S):
    """The CPU codec tests' recipe: units ~ N(0, 0.3), heat in [-0.5, 1),
    depth in [-1, 1.05) (some background), cotangent N(0, 1)."""
    rng = np.random.RandomState(seed)
    offset = rng.randn(B, 4 * J, S, S).astype(np.float32) * 0.3
    offset[:, 3 * J:] = rng.uniform(-0.5, 1.0, (B, J, S, S))
    depth = rng.uniform(-1, 1.05, (B, 1, S, S)).astype(np.float32)
    cot = rng.randn(B, J, 3).astype(np.float32)
    return offset, depth, cot


def _jax_decode(reference):
    from dsf_tpu.ops.pallas_codec import decode_pallas
    if reference == "jnp":
        return lambda o, d: JO.offset2joint_softmax(o, d, K)
    return lambda o, d: decode_pallas(o, d, K, SCALE)


def _plain(offset, depth, cot):
    o, d, g = (torch.from_numpy(a) for a in (offset, depth, cot))
    y, stats = TO.decode_fwd_plain(o, d, K, SCALE)
    dx, dd = TO.decode_bwd_plain(o, d, g, y, stats, K, SCALE)
    return y, stats, dx, dd


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reference", ["jnp", "pallas"])
def test_decode_fwd_plain_matches_jax(reference, shape, interpret_codec):
    """decode_fwd_plain's joints against the jnp path and decode_pallas's
    Pallas forward (_decode_fwd_call, interpret): 1e-5 absolute, as
    chip_smoke.py holds the kernel to its plain version."""
    B, S = SHAPES[shape]
    offset, depth, cot = _inputs(1, B, S)
    ref = np.asarray(_jax_decode(reference)(jnp.asarray(offset),
                                            jnp.asarray(depth)))
    y, _, _, _ = _plain(offset, depth, cot)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_decode_fwd_plain_stats_match_float64(shape):
    """The statistics the VJP takes: m is the float32 max of scale * heat *
    mask (the float64 max rounded, within an ulp), and m + log Z is the
    row's logsumexp in float64 within 1e-6 relative."""
    B, S = SHAPES[shape]
    offset, depth, cot = _inputs(2, B, S)
    _, stats, _, _ = _plain(offset, depth, cot)
    mask = (depth < 0.99).reshape(B, 1, S * S)
    s64 = (offset[:, 3 * J:].reshape(B, J, S * S).astype(np.float64)
           * mask * SCALE)
    m64 = s64.max(-1)
    lse = m64 + np.log(np.exp(s64 - m64[..., None]).sum(-1))
    m, z = stats[..., 0].numpy(), stats[..., 1].numpy().astype(np.float64)
    np.testing.assert_allclose(m, m64, rtol=2 ** -23, atol=0)
    np.testing.assert_allclose(m + np.log(z), lse, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reference", ["jnp", "pallas"])
def test_decode_bwd_plain_matches_jax(reference, shape, interpret_codec):
    """decode_bwd_plain (the closed form from y and the statistics) against
    jax.grad of the jnp path and of decode_pallas (its Pallas VJP
    _decode_bwd in interpret mode), as test_torch_train_kernels.py holds
    autograd of offset2joint_plain: rtol 1e-4, atol 1e-6."""
    B, S = SHAPES[shape]
    offset, depth, cot = _inputs(3, B, S)
    jfn = _jax_decode(reference)
    go_r, gd_r = jax.grad(lambda o, d: jnp.sum(jfn(o, d) * cot),
                          argnums=(0, 1))(jnp.asarray(offset),
                                          jnp.asarray(depth))
    _, _, dx, dd = _plain(offset, depth, cot)
    np.testing.assert_allclose(dx.numpy(), np.asarray(go_r), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(dd.numpy(), np.asarray(gd_r), rtol=1e-4,
                               atol=1e-6)
    assert np.abs(dd.numpy()).max() > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_decode_bwd_plain_matches_float64_autograd(shape):
    """The closed form against float64 autograd of offset2joint_plain: no
    further than twice float32 autograd's distance, relative to the largest
    entry (both measured at 4e-7 to 1.1e-6 here, at most 1.21x apart:
    A = g . y costs no accuracy)."""
    B, S = SHAPES[shape]
    offset, depth, cot = _inputs(4, B, S)
    _, _, dx, dd = _plain(offset, depth, cot)

    def autograd(dtype):
        o, d = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                for a in (offset, depth))
        (TO.offset2joint_plain(o, d, K, SCALE)
         * torch.from_numpy(cot).to(dtype)).sum().backward()
        return o.grad, d.grad

    ref64, auto32 = autograd(torch.float64), autograd(torch.float32)
    for got, a32, r in zip((dx, dd), auto32, ref64):
        scale = float(r.abs().max())
        closed = float((got.double() - r).abs().max()) / scale
        auto = float((a32.double() - r).abs().max()) / scale
        assert closed <= 2 * auto, (closed, auto)


def _nan_inputs(S):
    """B=2: a NaN in joint 4's y unit row at a background pixel of image 0,
    a +inf in joint 7's heat at a foreground pixel of image 1, and a NaN in
    joint 2's heat at a background pixel of image 1."""
    offset, depth, cot = _inputs(5, 2, S)
    bg0 = np.argwhere(depth[0, 0] >= 0.99)[0]
    fg1 = np.argwhere(depth[1, 0] < 0.99)[0]
    bg1 = np.argwhere(depth[1, 0] >= 0.99)[0]
    offset[0, 3 * 4 + 1, bg0[0], bg0[1]] = np.nan
    offset[1, 3 * J + 7, fg1[0], fg1[1]] = np.inf
    offset[1, 3 * J + 2, bg1[0], bg1[1]] = np.nan
    return offset, depth, cot


@pytest.mark.parametrize("shape", ["B2_S16", "B2_S31"])
def test_decode_plain_nan_pattern_matches_jax(shape):
    """A NaN or inf anywhere in the field, the background too, reaches the
    joints as in JAX: y's non-finite entries are the jnp path's (image 0's
    joint 4 in its y coordinate only, image 1's joints 7 and 2 whole), and
    the closed-form VJP is non-finite exactly where float32 autograd is."""
    _, S = SHAPES[shape]
    offset, depth, cot = _nan_inputs(S)
    ref = np.asarray(JO.offset2joint_softmax(jnp.asarray(offset),
                                             jnp.asarray(depth), K))
    y, _, dx, dd = _plain(offset, depth, cot)
    y = y.numpy()
    np.testing.assert_array_equal(np.isnan(y), np.isnan(ref))
    np.testing.assert_array_equal(np.isinf(y), np.isinf(ref))
    fin = np.isfinite(ref)
    assert (~fin).sum() == 7 and (~fin[0, 4]).tolist() == [False, True, False]
    np.testing.assert_allclose(y[fin], ref[fin], rtol=0, atol=1e-5)
    o, d = (torch.from_numpy(a).requires_grad_(True) for a in (offset, depth))
    (TO.offset2joint_plain(o, d, K, SCALE) * torch.from_numpy(cot)).sum(
    ).backward()
    assert torch.equal(dx.isfinite(), o.grad.isfinite())
    assert torch.equal(dd.isfinite(), d.grad.isfinite())
    assert not dx.isfinite().all()
