"""Port parity for the bfloat16 compute dtype, layer by layer: the port's
BatchNorm (one group and two, train and eval), the generator's instance
norm, convolution, transposed convolution and dense layers, K9's plain
version, and the narrow generator, each against the JAX package's Flax
module with ``dtype=jnp.bfloat16`` on the same numpy inputs and
variables.  Both sides run bfloat16 on the CPU (XLA and oneDNN); the
parameters stay float32 on both.

The rounding points decide the parity: where the port rounds where JAX
rounds and computes its statistics alike, the outputs are bitwise equal
(BatchNorm in eval mode and with two groups, the instance norm).  A
convolution or a batch statistic sums in float32 on both sides, in other
orders, and rounds once to bfloat16: there the outputs lie within one
bfloat16 step of each other, on a small share of the elements
(``steps``), stated in each test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dsf_tpu.models import layers as JL
from dsf_tpu.models.cyclegan import ResnetGenerator as JGenerator
from dsf_tpu.models.cyclegan import _instance_norm
from dsf_tpu.ops import pallas_tapsum as PT
from dsf_tpu_torch.models import layers as TL
from dsf_tpu_torch.models.cyclegan import InstanceNorm, ResnetGenerator
from dsf_tpu_torch.models.weights import generator_state_dict_from_jax
from dsf_tpu_torch.ops import tapsum

torch.set_num_threads(2)

BF = jnp.bfloat16


def _bf(x):
    """numpy float32 -> (the same values rounded to bfloat16 as a JAX
    array, and as an NCHW port tensor when 4-D NHWC)."""
    j = jnp.asarray(x, BF)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()
    return j, t


def _np(a):
    """A JAX or torch array as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def steps(a, b):
    """|a - b| in bfloat16 steps at the larger magnitude (8 significant
    bits: a step is 2^(e - 7) for a value in [2^e, 2^(e+1)))."""
    m = np.maximum(np.abs(a), np.abs(b))
    step = np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
    return np.abs(a - b) / step


# ------------------------------------------------------------- BatchNorm

N, H, W, C = 4, 8, 8, 16


@pytest.fixture(scope="module")
def bn_data():
    rng = np.random.RandomState(0)
    x = rng.randn(N, H, W, C).astype(np.float32) * 2 + 0.5
    return dict(x=x, scale=rng.uniform(0.5, 1.5, C).astype(np.float32),
                bias=(rng.randn(C) * 0.3).astype(np.float32),
                mean=(rng.randn(C) * 0.1).astype(np.float32),
                var=rng.uniform(0.5, 2, C).astype(np.float32))


def _jax_bn(d, groups, train):
    mod = JL.BatchNorm(dtype=BF, groups=groups)
    v = {"params": {"bn": {"scale": d["scale"], "bias": d["bias"]}},
         "batch_stats": {"bn": {"mean": d["mean"], "var": d["var"]}}}
    xj, _ = _bf(d["x"])
    if not train:
        return _np(mod.apply(v, xj, train=False)), d["mean"], d["var"]
    y, mut = mod.apply(v, xj, train=True, mutable=["batch_stats"])
    st = mut["batch_stats"]["bn"]
    return _np(y), np.asarray(st["mean"]), np.asarray(st["var"])


def _port_bn(d, groups, train, forward=None):
    bn = TL.batch_norm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(d["scale"]))
        bn.bias.copy_(torch.from_numpy(d["bias"]))
        bn.running_mean.copy_(torch.from_numpy(d["mean"]))
        bn.running_var.copy_(torch.from_numpy(d["var"]))
    bn.groups = groups
    bn.train(train)
    _, xt = _bf(d["x"])
    y = (forward or (lambda m, h: m(h)))(bn, xt.permute(0, 3, 1, 2))
    assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.weight.dtype == torch.float32
    return (_np(y).transpose(0, 2, 3, 1), bn.running_mean.numpy(),
            bn.running_var.numpy(), bn)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_flax_bitwise(bn_data, groups, train):
    """One group (Flax ``nn.BatchNorm``: float32 arithmetic, one rounding)
    and two (``_GroupedBN``: mean, rsqrt(var + eps) * scale and bias
    rounded to bfloat16, the rest in bfloat16), in train and eval mode:
    the outputs bitwise, but for one group in train mode, where
    ``F.batch_norm``'s batch variance (not Flax's E[x^2] - E[x]^2, summed
    in another order) moves the float32 result by an ulp, and 2 of the
    4096 elements round one bfloat16 step apart (0.05%; at most 0.5%
    here).  The running statistics (float32 EMAs of the batch statistics)
    within 1e-6 of each tensor's largest entry (measured 2.4e-7 absolute
    on the variance)."""
    y, m, v, _ = _port_bn(bn_data, groups, train)
    yj, mj, vj = _jax_bn(bn_data, groups, train)
    if groups == 1 and train:
        s = steps(y, yj)
        assert s.max() <= 1 and (s > 0).mean() <= 0.005
    else:
        assert np.array_equal(y, yj)
    np.testing.assert_allclose(m, mj, rtol=0, atol=1e-6 * np.abs(mj).max())
    np.testing.assert_allclose(v, vj, rtol=0, atol=1e-6 * np.abs(vj).max())
    if train:
        assert not np.array_equal(vj, bn_data["var"])


def test_grouped_batch_norm_rounding_once_fails(bn_data):
    """Mutation check: a grouped BatchNorm that rounds once (one float32
    ``F.batch_norm`` a group, as the float32 path computes) is not the JAX
    package's bfloat16 ``_GroupedBN``: it differs from JAX in 42.9% of the
    elements (measured), while the port's matches bitwise (above).  So the
    bitwise test of the two-group case can fail."""
    y, _, _, _ = _port_bn(bn_data, 2, True, forward=lambda m, h: torch.cat(
        [m._train_forward(c) for c in h.chunk(2)]))
    yj, _, _ = _jax_bn(bn_data, 2, True)
    assert (y != yj).mean() > 0.2


def test_grouped_ema_equals_the_float32_path(bn_data):
    """The bfloat16 grouped path's running statistics (Flax's EMA of the
    biased variance, written out) equal those of the float32 grouped path
    (``F.batch_norm`` a group, with its unbiased-variance correction) on
    the same values: within 1e-6 of the largest entry."""
    _, m, v, _ = _port_bn(bn_data, 2, True)
    bn = TL.batch_norm(C)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(bn_data["mean"]))
        bn.running_var.copy_(torch.from_numpy(bn_data["var"]))
    bn.groups = 2
    _, xt = _bf(bn_data["x"])
    bn(xt.float().permute(0, 3, 1, 2))
    for got, ref in ((m, bn.running_mean.numpy()),
                     (v, bn.running_var.numpy())):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    assert int(bn.num_batches_tracked) == 2


# ------------------------------------------------- instance norm, convs

def test_instance_norm_matches_jax_bitwise():
    """The generator's instance norm on a bfloat16 input: the JAX
    package's ``_instance_norm`` (mean and variance rounded to bfloat16,
    then subtraction, square root and division in bfloat16) bitwise; the
    float32 path (nn.InstanceNorm2d, one rounding) differs from it in
    about half the elements, so the test can fail."""
    x = np.random.RandomState(1).randn(2, 16, 16, 8).astype(np.float32) + 0.3
    xj, xt = _bf(x)
    ref = _np(_instance_norm(xj))
    got = InstanceNorm(8)(xt.permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got).transpose(0, 2, 3, 1), ref)
    once = torch.nn.functional.instance_norm(xt.permute(0, 3, 1, 2).float(),
                                             eps=1e-5).bfloat16()
    assert (_np(once).transpose(0, 2, 3, 1) != ref).mean() > 0.2


def _flax_conv(mod, x, params):
    return _np(mod.apply({"params": params}, jnp.asarray(x, BF)))


LAYERS = {
    # name: (Flax module, port module, input shape NHWC)
    "conv3x3_bias": lambda: (
        JL.Conv(16, 3, 1, 1, use_bias=True, dtype=BF),
        TL.Conv2d(8, 16, 3, 1, 1, bias=True), (2, 12, 12, 8)),
    "conv5x5_stride2": lambda: (
        JL.Conv(16, 5, 2, 2, dtype=BF),
        TL.Conv2d(8, 16, 5, 2, 2, bias=False), (2, 12, 12, 8)),
    "deconv4_s2": lambda: (
        JL.ConvTranspose(8, 4, 2, 1, dtype=BF),
        TL.ConvTranspose2d(16, 8, 4, 2, 1, bias=False), (2, 6, 6, 16)),
    "deconv3_s2_op1_bias": lambda: (
        JL.ConvTranspose(8, 3, 2, 1, output_padding=1, use_bias=True,
                         dtype=BF),
        TL.ConvTranspose2d(16, 8, 3, 2, 1, output_padding=1, bias=True),
        (2, 6, 6, 16)),
}


def _flax_params(name, port):
    """The port module's parameters as the Flax module's: a torch conv's
    (out, in, kh, kw) and a transposed conv's (in, out, kh, kw) both become
    (kh, kw, in, out) and (kh, kw, out, in) = Flax's kernel and its
    ``transpose_kernel`` layout by the same transpose."""
    p = {"kernel": port.weight.detach().numpy().transpose(2, 3, 1, 0)}
    if port.bias is not None:
        p["bias"] = port.bias.detach().numpy()
    return {"conv" if name.startswith("conv") else "deconv": p}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_conv_layers_match_flax(name):
    """Convolutions and transposed convolutions in bfloat16 (input and
    kernel cast, float32 sums rounded once, the bias added in bfloat16)
    against Flax's ``dtype=bfloat16``: no element more than one bfloat16
    step from JAX's and at most 1% of them one step off (the float32 sums
    run in other orders and may round apart; here they are bitwise, 0%
    measured for each layer).
    The parameters stay float32 and their gradients come back float32."""
    torch.manual_seed(0)
    jmod, port, shape = LAYERS[name]()
    TL.set_compute_dtype(port, torch.bfloat16)
    with torch.no_grad():
        if port.bias is not None:
            port.bias.normal_()
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    ref = _flax_conv(jmod, x, _flax_params(name, port))
    _, xt = _bf(x)
    got = port(xt.permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    s = steps(_np(got).transpose(0, 2, 3, 1), ref)
    assert got.shape[2:] == ref.shape[1:3]
    assert s.max() <= 1 and (s > 0).mean() <= 0.01, (s.max(), (s > 0).mean())
    got.float().sum().backward()
    assert port.weight.grad.dtype == torch.float32


def test_dense_matches_flax():
    """The MANO head's dense layer (512 -> 62) in bfloat16 against Flax
    ``nn.Dense(dtype=bfloat16)``: within one bfloat16 step, on at most 1%
    of the elements (bitwise here, measured)."""
    torch.manual_seed(1)
    port = TL.Linear(512, 62)
    TL.set_compute_dtype(port, torch.bfloat16)
    x = np.random.RandomState(3).randn(8, 512).astype(np.float32)
    params = {"kernel": port.weight.detach().numpy().T,
              "bias": port.bias.detach().numpy()}
    import flax.linen as fnn
    ref = _np(fnn.Dense(62, dtype=BF).apply({"params": params},
                                            jnp.asarray(x, BF)))
    _, xt = _bf(x)
    got = port(xt)
    assert got.dtype == torch.bfloat16
    s = steps(_np(got), ref)
    assert s.max() <= 1 and (s > 0).mean() <= 0.01


def test_float32_layers_keep_nn_forward():
    """Under float32 the layers are nn.Conv2d's / nn.Linear's own forward
    (no cast): a float64 input stays float64, as the float64 witnesses
    of the tests and chip_smoke.py need."""
    conv = TL.Conv2d(2, 3, 3, bias=True)
    TL.set_compute_dtype(conv, torch.float32)
    assert conv.compute_dtype is None
    x = torch.randn(1, 2, 5, 5, dtype=torch.float64)
    assert conv.double()(x).dtype == torch.float64
    with pytest.raises(ValueError):
        TL.set_compute_dtype(conv, torch.float16)


# ------------------------------------------------------ K9, generator

def test_tail_conv_plain_bf16_matches_jax():
    """K9's plain version on bfloat16 x, w, b (the generator's head input
    at B=2, 64 channels, 70^2 padded) against
    ``_reference_tail(..., bfloat16)`` and ``_fast_tail(...,
    bfloat16)`` (the taps contracted, then the Pallas shift-sum in
    interpret mode).  The rounding points are the same; each float32 sum
    runs in its own order, so an output may round one bfloat16 step apart:
    at most 1% of them here (measured 0.012% against each, 1 of 8192).  Against
    float64 on the same bfloat16 values: within the three roundings' bound
    (the sum and the bias add, each half a step of the pre-tanh value,
    through tanh' = 1 - y^2, then half a step of the output), with 1e-3 of
    a step for tanh's own approximation."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 70, 70, 64).astype(np.float32)
    w = (rng.randn(7, 7, 64, 1) * 0.02).astype(np.float32)
    b = np.array([0.1], np.float32)
    xj, wj, bj = (jnp.asarray(a, BF) for a in (x, w, b))
    ref = _np(PT._reference_tail(xj, wj, bj, BF))
    orig = PT.pl.pallas_call
    PT.pl.pallas_call = lambda *a, **k: orig(*a, **dict(k, interpret=True))
    try:
        fast = _np(PT._fast_tail(xj, wj, bj, BF))
    finally:
        PT.pl.pallas_call = orig
    xt, wt, bt = (torch.from_numpy(_np(a)).bfloat16() for a in (xj, wj, bj))
    xt, wt = xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
    got = tapsum.tail_conv_tanh(xt, wt, bt)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, 64, 64)
    g = _np(got).transpose(0, 2, 3, 1)
    s = steps(g, ref)
    assert s.max() <= 1 and (s > 0).mean() <= 0.01
    s = steps(g, fast)
    assert s.max() <= 1 and (s > 0).mean() <= 0.01
    pre = torch.nn.functional.conv2d(xt.double(), wt.double()) + bt.double()
    y64 = torch.tanh(pre).numpy().transpose(0, 2, 3, 1)
    pre = np.abs(pre.numpy().transpose(0, 2, 3, 1))
    # half a step is at most 2^-8 of the value rounded: the sum (at most
    # |pre| + |b|), the pre-tanh value, the output
    tol = ((1 - y64 ** 2) * 2.0 ** -8 * (2 * pre + 0.1) * 1.01
           + 2.0 ** -8 * np.abs(y64) * 1.001 + 1e-6)
    assert (np.abs(g - y64) <= tol).all()
    assert (np.abs(ref - y64) <= tol).all()
    assert (np.abs(y64) < 0.5).mean() > 0.2 and np.abs(y64).max() > 0.9


@pytest.fixture(scope="module")
def generators():
    """The JAX generator (ngf 8, 2 blocks) initialised at key 0 and the
    port's from its variables; a B=2 32x32 input."""
    g = JGenerator(ngf=8, n_blocks=2, dtype=BF)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(g.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32))))
    sd = generator_state_dict_from_jax(v)
    x = np.random.RandomState(5).uniform(-1, 1, (2, 1, 32, 32)).astype(
        np.float32)
    return g, v, sd, x


def test_generator_bf16_matches_jax(generators):
    """The narrow generator in bfloat16: parameters float32, image
    bfloat16 (JAX's too).  The two bfloat16 images against the float64
    generator on the same weights: the port's distance within 1.5x JAX's
    (the same rounding points; a convolution's one-step flips spread
    through the instance norms differently on each side), and JAX's own
    distance below 0.1 on the tanh output (measured in the printed
    line)."""
    g, v, sd, x = generators
    y_jax = _np(jax.jit(g.apply)(v, jnp.asarray(x)))
    gen = ResnetGenerator.from_state_dict(sd, torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in gen.parameters())
    with torch.no_grad():
        y = gen(torch.from_numpy(x))
        y64 = ResnetGenerator.from_state_dict(sd).double()(
            torch.from_numpy(x).double()).numpy()
    assert y.dtype == torch.bfloat16 and y.shape == (2, 1, 32, 32)
    d_port = np.abs(_np(y) - y64).max()
    d_jax = np.abs(y_jax - y64).max()
    same = float((_np(y) == y_jax).mean())
    print(f"generator bf16 from float64: port {d_port:.4g}, JAX {d_jax:.4g}; "
          f"bitwise equal share {same:.4f}")
    assert d_jax < 0.1
    assert d_port <= 1.5 * d_jax
