"""Port parity for the frozen CycleGAN transfer net: K9's plain version
(the generator's 7x7 C -> 1 tail conv + tanh) and the K9 autograd.Function
against the JAX package's ``ops/pallas_tapsum.py``; the port's
``ResnetGenerator`` against the JAX one; the reference-checkpoint, npz and
random stand-in weights; and the trainer's handling of the transfer net in
all three steps.  Inputs come from numpy seeds; the JAX side runs on the
CPU (its jnp paths, and its Pallas shift-sum in interpret mode).
"""

import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dsf_tpu.models import torch_import as TI
from dsf_tpu.models.cyclegan import ResnetGenerator as JGenerator
from dsf_tpu.ops import pallas_tapsum as PT
from dsf_tpu.training.pipelines import save_variables_npz
from dsf_tpu_torch import demo
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.data.synth_params import random_param_source
from dsf_tpu_torch.mano import synthetic
from dsf_tpu_torch.models.cyclegan import ResnetGenerator
from dsf_tpu_torch.models.weights import (generator_state_dict_from_jax,
                                          load_generator_npz,
                                          load_reference_generator,
                                          random_generator_state_dict)
from dsf_tpu_torch.ops import tapsum, tapsum_kernel
from dsf_tpu_torch.training import phases as TP
from dsf_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)

S, B = 64, 2


def _tail_data(B=2, S=70, C=64, seed=0):
    """tests/test_tapsum.py's inputs: x (B, S, S, C), w (7, 7, C, 1), b (1,)
    in JAX's NHWC / HWIO."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, S, C).astype(np.float32)
    w = (rng.randn(7, 7, C, 1) * 0.1).astype(np.float32)
    b = rng.randn(1).astype(np.float32)
    return x, w, b


def _nchw(x, w, b):
    return (torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(b))


@pytest.fixture()
def interpret_tapsum(monkeypatch):
    orig = PT.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(PT.pl, "pallas_call", patched)


# Each output of the tail conv is a float32 sum of C * 49 products, taken
# in another order by each implementation: the tests hold the port's
# float32 result and the JAX side's each against the port's float64
# within GAMMA of the sum of the products' magnitudes (about 16 units of
# float32 rounding; a sequential sum of n terms is bounded by n - 1
# units), so the two lie within 2 GAMMA of that sum of each other.  At
# tests/test_tapsum.py's shapes (3136 products adding to ~200 in
# magnitude) XLA's convolution lies 1.0e-8 to 1.7e-8 of it from float64,
# the port's CPU convolution 4.3e-8, or 4.6e-7 when oneDNN splits the work
# otherwise (1 of 32 runs of 4 processes at once).
GAMMA = 1e-6


@pytest.mark.parametrize("reference", ["_reference_tail", "_fast_tail"])
def test_tail_conv_plain_matches_jax(reference, interpret_tapsum):
    """K9's plain version against the JAX reference (nn.Conv semantics) and
    the TPU path (_fast_tail: the taps contracted, then the Pallas
    shift-sum, in interpret mode) at tests/test_tapsum.py's shapes, on the
    tanh output (slope at most 1), as GAMMA says."""
    x, w, b = _tail_data()
    ref = np.asarray(getattr(PT, reference)(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(b), None))
    xt, wt, bt = _nchw(x, w, b)
    got = tapsum.tail_conv_tanh(xt, wt, bt)
    exact = tapsum.tail_conv_tanh(xt.double(), wt.double(), bt.double())
    absum = torch.nn.functional.conv2d(xt.double().abs(), wt.double().abs())
    assert got.shape == (2, 1, 64, 64) and ref.shape == (2, 64, 64, 1)
    got, exact, absum = (t.numpy().transpose(0, 2, 3, 1)
                         for t in (got, exact, absum))
    assert (np.abs(got - exact) <= GAMMA * absum).all()
    assert (np.abs(ref - exact) <= GAMMA * absum).all()
    assert np.abs(ref).max() > 0.99 and (np.abs(ref) < 0.5).any()


def test_tail_conv_function_gradients_match_jax(monkeypatch):
    """The K9 autograd.Function with its launcher swapped for the plain
    version (so it runs on CPU tensors): its backward recomputes through
    autograd of the plain version, as _tail_bwd recomputes through
    _reference_tail.  Against jax.grad through tail_conv_tanh's custom VJP
    (tests/test_tapsum.py's shapes) for x, w and b, both held against the
    plain VJP in float64: each side within 5e-6 of each gradient's
    largest entry (measured up to 1.6e-6 for the port and 1.5e-6 for JAX,
    on d b: its 100 terms carry tanh' = 1 - y^2, which float32 rounds
    coarsely where tanh saturates, on both sides alike; 2.0e-7 and 2.2e-7
    for JAX's d x and d w)."""
    monkeypatch.setattr(tapsum_kernel, "tail_conv_cuda",
                        tapsum.tail_conv_tanh_plain)
    x, w, b = _tail_data(B=1, S=16, C=8)
    cot = np.random.RandomState(1).randn(1, 10, 10, 1).astype(np.float32)
    g_ref = jax.grad(lambda *a: jnp.sum(PT.tail_conv_tanh(*a, None) * cot),
                     argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    cot_t = torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())
    ts = [t.requires_grad_(True) for t in _nchw(x, w, b)]
    tapsum_kernel.TailConvFn.apply(*ts).backward(cot_t)
    t64 = [t.detach().double().requires_grad_(True) for t in ts]
    tapsum.tail_conv_tanh_plain(*t64).backward(cot_t.double())
    to_jax = (lambda t: t.numpy().transpose(0, 2, 3, 1),
              lambda t: t.numpy().transpose(2, 3, 1, 0), lambda t: t.numpy())
    for t, t_64, r, f in zip(ts, t64, map(np.asarray, g_ref), to_jax):
        got, exact = f(t.grad), f(t_64.grad)
        tol = 5e-6 * np.abs(exact).max()
        assert got.shape == r.shape and tol > 0
        assert np.abs(got - exact).max() <= tol
        assert np.abs(r - exact).max() <= tol


def _jax_generator(ngf, n_blocks, key, size):
    g = JGenerator(ngf=ngf, n_blocks=n_blocks)
    v = g.init(jax.random.PRNGKey(key), jnp.zeros((1, 1, size, size)))
    return g, jax.tree_util.tree_map(np.asarray, v)


def _port_and_f64(sd, x):
    gen = ResnetGenerator.from_state_dict(sd)
    with torch.no_grad():
        y = gen(torch.from_numpy(x)).numpy()
        y64 = copy.deepcopy(gen).double()(torch.from_numpy(x).double()).numpy()
    return y, y64


def _assert_generator_close(y, y_jax, y64):
    """The float64 copy of the port's generator as the witness (tanh
    output in [-1, 1]): the port's float32 output within 1e-5 of it, the
    JAX output within 1e-4 (measured at full width, 32x32: the port
    3.4e-6, JAX 3.9e-6 with either head; on a synth image JAX's instance
    norms over the flat background round further, 2.4e-5)."""
    np.testing.assert_allclose(y, y64, rtol=0, atol=1e-5)
    np.testing.assert_allclose(y_jax, y64, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fused_tail", ["0", "1"])
def test_generator_matches_jax(monkeypatch, fused_tail):
    """The full-width generator (ngf 64, 9 blocks) at B=2, 32x32, from the
    JAX-initialised parameters, against the JAX generator with its head as
    nn.Conv (DSF_FUSED_TAIL=0) and as the fused tail (=1, run through
    _fast_tail with the Pallas shift-sum in interpret mode)."""
    monkeypatch.setenv("DSF_FUSED_TAIL", fused_tail)
    if fused_tail == "1":
        monkeypatch.setattr(PT, "tail_conv_tanh",
                            lambda x, w, b, dtype=None: PT._fast_tail(
                                x, w, b, dtype, interpret=True))
    g, v = _jax_generator(64, 9, 0, 32)
    x = np.random.RandomState(2).uniform(-1, 1, (2, 1, 32, 32)).astype(np.float32)
    y_jax = np.asarray(g.apply(v, jnp.asarray(x)))
    y, y64 = _port_and_f64(generator_state_dict_from_jax(v), x)
    assert y.shape == (2, 1, 32, 32) and np.abs(y).max() <= 1.0
    _assert_generator_close(y, y_jax, y64)


def test_reference_checkpoint_loads_in_both(tmp_path):
    """A reference-layout state dict saved with torch.save as
    latest_net_G_A.pth (with an old pix2pix instance-norm statistic, which
    both loaders drop) and loaded from its directory by the port and by
    the JAX package's load_cyclegan_generator: the same parameters,
    bitwise, and outputs within the float64 witness's tolerance."""
    sd = random_generator_state_dict(np.random.RandomState(3), ngf=8)
    saved = {k: torch.from_numpy(v) for k, v in sd.items()}
    saved["model.2.running_mean"] = torch.zeros(8)
    torch.save(saved, str(tmp_path / "latest_net_G_A.pth"))
    port_sd = load_reference_generator(str(tmp_path))
    jv = TI.load_cyclegan_generator(str(tmp_path))
    assert set(port_sd) == set(sd)
    back = generator_state_dict_from_jax(jv)
    for k in sd:
        assert np.array_equal(port_sd[k].numpy(), sd[k]), k
        assert np.array_equal(back[k].numpy(), sd[k]), k
    x = np.random.RandomState(4).uniform(-1, 1, (2, 1, 32, 32)).astype(np.float32)
    y_jax = np.asarray(JGenerator(ngf=8).apply(jv, jnp.asarray(x)))
    y, y64 = _port_and_f64(port_sd, x)
    _assert_generator_close(y, y_jax, y64)


def test_npz_export_loads_into_the_port(tmp_path):
    """An npz written by the JAX package's save_variables_npz (what its
    CycleGAN pipeline exports) gives the JAX tree's weights bitwise."""
    _, v = _jax_generator(8, 2, 5, 32)
    path = save_variables_npz(str(tmp_path / "transfer_G_A.npz"), v)
    got = load_generator_npz(path)
    ref = generator_state_dict_from_jax(v)
    assert set(got) == set(ref) and len(got) == 2 * (3 + 2 * 2 + 2 + 1)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert ResnetGenerator.from_state_dict(got).model[-1].weight.shape == (
        1, 8, 7, 7)


def test_random_stand_in_follows_the_jax_init():
    """The seeded stand-in has the JAX generator's shapes (in the reference
    layout) and its init distributions: each weight's standard deviation
    within 5% of flax's draw, the convs truncated at two of their
    standard deviations, zero biases."""
    sd = random_generator_state_dict(np.random.RandomState(0))
    _, v = _jax_generator(64, 9, 0, 32)
    ref = generator_state_dict_from_jax(v)
    assert set(sd) == set(ref)
    for k, r in ref.items():
        a = sd[k]
        assert a.shape == tuple(r.shape) and a.dtype == np.float32, k
        if k.endswith("bias"):
            assert not a.any() and not r.numpy().any(), k
            continue
        np.testing.assert_allclose(a.std(), r.numpy().std(), rtol=0.05,
                                   err_msg=k)
        if ".conv_block." in k or k in ("model.1.weight", "model.26.weight"):
            fan_in = np.prod(a.shape[1:])
            assert np.abs(a).max() <= 2 * np.sqrt(1 / fan_in) / 0.8796 + 1e-6


# ----------------------------------------------- the trainer's transfer net

@pytest.fixture(scope="module")
def mano_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    synthetic.save_synthetic_mano(path)
    return path

def _run_step(mano_path, phase, stage_num):
    """One step of ``phase`` with a missing ``transferNet_pth`` (the seeded
    random generator), recording what the net and the codec's encode
    received and the raw synth image."""
    cfg = Config(dataset="nyu", batch_size=B, stage_num=stage_num,
                 input_size=S, transferNet_pth="missing/latest_net_G_A.pth")
    tr = Trainer(cfg, mano_path, steps_per_epoch=10, device="cpu")
    state = tr.init_state()
    gen = tr.transfer_net
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    para, cube = next(random_param_source(B, seed=4))
    batch = {"model_para": para, "cube_synth": cube}
    if phase != "Pretrain":
        batch.update(demo.real_batch(tr.renderer, B, np.random.RandomState(5)))
    seen = {"net": [], "encode": [], "decode": [], "synth": [], "gen": []}
    sample_fn = "pretrain_sample" if phase == "Pretrain" else \
        "finetune_stage_sample"
    with pytest.MonkeyPatch.context() as mp:
        def record(name, fn, pick):
            def wrapper(*a, **k):
                out = fn(*a, **k)
                seen[name].append(pick(a, out).detach().clone())
                return out
            mp.setattr(TP, fn.__name__, wrapper)

        record("synth", getattr(TP, sample_fn), lambda a, out: out[0])
        record("encode", TP.joint2offset, lambda a, out: a[1])
        record("decode", TP.offset2joint_softmax, lambda a, out: a[1])
        hooks = [state.net.register_forward_hook(
                     lambda m, i, o: seen["net"].append(i[0].detach())),
                 gen.register_forward_hook(
                     lambda m, i, o: seen["gen"].append(o.detach()))]
        state, metrics = tr.train_step_fn(phase)(state, tr.draw(B, phase),
                                                 batch)
        for h in hooks:
            h.remove()
    return tr, state, metrics, before, seen


@pytest.mark.parametrize("phase,stage_num", [("Pretrain", 2),
                                             ("FinetuneStage", 2),
                                             ("Finetune", 1)])
def test_transfer_net_is_frozen_and_feeds_only_the_net(mano_path, phase,
                                                       stage_num):
    """With ``transferNet_pth`` set (missing: the seeded stand-in), the
    generator runs once on the synth batch, gets no gradient, is in no
    optimizer and is unchanged after a step; the net's synth half is the
    generator's image, and the codec reads the raw synth image: every
    encode of the synth labels, and the first decode (of the synth
    outputs)."""
    tr, state, metrics, before, seen = _run_step(mano_path, phase, stage_num)
    gen = tr.transfer_net
    assert not gen.training
    assert all(not p.requires_grad and p.grad is None
               for p in gen.parameters())
    opt_ids = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert not opt_ids & {id(p) for p in gen.parameters()}
    for k, v in gen.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert np.isfinite(float(metrics["loss"]))

    (raw,), (img_t,), (net_in,) = seen["synth"], seen["gen"], seen["net"]
    assert torch.equal(net_in[:B], img_t)
    assert (img_t - raw).abs().max() > 0.1
    assert seen["encode"] and all(torch.equal(e, raw)
                                  for e in seen["encode"])
    assert torch.equal(seen["decode"][0][:B], raw)
