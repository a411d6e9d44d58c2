"""Port parity for the CycleGAN trainer and the rest of the CycleGAN zoo:
``models/cyclegan.py``'s discriminators, ``gan_loss``, encoder, decoder,
U-Net and ``gradient_penalty``, ``training/cyclegan_trainer.py``'s losses,
gradients and steps, ``training/pipelines.py``'s export and
``run_cyclegan``, the ``cyclegan`` subcommand, and the plumbing of
``scripts/selfsup_gpu.py``, against the JAX package on the CPU.

Small: ngf 8, 2 resnet blocks, 64^2, B=2 (the discriminators keep the
trainer's ndf 64), inputs from numpy seeds, the weights carried from the
JAX trainer's ``init_state``.  A conv whose output goes straight into an
instance norm has a bias that the norm removes: its gradient is exactly
zero, and each side's float32 gradient is rounding noise (the float64
one lies within 1e-12 of the layer's weight gradient); those biases are
held to that, not to a relative distance.
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dsf_tpu.data.fake import make_fake_nyu
from dsf_tpu.models import cyclegan as JC
from dsf_tpu.training import pipelines as JPipe
from dsf_tpu.training.cyclegan_trainer import CycleGANTrainer as JTrainer
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.mano import synthetic
from dsf_tpu_torch.models import cyclegan as TC
from dsf_tpu_torch.models import weights as W
from dsf_tpu_torch.training import pipelines as TPipe
from dsf_tpu_torch.training.cyclegan_trainer import CycleGANTrainer
from dsf_tpu_torch.training.trainer import load_transfer_net

torch.set_num_threads(2)

S, B, NGF, BLOCKS = 64, 2, 8, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, shape=(B, 1, S, S)):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300))


# ------------------------------------------------------------- the modules

def _jax_module(net, x, seed=0):
    v = _np(net.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    return v, np.asarray(net.apply(v, jnp.asarray(x)))


def _port_out(net, sd, x):
    W.load_into(net, sd)
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy()


ZOO = {
    "NLayerDiscriminator": (
        lambda: JC.NLayerDiscriminator(ndf=8),
        lambda: TC.NLayerDiscriminator(ndf=8),
        W.discriminator_convs(3), (B, 1, S, S)),
    "PixelDiscriminator": (
        lambda: JC.PixelDiscriminator(ndf=8),
        lambda: TC.PixelDiscriminator(ndf=8),
        W.pixel_discriminator_convs(), (B, 1, S, S)),
    "ResnetEncoder": (
        lambda: JC.ResnetEncoder(ngf=NGF, n_blocks=BLOCKS),
        lambda: TC.ResnetEncoder(ngf=NGF, n_blocks=BLOCKS),
        W.encoder_convs(BLOCKS), (B, 1, S, S)),
    "ResnetDecoder": (
        lambda: JC.ResnetDecoder(ngf=NGF),
        lambda: TC.ResnetDecoder(ngf=NGF),
        W.decoder_convs(), (B, 4 * NGF, S // 4, S // 4)),
    "UnetGenerator": (
        lambda: JC.UnetGenerator(num_downs=6, ngf=NGF),
        lambda: TC.UnetGenerator(num_downs=6, ngf=NGF),
        W.unet_convs(6), (B, 1, S, S)),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_cyclegan_modules_match_jax(name):
    """Each net of the CycleGAN zoo from the JAX init's weights (carried
    by its conv table, and back bitwise) against the JAX module, within
    1e-5 of the output's largest magnitude (measured 1e-7 to 1e-6); the
    decoder's head runs through the port's tail conv, the U-Net's 1x1
    bottleneck skips its instance norm."""
    jnet, tnet, convs, shape = ZOO[name]
    x = _images(3, shape) * (3.0 if name == "ResnetDecoder" else 1.0)
    v, ref = _jax_module(jnet(), x)
    sd = W.convs_from_jax(v, convs)
    assert len(sd) == sum(1 for _ in jax.tree_util.tree_leaves(v))
    got = _port_out(tnet(), sd, x)
    back = W.convs_to_jax(sd, convs)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, back, v))
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_patchgan_shape_and_gan_loss_match_jax():
    """The trainer's PatchGAN (ndf 64) gives (B, 1, 14, 14) on 128^2 and
    (B, 1, 6, 6) on 64^2; ``gan_loss`` in both modes and both targets
    within 1e-6 relative of JAX's; another mode raises ValueError."""
    assert TC.NLayerDiscriminator()(torch.zeros(1, 1, 128, 128)).shape == (
        1, 1, 14, 14)
    pred = np.random.RandomState(4).randn(B, 1, 6, 6).astype(np.float32) * 2
    for mode in ("lsgan", "vanilla"):
        for real in (True, False):
            ref = float(JC.gan_loss(jnp.asarray(pred), real, mode))
            got = float(TC.gan_loss(torch.from_numpy(pred), real, mode))
            np.testing.assert_allclose(got, ref, rtol=1e-6)
    with pytest.raises(ValueError, match="wgangp"):
        TC.gan_loss(torch.from_numpy(pred), True, "wgangp")


@pytest.mark.parametrize("mode", ["real", "fake", "mixed"])
def test_gradient_penalty_matches_jax(mode):
    """``gradient_penalty`` on the pixel discriminator, with the alpha that
    JAX's draws from its key fed in, both sides held against the port's
    float64 run: the penalty (|grad| ~ 45) within 1e-5 relative for the
    port and 1e-4 for JAX (measured up to 1.7e-6 and 1.1e-5), and its
    gradient in the discriminator's parameters (double backward through
    the input gradient) within 1e-4 relative L2 on both sides (measured up
    to 2.9e-5 and 7.0e-5).  The head's bias gets no gradient; the bias
    before the instance norm gets noise: the port's within 1e-6 of the
    layer's weight gradient, JAX's within 1e-4 (measured 2.2e-7, 5.7e-5),
    float64's within 1e-12."""
    jnet = JC.PixelDiscriminator(ndf=8)
    real, fake = _images(5), _images(6)
    v = _np(jnet.init(jax.random.PRNGKey(1), jnp.asarray(real)))
    key = jax.random.PRNGKey(2)
    alpha = np.array(jax.random.uniform(key, (B, 1, 1, 1)))

    def pen(params):
        return JC.gradient_penalty(
            key, lambda x: jnet.apply({"params": params}, x),
            jnp.asarray(real), jnp.asarray(fake), mode)
    ref, ref_g = jax.value_and_grad(pen)(v["params"])
    convs = W.pixel_discriminator_convs()
    ref_g = W.convs_from_jax({"params": _np(ref_g)}, convs)
    out = {}
    for dt in (torch.float32, torch.float64):
        net = TC.PixelDiscriminator(ndf=8)
        W.load_into(net, W.convs_from_jax(v, convs))
        net.to(dt)
        a, r, f = (torch.from_numpy(x).to(dt) for x in (alpha, real, fake))
        p = TC.gradient_penalty(a, net, r, f, mode)
        p.backward()
        out[dt] = (float(p), {n: q.grad for n, q in net.named_parameters()})
    (got, grads), (exact, grads64) = out[torch.float32], out[torch.float64]
    assert abs(got - exact) <= 1e-5 * exact
    assert abs(float(ref) - exact) <= 1e-4 * exact
    assert grads["net.5.bias"] is None and grads64["net.5.bias"] is None
    assert not np.asarray(ref_g["net.5.bias"]).any()
    scale = np.linalg.norm(grads64["net.2.weight"].numpy())
    assert np.linalg.norm(grads64["net.2.bias"].numpy()) <= 1e-12 * scale
    assert np.linalg.norm(grads["net.2.bias"].numpy()) <= 1e-6 * scale
    assert np.linalg.norm(ref_g["net.2.bias"].numpy()) <= 1e-4 * scale
    for n in ("net.0.weight", "net.0.bias", "net.2.weight", "net.5.weight"):
        e = grads64[n].numpy()
        assert _rel(grads[n].double().numpy(), e) <= 1e-4, n
        assert _rel(ref_g[n].double().numpy(), e) <= 1e-4, n


# ------------------------------------------------------------- the trainer

@pytest.fixture(scope="module")
def trainers():
    """The JAX trainer and state (ngf 8, 2 blocks, 64^2), the port's on the
    same weights, and one batch."""
    jt = JTrainer(ngf=NGF, n_blocks=BLOCKS)
    js = jt.init_state(jax.random.PRNGKey(0), (B, 1, S, S))
    v = {"g_params": _np(js.g_params), "d_params": _np(js.d_params)}
    tt = CycleGANTrainer(ngf=NGF, n_blocks=BLOCKS, device="cpu")
    return dict(jt=jt, js=js, v=v, tt=tt, synth=_images(0), real=_images(1))


def _port_grads(tt, state, synth, real):
    """The port's losses and every net's gradients, by name."""
    dt = state.G_A.model[1].weight.dtype
    s, r = (torch.from_numpy(x).to(dt) for x in (synth, real))
    g_loss, aux = tt._g_loss(state, s, r)
    g = torch.autograd.grad(g_loss, state.generators())
    d_loss = tt._d_loss(state, s, r, aux["fake_real"], aux["fake_synth"])
    d = torch.autograd.grad(d_loss, state.discriminators())
    names = [f"{k}.{n}" for k in ("G_A", "G_B", "D_A", "D_B")
             for n, _ in getattr(state, k).named_parameters()]
    metrics = {k: float(v) for k, v in aux.items() if not k.startswith("fake")}
    metrics.update(g_loss=float(g_loss), d_loss=float(d_loss))
    return metrics, dict(zip(names, (t.double().numpy() for t in (*g, *d))))


def _float64(tt, v):
    state = tt.init_state(variables=v)
    for net in (state.G_A, state.G_B, state.D_A, state.D_B):
        net.double()
    return state


def test_one_step_losses_and_gradients_match_jax(trainers):
    """One step's losses against ``jax.value_and_grad(_g_loss,
    has_aux=True)`` and ``_d_loss`` (jitted), within 1e-5 relative
    (measured 4e-7), and every gradient of both generators and both
    discriminators within 1e-3 relative L2 (measured up to 3.3e-6).  The
    biases before an instance norm (module docstring) are held against
    the float64 gradient and the layer's weight gradient instead: the
    float64 one within 1e-12 of the weight gradient's norm (zero), each
    float32 side within 1e-6 of it (measured up to 2.4e-7)."""
    jt, js, tt = trainers["jt"], trainers["js"], trainers["tt"]
    synth, real = (jnp.asarray(trainers[k]) for k in ("synth", "real"))
    (g_loss, aux), gg = jax.jit(jax.value_and_grad(jt._g_loss, has_aux=True))(
        js.g_params, js.d_params, synth, real)
    d_loss, dg = jax.jit(jax.value_and_grad(jt._d_loss))(
        js.d_params, synth, real, aux["fake_real"], aux["fake_synth"])
    ref_m = {k: float(aux[k]) for k in ("adv_A", "adv_B", "cycle",
                                         "identity", "consis")}
    ref_m.update(g_loss=float(g_loss), d_loss=float(d_loss))
    ref_g = {}
    for k in ("G_A", "G_B"):
        for n, t in W.generator_state_dict_from_jax({"params": gg[k]}).items():
            ref_g[f"{k}.{n}"] = t.double().numpy()
    for k in ("D_A", "D_B"):
        for n, t in W.discriminator_state_dict_from_jax(
                {"params": dg[k]}).items():
            ref_g[f"{k}.{n}"] = t.double().numpy()

    state = tt.init_state(variables=trainers["v"])
    m, grads = _port_grads(tt, state, trainers["synth"], trainers["real"])
    _, exact = _port_grads(tt, _float64(tt, trainers["v"]), trainers["synth"],
                           trainers["real"])
    assert set(m) == set(ref_m)
    for k in m:
        np.testing.assert_allclose(m[k], ref_m[k], rtol=1e-5, err_msg=k)
    assert set(grads) == set(ref_g) and len(grads) == 2 * 2 * (3 + 4 + 3) + 20
    noise = []
    for name, g in grads.items():
        assert np.isfinite(g).all(), name
        if _rel(g, ref_g[name]) <= 1e-3:
            continue
        noise.append(name)
        scale = np.linalg.norm(exact[name.replace(".bias", ".weight")])
        assert name.endswith(".bias"), name
        assert np.linalg.norm(exact[name]) <= 1e-12 * scale, name
        assert np.linalg.norm(g) <= 1e-6 * scale, name
        assert np.linalg.norm(ref_g[name]) <= 1e-6 * scale, name
    # every bias before an instance norm, and no other tensor
    n_in = 2 * (3 + 2 * BLOCKS + 2) + 2 * 3     # stem, downs, blocks, ups; c1-c3
    assert len(noise) <= n_in, noise


def _carry(tt, js):
    """The port's state from a JAX state: the four nets' weights, both
    Adams' moments and counts, the step count."""
    state = tt.init_state(variables={"g_params": _np(js.g_params),
                                     "d_params": _np(js.d_params)})
    for opt, jopt, conv, nets in (
            (state.g_opt, js.g_opt, W.generator_state_dict_from_jax,
             ("G_A", "G_B")),
            (state.d_opt, js.d_opt, W.discriminator_state_dict_from_jax,
             ("D_A", "D_B"))):
        adam = jopt[0]
        if int(adam.count) == 0:
            continue
        for k in nets:
            mu, nu = (conv({"params": _np(t[k])}) for t in (adam.mu, adam.nu))
            for n, p in getattr(state, k).named_parameters():
                opt.state[p] = {"step": torch.tensor(float(adam.count)),
                                "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    state.step = int(js.step)
    return state


def test_three_steps_match_jax(trainers):
    """Three steps of ``train_step_fn`` against JAX's jitted step, each
    from JAX's state before it (weights, Adam moments and counts carried):
    every metric of each step within 1e-5 relative (measured up to 9e-7),
    and each update is optax's ``adam(2e-4, b1=0.5)`` of the port's own
    gradients, ``p - lr m^/(sqrt(v^) + 1e-8)`` from the carried moments,
    to float32 rounding.  (Run freely instead, the two trajectories part:
    Adam's first update is lr * sign(g) per element, and a gradient
    element near zero takes either sign in float32.  On this batch one
    element of G_B's last transposed conv flips on the port's side and
    not on JAX's, 4e-4 apart, and the second step's losses then lie up to
    9.4e-4 from the port's float64 run (JAX's 1e-5), the third's up to
    2.7e-2 (JAX's 1.7e-3); the port runs three free steps below.)  The
    state counts its steps, and D keeps no gradient from the G step."""
    jt, tt = trainers["jt"], trainers["tt"]
    js = jt.init_state(jax.random.PRNGKey(0), (B, 1, S, S))
    jstep, step = jt.train_step_fn(), tt.train_step_fn()
    synth, real = trainers["synth"], trainers["real"]
    lr, (b1, b2) = tt.lr, (0.5, 0.999)
    for i in range(3):
        state = _carry(tt, js)
        count = int(js.g_opt[0].count)
        _, grads = _port_grads(tt, state, synth, real)
        moments = lambda st: (0, 0) if st is None else tuple(
            st[m].double().numpy().copy() for m in ("exp_avg", "exp_avg_sq"))
        before = {f"{k}.{n}": (p.detach().double().numpy().copy(), moments(
                      getattr(state, "g_opt" if k[0] == "G"
                              else "d_opt").state.get(p)))
                  for k in ("G_A", "G_B", "D_A", "D_B")
                  for n, p in getattr(state, k).named_parameters()}
        state, m = step(state, synth, real)
        js, jm = jstep(js, jnp.asarray(synth), jnp.asarray(real))
        assert set(m) == set(jm) == {"adv_A", "adv_B", "cycle", "identity",
                                     "consis", "g_loss", "d_loss"}
        assert all(t.dim() == 0 for t in m.values())
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i}: {k}")
        t = count + 1
        for name, p in ((f"{k}.{n}", p) for k in ("G_A", "G_B", "D_A", "D_B")
                        for n, p in getattr(state, k).named_parameters()):
            p0, (mu0, nu0) = before[name]
            g = grads[name]
            mu = (1 - b1) * g + b1 * mu0
            nu = (1 - b2) * g * g + b2 * nu0
            expected = p0 - lr * (mu / (1 - b1 ** t)) / (
                np.sqrt(nu / (1 - b2 ** t)) + 1e-8)
            np.testing.assert_allclose(
                p.detach().double().numpy(), expected, rtol=0,
                atol=1e-6 * np.abs(p0).max() + 1e-9, err_msg=name)
    assert state.step == 3 and int(js.step) == 3

    state = tt.init_state(variables=trainers["v"])
    for _ in range(3):
        state, m = step(state, synth, real)
        assert all(np.isfinite(float(v)) for v in m.values())
    assert state.step == 3
    assert all(p.grad is not None for p in state.discriminators())
    assert all(p.grad is None for p in state.generators())


def test_export_round_trip(trainers, tmp_path):
    """The port's ``transfer_G_A.npz`` (after a step), read by JAX's
    ``pipelines.load_variables_npz`` into its ``ResnetGenerator.apply``,
    equals the port's G_A within 1e-5; ``load_transfer_net`` reads it back
    bitwise, frozen; the port's ``load_variables_npz`` gives JAX's tree."""
    tt = trainers["tt"]
    state = tt.init_state(variables=trainers["v"])
    state, _ = tt.train_step_fn()(state, trainers["synth"], trainers["real"])
    path = TPipe.save_variables_npz(str(tmp_path / "transfer_G_A.npz"),
                                    tt.export_transfer_variables(state))
    jv = JPipe.load_variables_npz(path)
    x = _images(7)
    ref = np.asarray(JC.ResnetGenerator(ngf=NGF, n_blocks=BLOCKS).apply(
        jv, jnp.asarray(x)))
    with torch.no_grad():
        got = state.G_A(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    gen = load_transfer_net(path, "cpu")
    assert not gen.training and not any(p.requires_grad
                                        for p in gen.parameters())
    for (n, p), q in zip(state.G_A.state_dict().items(),
                         gen.state_dict().values()):
        assert torch.equal(p, q), n
    ours = TPipe.load_variables_npz(path)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, ours, jv))


def test_compute_dtype_and_state_checks(trainers, fake_root, tmp_path):
    """A bfloat16 CycleGAN raises naming its ROADMAP item; an image shape
    the generators cannot take raises; the CCSSL pipeline, once a stub,
    runs on the CPU (B=4, 64^2, one epoch of two steps: labels and a
    checkpoint); a seeded init draws the JAX inits' shapes, and two
    draws from one seed agree."""
    with pytest.raises(NotImplementedError, match="Queue 1, item 1"):
        CycleGANTrainer(compute_dtype=torch.bfloat16, device="cpu")
    tt = CycleGANTrainer(ngf=NGF, n_blocks=BLOCKS, device="cpu")
    with pytest.raises(ValueError, match="multiples of 4"):
        tt.init_state(img_shape=(1, 1, 66, 64))
    d, npz = fake_root
    run_dir, st = TPipe.run_ccssl(
        Config(dataset="nyu", batch_size=4, input_size=S,
               root_dir=str(d / "data"), mano_model_path=npz,
               save_dir=str(tmp_path / "ckpt")), epochs=1, device="cpu")
    assert st.step == 2 and os.path.exists(
        os.path.join(run_dir, "pseudo", "joint_uvd.txt"))
    assert os.path.exists(os.path.join(run_dir, "latest", "state.pt"))
    a, b = (tt.init_state(torch.Generator().manual_seed(3)) for _ in range(2))
    ref = W.discriminator_state_dict_from_jax(
        {"params": trainers["v"]["d_params"]["D_A"]})
    for (n, p), q in zip(a.D_A.state_dict().items(), b.D_A.state_dict().values()):
        assert torch.equal(p, q) and p.shape == ref[n].shape, n
        if n.endswith("weight"):
            np.testing.assert_allclose(p.std(), ref[n].std(), rtol=0.1)


# ------------------------------------------------------ the pipelines

@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    d = tmp_path_factory.mktemp("cyclegan")
    npz = synthetic.save_synthetic_mano(str(d / "mano_synthetic.npz"))
    make_fake_nyu(str(d / "data"), npz, n_train=8, n_test=8, seed=7)
    return d, npz


def test_run_cyclegan_and_subcommand(fake_root, tmp_path):
    """``run_cyclegan`` on a fake NYU root (B=4, 64^2, 2 steps) exports a
    generator that JAX's ``load_variables_npz`` reads and the port's
    trainer takes as its transfer net (one FinetuneStage-shaped forward,
    finite); the ``cyclegan`` subcommand writes the same file."""
    from dsf_tpu_torch.training import __main__ as cli
    from dsf_tpu_torch.training.trainer import Trainer
    d, npz = fake_root
    cfg = Config(dataset="nyu", batch_size=4, input_size=S, stage_num=2,
                 root_dir=str(d / "data"), mano_model_path=npz,
                 save_dir=str(tmp_path / "ckpt"))
    out, state = TPipe.run_cyclegan(cfg, steps=2, log_every=1, device="cpu")
    assert out.endswith(os.path.join("nyu", "cyclegan_" + cfg.run_name(),
                                     "transfer_G_A.npz"))
    assert state.step == 2 and "params" in JPipe.load_variables_npz(out)
    tr = Trainer(cfg.replace(transferNet_pth=out), npz, device="cpu")
    img = tr.transfer(torch.zeros(2, 1, S, S))
    assert img.shape == (2, 1, S, S) and torch.isfinite(img).all()
    orig, seen = TPipe.run_cyclegan, []
    with pytest.MonkeyPatch.context() as mp:
        # the subcommand's own call, on the CPU for one step
        mp.setattr(TPipe, "run_cyclegan", lambda c: seen.append(c) or orig(
            c, steps=1, device="cpu"))
        cli.main(["cyclegan", "--root_dir", str(d / "data"),
                  "--mano_model_path", npz, "--save_dir",
                  str(tmp_path / "cli"), "--batch_size", "4",
                  "--input_size", str(S)])
    assert seen == [cfg.replace(save_dir=str(tmp_path / "cli"))]
    assert os.path.exists(os.path.join(tmp_path, "cli", "nyu",
                                       "cyclegan_" + cfg.run_name(),
                                       "transfer_G_A.npz"))


def test_selfsup_gpu_plumbing(fake_root, tmp_path):
    """scripts/selfsup_gpu.py's protocol on the CPU at 64^2, B=2: a
    Pretrain step, a control step and a FinetuneStage step fed by the
    loader, three evaluations over the test split's view 0, and the JSON
    with selfsup_tpu.py's keys."""
    import json
    spec = importlib.util.spec_from_file_location(
        "selfsup_gpu", os.path.join(ROOT, "scripts", "selfsup_gpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    d, _ = fake_root
    out = str(tmp_path / "selfsup.json")
    summary = mod.run(pretrain_steps=1, steps=1, seed=1, out_path=out,
                      data_root=str(d / "data"), device="cpu", batch=2,
                      size=S)
    with open(out) as f:
        saved = json.load(f)
    assert saved == summary
    for k in ("K1_pretrain", "K2", "seed", "pretrain_fps", "selfsup_fps",
              "e_pretrain", "e_control", "e_selfsup", "ok"):
        assert k in saved, k
    for k in ("e_pretrain", "e_control", "e_selfsup"):
        assert set(saved[k]) == {"pixel_mm_s1", "mano_mm_s1", "pixel_mm_s2",
                                 "mano_mm_s2"}
        assert all(np.isfinite(v) for v in saved[k].values()), saved[k]
    assert saved["K1_pretrain"] == 1 and saved["seed"] == 1
    assert saved["nvidia_smi"] is None and saved["device"] == "cpu"
