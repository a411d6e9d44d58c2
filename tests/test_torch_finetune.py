"""Port parity for the one-stage Finetune phase with the frozen CycleGAN
generator: the port's ``Trainer.train_step_fn("Finetune")`` against the
JAX package's ``phases.finetune_loss`` and its optimizer, from the same
weights, batch statistics, synth sample, real batch, draws and generator.
One-stage ManoOCRStage (ResNet-18), 64x64 crops, B=2, synthetic MANO, the
NYU camera; the real batch is ``demo.real_batch`` (rendered hands).  The
generator is narrow (ngf 8, 2 blocks), JAX-initialised, and reaches the
port as the ``.npz`` the JAX package's CycleGAN pipeline exports.

As in test_torch_finetune_stage.py, two comparisons come from one port
step: the loss tail on the port's own net outputs (loss and metrics to
1e-5 relative, the outputs' gradients to 1e-4), and the whole step at the
Pretrain step's tolerances (test_torch_train_step.py gives the reason).
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dsf_tpu.config import Config as JConfig
from dsf_tpu.mano import model as JM, synthetic as JS
from dsf_tpu.mano.constants import transfer_for_dataset
from dsf_tpu.models import torch_import as TI
from dsf_tpu.models.backbone import ManoOCRStage as JManoOCRStage
from dsf_tpu.models.cyclegan import ResnetGenerator as JGenerator
from dsf_tpu.render import renderer as JR
from dsf_tpu.training import phases as JP
from dsf_tpu.training import trainer as JT
from dsf_tpu.training.pipelines import save_variables_npz
from dsf_tpu_torch import demo
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.data.synth_params import random_param_source
from dsf_tpu_torch.models.weights import (random_reference_state_dict,
                                          state_dict_from_jax)
from dsf_tpu_torch.training import phases as TP
from dsf_tpu_torch.training.trainer import Trainer
from torch_parity import jax_finetune_stage_draws

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S, B = 64, 2
HEADS = ("mano_regress", "finals")
BATCH_KEYS = ("img", "center", "cube", "M", "xyz_gt")
METRICS = {"pixel_error", "mano_error", "m2d", "pd2m", "P2M", "coll", "M2P",
           "d2m", "loss"}


@pytest.fixture(scope="module")
def mano_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    return path


@pytest.fixture(scope="module")
def step(mano_path, tmp_path_factory):
    variables = jax.tree_util.tree_map(np.array, TI.convert_mano_ocr_stage(
        random_reference_state_dict(np.random.RandomState(0), refine=False),
        refine=False))
    jgen = JGenerator(ngf=8, n_blocks=2)
    gen_vars = jgen.init(jax.random.PRNGKey(3), jnp.zeros((1, 1, S, S)))
    gen_path = str(tmp_path_factory.mktemp("gen") / "transfer_G_A.npz")
    save_variables_npz(gen_path, gen_vars)
    para, cube = next(random_param_source(B, seed=0))
    key = jax.random.PRNGKey(0)
    jr = JR.Renderer.create(JM.load_model(mano_path), "nyu", PARAS,
                            (640, 480), (S, S))
    draws = jax_finetune_stage_draws(key, B, jr.depth_range, S)

    # ---- the port's step, recording the net's outputs and their gradient
    cfg = Config(dataset="nyu", batch_size=B, stage_num=1, input_size=S,
                 transferNet_pth=gen_path)
    tr = Trainer(cfg, mano_path, steps_per_epoch=10, device="cpu")
    real = demo.real_batch(tr.renderer, B, np.random.RandomState(1))
    synth = TP.finetune_stage_sample(tr.renderer, draws,
                                     torch.from_numpy(para),
                                     torch.from_numpy(cube))
    state = tr.init_state(variables)
    with torch.no_grad():
        img_t64 = copy.deepcopy(tr.transfer_net).double()(synth[0].double())
    recorded, net_in = [], []

    def keep(module, inputs, out):
        net_in.append(inputs[0].detach().clone())
        out = [[t.clone() for t in o] for o in out]
        for o in out:
            for t in o:
                t.retain_grad()
        recorded.append(out)
        return out

    hook = state.net.register_forward_hook(keep)
    state, metrics = tr.train_step_fn("Finetune")(
        state, draws, dict(real, model_para=para, cube_synth=cube))
    hook.remove()
    net = state.net
    (out,) = recorded
    port = dict(
        metrics={k: float(v) for k, v in metrics.items()},
        img_t=net_in[0][:B].numpy(), img_t64=img_t64.numpy(),
        outputs=[[t.detach().numpy().copy() for t in o] for o in out],
        out_grads=[[t.grad.numpy().copy() for t in o] for o in out],
        grads={n: p.grad.numpy().copy() for n, p in net.named_parameters()},
        params={n: p.detach().numpy().copy() for n, p in net.named_parameters()},
        buffers={n: b.numpy().copy() for n, b in net.named_buffers()
                 if "running" in n},
        state=state)

    # ---- the JAX phase on the same synth sample, real batch and generator
    jcfg = JConfig(dataset="nyu", batch_size=B, stage_num=1, input_size=S)
    jnet = JManoOCRStage(joint_num=21, depth=18, refine=False, bn_groups=2)
    fixed = tuple(jnp.asarray(x.numpy()) for x in synth)
    jreal = [jnp.asarray(real[k].numpy()) for k in BATCH_KEYS]

    def transfer_fn(img):
        return jax.lax.stop_gradient(jgen.apply(gen_vars, img))

    img_t = jax.jit(transfer_fn)(fixed[0])
    stacked = jnp.concatenate([img_t, jreal[0]])
    centers = jnp.concatenate([fixed[5], jreal[1]])
    cubes = jnp.concatenate([fixed[6], jreal[2]])

    def tail(outs):
        def apply2_fn(v, img, rend, center, cube_, train, mutable=False):
            return outs, {}

        return JP.finetune_loss(
            None, {}, key, jnp.asarray(para), jnp.asarray(cube), *jreal[:3],
            jreal[3], jreal[4], r=jr, transfer_fn=transfer_fn, cfg=jcfg,
            transfer_map=transfer_for_dataset("nyu"), apply2_fn=apply2_fn)

    def net_fwd(params):
        return jnet.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          stacked, jr, centers, cubes, train=True,
                          mutable=["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "synth_sample", lambda *a, **k: fixed)
        tail_vg = jax.jit(jax.value_and_grad(tail, has_aux=True))
        (t_loss, (_, t_metrics)), t_grads = tail_vg(
            jax.tree_util.tree_map(jnp.asarray, port["outputs"]))
        j_out, vjp_fn, new_state = jax.jit(
            lambda p: jax.vjp(net_fwd, p, has_aux=True))(variables["params"])
        (loss, (_, jmetrics)), g_out = tail_vg(j_out)
    (grads,) = jax.jit(lambda f, g: f(g))(vjp_fn, g_out)
    tx = JT.make_optimizer(jcfg, 10)
    new_params = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, variables["params"])
    sd_grads = state_dict_from_jax({"params": grads,
                                    "batch_stats": variables["batch_stats"]})
    sd_after = state_dict_from_jax({"params": new_params,
                                    "batch_stats": new_state["batch_stats"]})
    ref = dict(
        img_t=np.asarray(img_t), img=np.asarray(fixed[0]),
        tail_metrics=dict({k: float(v) for k, v in t_metrics.items()},
                          loss=float(t_loss)),
        tail_grads=[[np.asarray(t) for t in o] for o in t_grads],
        metrics=dict({k: float(v) for k, v in jmetrics.items()},
                     loss=float(loss)),
        grads={n: sd_grads[n].numpy() for n in port["grads"]},
        params={n: sd_after[n].numpy() for n in port["params"]},
        buffers={n: sd_after[n].numpy() for n in port["buffers"]},
        variables=variables)
    return port, ref


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def test_net_input_is_the_generators_image(step):
    """The port's net saw the npz generator's image of the synth batch, not
    the raw image.  Held against the same generator in float64 (tanh
    output in [-1, 1]): the port's float32 image to 1e-5 absolute
    (measured 1.8e-6 here, up to 2.9e-6 on other weights and images), and
    the JAX generator's to 1e-4 (measured 2.4e-5: on the synth image's
    flat background its instance norms round further)."""
    port, ref = step
    img64 = port["img_t64"]
    np.testing.assert_allclose(port["img_t"], img64, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ref["img_t"], img64, rtol=0, atol=1e-4)
    assert np.abs(ref["img_t"] - ref["img"]).max() > 0.1


def test_loss_tail_matches_jax(step):
    """Same net outputs on both sides: the loss and every metric to 1e-5
    relative, and the gradient with respect to each output to 1e-4 in
    relative L2 (the raster and codec backward sum in other orders)."""
    port, ref = step
    pm, rm = port["metrics"], ref["tail_metrics"]
    assert set(pm) == set(rm) == METRICS
    assert np.isfinite(pm["loss"]) and pm["loss"] > 0
    assert pm["d2m"] > 0 and pm["pd2m"] > 0 and pm["m2d"] > 0
    for k in pm:
        np.testing.assert_allclose(pm[k], rm[k], rtol=1e-5, atol=1e-12,
                                   err_msg=k)
    for i, name in enumerate(("img_result", "mano_para")):
        g, r = port["out_grads"][0][i], ref["tail_grads"][0][i]
        assert np.abs(r).max() > 0, name
        assert _rel(g, r) <= 1e-4, (name, _rel(g, r))


def test_loss_and_metrics_match_jax(step):
    """The whole step's loss to 2e-5 relative, the mm errors to 1e-3 mm,
    the other metrics to 1e-3 relative (the tail's, on outputs that differ
    by the two nets' float32 rounding)."""
    port, ref = step
    pm, rm = port["metrics"], ref["metrics"]
    assert set(pm) == set(rm)
    np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=2e-5)
    for k in pm:
        if "error" in k:
            np.testing.assert_allclose(pm[k], rm[k], rtol=0, atol=1e-3,
                                       err_msg=k)
        elif k != "loss":
            np.testing.assert_allclose(pm[k], rm[k], rtol=1e-3, atol=1e-9,
                                       err_msg=k)


def test_gradients_match_jax(step):
    """Every parameter's gradient in relative L2: the heads, which feed
    the losses only, to 2e-3; every layer behind the BatchNorm trunk to
    0.15, as in test_torch_train_step.py."""
    port, ref = step
    for name, g in port["grads"].items():
        r = ref["grads"][name]
        assert g.shape == r.shape and np.isfinite(g).all(), name
        assert np.abs(r).max() > 0, name
        tol = 2e-3 if name.startswith(HEADS) else 0.15
        assert _rel(g, r) <= tol, (name, _rel(g, r), tol)


def test_updated_params_and_batch_stats_match_jax(step):
    """One AdamW update from zero moments: the parameters differ from JAX's
    by what the gradient difference explains, to float32 rounding; the
    running statistics (two EMA updates per layer, synth then real) to
    5e-5 of each tensor's largest entry."""
    port, ref = step
    lr = 1e-3
    u = lambda g: g.astype(np.float64) / (np.abs(g.astype(np.float64)) + 1e-8)
    for name, p in port["params"].items():
        r = ref["params"][name]
        expected = -lr * (u(port["grads"][name]) - u(ref["grads"][name]))
        np.testing.assert_allclose(p - r.astype(np.float64), expected, rtol=0,
                                   atol=1e-6 * np.abs(r).max() + 2e-7,
                                   err_msg=name)
    assert port["state"].updates == 1 and port["state"].step == 1
    assert len(port["buffers"]) == len(ref["buffers"]) == 2 * 23
    before = state_dict_from_jax(ref["variables"])
    for name, b in port["buffers"].items():
        r = ref["buffers"][name]
        assert not np.array_equal(r, before[name].numpy()), name
        np.testing.assert_allclose(b, r, rtol=0, atol=5e-5 * np.abs(r).max(),
                                   err_msg=name)


def test_one_stage_m2d_and_m2p_gate_match_jax():
    """The one-stage variants: m2d with the unmasked numerator, and the M2P
    gate at 0.95 over the intersection (an empty one fails: sample 3 has
    no foreground in the render) with a gate that passes some samples and
    joints.  m2d to 1e-6 relative, the gate equal."""
    rng = np.random.RandomState(6)
    n = 4
    crop = np.where(rng.rand(n, 1, 16, 16) < 0.3, 1.0,
                    rng.uniform(-0.2, 0.2, (n, 1, 16, 16))).astype(np.float32)
    mano = (crop + rng.randn(n, 1, 16, 16) * np.array(
        [0.001, 0.2, 0.001, 0.001])[:, None, None, None]).astype(np.float32)
    mano[3] = 1.0
    d2m = np.array([1e-4, 1e-4, 5e-3, 2e-4], np.float32)
    pd2m = rng.uniform(0, 2e-3, (n, 15)).astype(np.float32)
    args = (crop, mano, d2m, pd2m)
    gate = TP._m2p_mask(*(torch.from_numpy(x) for x in args), thresh=0.95,
                        union_denominator=False)
    gate_j = np.asarray(JP._m2p_mask(*(jnp.asarray(x) for x in args),
                                     thresh=0.95, union_denominator=False))
    assert np.array_equal(gate.numpy(), gate_j)
    assert gate_j[0].any() and not gate_j[1:].any()
    m2d = TP._m2d(torch.from_numpy(crop), torch.from_numpy(mano),
                  masked_numerator=False)
    m2d_j = JP._m2d(jnp.asarray(crop), jnp.asarray(mano),
                    masked_numerator=False)
    np.testing.assert_allclose(m2d.numpy(), np.asarray(m2d_j), rtol=1e-6)
