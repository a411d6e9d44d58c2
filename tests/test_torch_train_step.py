"""Port parity for one whole Pretrain step: the port's
``Trainer.train_step_fn("Pretrain")`` against the JAX package's
``phases.pretrain_loss`` under ``jax.value_and_grad`` followed by its
optimizer (``trainer.make_optimizer``: optax AdamW behind the finite
guard), from the same weights, batch statistics, batch and draws.
Two-stage ManoOCRStage (ResNet-18), 64x64 crops, B=2, synthetic MANO.

The JAX side is given the port's synth sample (the image and labels the
port's step renders from the same draws).  The synth factory itself is
held against the JAX one in test_torch_train_render.py; here one image
keeps the comparison about the net, the losses and their gradients.  It
has to: at these random weights the gradient is ill-conditioned in the
input.  The JAX package's own jitted and eager runs of this loss on the
same key render images that differ by ~1e-4 on a few dozen pixels, and
their parameter gradients then differ by up to 81% (median 59%, measured
at this input by `python tests/torch_parity.py`).  On one image the same
two runs differ by up to 4.6%, and the port lies 6.4% from the jitted run.
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
from dsf_tpu.models import torch_import as TI
from dsf_tpu.models.backbone import ManoOCRStage as JManoOCRStage
from dsf_tpu.render import renderer as JR
from dsf_tpu.training import phases as JP
from dsf_tpu.training import trainer as JT
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.data.synth_params import random_param_source
from dsf_tpu_torch.models.weights import (load_into,
                                          random_reference_state_dict,
                                          state_dict_from_jax)
from dsf_tpu_torch.training import phases as TP
from dsf_tpu_torch.training.trainer import Trainer
from torch_parity import eval_after_step, jax_pretrain_draws

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S, B = 64, 2
# layers whose output reaches only the losses (not another BatchNorm):
# their gradients are the losses' output gradients times the activations
HEADS = ("mano_regress", "finals_s2")


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    variables = jax.tree_util.tree_map(np.array, TI.convert_mano_ocr_stage(
        random_reference_state_dict(np.random.RandomState(0)), refine=True))
    para, cube = next(random_param_source(B, seed=0))
    key = jax.random.PRNGKey(0)
    jr = JR.Renderer.create(JM.load_model(path), "nyu", PARAS, (640, 480), (S, S))
    draws = jax_pretrain_draws(key, B, jr.depth_range)

    # the port's step
    cfg = Config(dataset="nyu", batch_size=B, stage_num=2, input_size=S)
    tr = Trainer(cfg, path, steps_per_epoch=10, device="cpu")
    synth = TP.pretrain_sample(tr.renderer, draws, torch.from_numpy(para),
                               torch.from_numpy(cube))
    state = tr.init_state(variables)
    state, metrics = tr.train_step_fn("Pretrain")(
        state, draws, {"model_para": para, "cube_synth": cube})
    net = state.net
    port = dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: p.grad.numpy().copy() for n, p in net.named_parameters()},
        params={n: p.detach().numpy().copy() for n, p in net.named_parameters()},
        buffers={n: b.numpy().copy() for n, b in net.named_buffers()
                 if "running" in n},
        state=state)

    # the JAX step on the same synth sample
    jcfg = JConfig(dataset="nyu", batch_size=B, stage_num=2, input_size=S)
    jnet = JManoOCRStage(joint_num=21, depth=18, refine=True)
    fixed = tuple(jnp.asarray(x.numpy()) for x in synth)

    def apply_fn(v, img, rend, center, cube_, train, mutable=False):
        return jnet.apply(v, img, rend, center, cube_, train=train,
                          mutable=mutable)

    def loss_fn(params, batch_stats, key, sample):
        # the synth factory's output is the given sample (an argument, so
        # the jitted loss takes the next step's)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JR, "synth_sample", lambda *a, **k: sample)
            return JP.pretrain_loss(
                apply_fn, {"params": params, "batch_stats": batch_stats},
                key, jnp.asarray(para), jnp.asarray(cube), r=jr,
                transfer_fn=None, cfg=jcfg, stage_num=2)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, (new_state, jmetrics)), grads = value_and_grad(
        variables["params"], variables["batch_stats"], key, fixed)
    tx = JT.make_optimizer(jcfg, 10)
    updates, opt_state = tx.update(grads, tx.init(variables["params"]),
                                   variables["params"])
    new_params = optax.apply_updates(variables["params"], updates)
    sd_grads = state_dict_from_jax({"params": grads,
                                    "batch_stats": variables["batch_stats"]})
    sd_after = state_dict_from_jax({"params": new_params,
                                    "batch_stats": new_state["batch_stats"]})
    ref = dict(
        metrics=dict({k: float(v) for k, v in jmetrics.items()},
                     loss=float(loss)),
        grads={n: sd_grads[n].numpy() for n in port["grads"]},
        params={n: sd_after[n].numpy() for n in port["params"]},
        buffers={n: sd_after[n].numpy() for n in port["buffers"]},
        variables=variables,
        # for a second step and the eval after each
        after={"params": new_params, "batch_stats": new_state["batch_stats"]},
        opt_state=opt_state, tx=tx, value_and_grad=value_and_grad,
        trainer=tr, path=path, jcfg=jcfg, jr=jr)
    return port, ref


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def test_loss_and_metrics_match_jax(step):
    """The loss to 2e-5 relative (float32 sums of ~10^4 terms in two
    orders); the stage-1 mm errors to 1e-3 mm; stage 2 re-renders the
    stage-1 MANO inside the forward, and its mm errors to 1e-2 mm."""
    port, ref = step
    pm, rm = port["metrics"], ref["metrics"]
    assert set(pm) == set(rm)
    assert np.isfinite(pm["loss"]) and pm["loss"] > 0
    np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=2e-5)
    for k in pm:
        if k == "loss":
            continue
        atol = 1e-3 if k.endswith("_0") else 1e-2
        np.testing.assert_allclose(pm[k], rm[k], rtol=0, atol=atol, err_msg=k)


def test_gradients_match_jax(step):
    """Every parameter's gradient, in relative L2 norm.  The MANO heads and
    the stage-2 offset head feed the losses only, so their gradients are
    well-conditioned: 2e-3.  Every other layer's gradient passes through
    BatchNorm trunks (the stage-1 offset head's too, through the stage-2
    fusion), where it is ill-conditioned at these random weights (see the
    module docstring): the JAX package's jitted and eager runs differ by up
    to 4.6% on one image, and the port is held to 15%, about 3x that."""
    port, ref = step
    worst = {}
    for name, g in port["grads"].items():
        r = ref["grads"][name]
        assert g.shape == r.shape and np.isfinite(g).all(), name
        assert np.abs(r).max() > 0, name
        tol = 2e-3 if name.startswith(HEADS) else 0.15
        worst[name] = _rel(g, r)
        assert worst[name] <= tol, (name, worst[name])
    assert len(worst) == len(ref["grads"])


def test_stage2_render_gradient_reaches_stage1_mano_head(step):
    """The stage-2 losses reach the stage-1 MANO head through the remap
    render (raster moments, codec encode VJP): without that path its
    gradient would be the stage-1 terms' alone.  The head's gradient
    agrees with JAX's to 2e-3, well inside the few-percent share the
    render path contributes (measured ~3%)."""
    port, ref = step
    for name in ("mano_regress.2.weight", "mano_regress.2.bias"):
        assert _rel(port["grads"][name], ref["grads"][name]) <= 2e-3, name


def test_updated_params_match_jax(step):
    """One AdamW update from zero moments: p' = p - lr (u(g) + 0.01 p) with
    u(g) = g / (|g| + 1e-8).  The updated parameters differ from JAX's by
    exactly what the gradient difference (held above) explains, lr (u(g) -
    u(g_jax)), to float32 rounding of the parameter (1e-6 relative plus
    2e-7): same learning rate, same decay, same moments."""
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


def test_batch_stats_match_jax(step):
    """The BatchNorm running statistics after the step (Flax's EMA on the
    biased batch variance), compared to the largest entry of each tensor.
    They come from the forward alone, where the two sides' activations
    differ by ~1e-5 relative (convolutions summed in other orders,
    compounding through the trunk), and a batch mean of activations that
    cancel shows that at its absolute size: 5e-5 of the tensor's largest
    entry for stage 1 and 2e-4 for stage 2 (its input is the re-rendered
    stage-1 MANO)."""
    port, ref = step
    assert len(port["buffers"]) == len(ref["buffers"]) == 2 * 47   # BatchNorms
    before = state_dict_from_jax(ref["variables"])
    for name, b in port["buffers"].items():
        r = ref["buffers"][name]
        assert not np.array_equal(r, before[name].numpy()), name
        stage2 = "_s2" in name or name.startswith("fusion")
        tol = (2e-4 if stage2 else 5e-5) * np.abs(r).max()
        np.testing.assert_allclose(b, r, rtol=0, atol=tol, err_msg=name)


def test_eval_after_steps_matches_jax(step):
    """Eval mode after one and after two Pretrain steps (Queue 3 item 3),
    from the same weights, draws and synth images, JAX's second update
    from its own first as the port's (``eval_after_step``): on the same
    weights JAX's eval gives the port's errors (measured within 5e-4 mm),
    and one float64 evaluator reproduces each side's own errors (within
    1e-3 mm), so the two sides' gap on their own weights is the weights':
    they differ by the steps' float32 gradients (held by the tests above),
    up to 2e-3 a weight after AdamW's lr * sign(g) first update, and the
    eval output at these random weights, whose running statistics are
    still far from the activations, amplifies that: stage 2 apart by up
    to 34 mm after one step and 272 mm after two.  The running
    statistics after the second step come from the first step's weights
    too (the port's own lie up to 8.7e-4 of a tensor's largest entry from
    JAX's own): the port's train-mode forward from JAX's first-step
    weights and statistics gives JAX's within the first step's tolerance
    at stage 1 (5e-5 of each tensor's largest entry; measured 7.2e-6) and
    within 1.5e-3 at stage 2 (measured 6.9e-4, where 2e-4 holds after the
    first step: stage 2's input is the re-render of stage 1's MANO
    output, discontinuous in it)."""
    from dsf_tpu_torch import demo
    port, ref = step
    tr, jr, jcfg = ref["trainer"], ref["jr"], ref["jcfg"]
    jtr = JT.Trainer(jcfg, ref["path"], steps_per_epoch=10)
    batch = {k: np.asarray(v) for k, v in demo.real_batch(
        tr.renderer, B, np.random.RandomState(3)).items()}
    state, after = port["state"], ref["after"]
    eval_after_step(state, tr, after, jtr, batch, "Pretrain, one step")

    para, cube = next(random_param_source(B, seed=1))
    draws = jax_pretrain_draws(jax.random.PRNGKey(1), B, jr.depth_range)
    synth = TP.pretrain_sample(tr.renderer, draws, torch.from_numpy(para),
                               torch.from_numpy(cube))
    state, metrics = tr.train_step_fn("Pretrain")(
        state, draws, {"model_para": para, "cube_synth": cube})
    fixed = tuple(jnp.asarray(x.numpy()) for x in synth)
    (_, (new_state, _)), grads = ref["value_and_grad"](
        after["params"], after["batch_stats"], jax.random.PRNGKey(1), fixed)
    updates, _ = ref["tx"].update(grads, ref["opt_state"], after["params"])
    after2 = {"params": optax.apply_updates(after["params"], updates),
              "batch_stats": new_state["batch_stats"]}
    assert state.updates == 2 and np.isfinite(float(metrics["loss"]))
    eval_after_step(state, tr, after2, jtr, batch, "Pretrain, two steps")
    # the second step's running statistics: the port's train-mode forward
    # from JAX's first-step weights and statistics gives JAX's
    net = copy.deepcopy(state.net)
    load_into(net, state_dict_from_jax(after))
    net.train()
    with torch.no_grad():
        TP.pretrain_loss(net, tr.renderer, synth, tr.cfg, 2)
    sd = state_dict_from_jax(after2)
    own = dict(state.net.named_buffers())
    same, gap = {False: 0.0, True: 0.0}, 0.0
    for name, b in net.named_buffers():
        if "running" in name:
            r = sd[name].numpy()
            scale = np.abs(r).max()
            stage2 = "_s2" in name or name.startswith("fusion")
            same[stage2] = max(same[stage2],
                               float(np.abs(b.numpy() - r).max() / scale))
            gap = max(gap, float(np.abs(own[name].numpy() - r).max() / scale))
    assert same[False] <= 5e-5 and same[True] <= 1.5e-3, same
    print(f"Pretrain, two steps: running statistics from the same weights, "
          f"largest difference of a tensor's largest entry: stage 1 "
          f"{same[False]:.3g}, stage 2 {same[True]:.3g}; the port's own "
          f"against JAX's own {gap:.3g}")
