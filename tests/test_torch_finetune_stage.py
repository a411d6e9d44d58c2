"""Port parity for the FinetuneStage phase: the port's
``Trainer.train_step_fn("FinetuneStage")`` against the JAX package's
``phases.finetune_stage_loss`` and its optimizer, from the same weights,
batch statistics, synth sample, real batch and draws.  Two-stage
ManoOCRStage (ResNet-18), 64x64 crops, B=2, synthetic MANO, the NYU
camera; the real batch is ``demo.real_batch`` (rendered hands).

Two comparisons come from one port step:

* the loss tail: both ``finetune_stage_loss``s on the same net outputs
  (the port's, recorded in its step; the JAX side gets them through its
  ``apply2_fn``).  This holds everything after the net: the synth and
  distillation terms, the real-image prep, the loss render, collision,
  m2d, the ICP family, P2M and M2P.  The loss and the metrics to 1e-5
  relative, the gradient with respect to the outputs to 1e-4;
* the whole step: the JAX loss differentiated through the JAX net (its
  ``value_and_grad`` written as the chain rule, the net's VJP applied to
  the tail's gradient at the JAX net's own outputs, so the tail compiles
  once) and its optimizer, at test_torch_train_step.py's tolerances for
  its reasons: at random weights the trunks' gradients are ill-conditioned.
"""

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
from dsf_tpu.render import renderer as JR
from dsf_tpu.training import phases as JP
from dsf_tpu.training import trainer as JT
from dsf_tpu_torch import demo
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.data.synth_params import random_param_source
from dsf_tpu_torch.models.weights import (random_reference_state_dict,
                                          state_dict_from_jax)
from dsf_tpu_torch.training import phases as TP
from dsf_tpu_torch.training.trainer import Trainer
from torch_parity import eval_after_step, jax_finetune_stage_draws

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S, B = 64, 2
HEADS = ("mano_regress", "finals_s2")
BATCH_KEYS = ("img", "center", "cube", "M", "xyz_gt")


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    variables = jax.tree_util.tree_map(np.array, TI.convert_mano_ocr_stage(
        random_reference_state_dict(np.random.RandomState(0)), refine=True))
    para, cube = next(random_param_source(B, seed=0))
    key = jax.random.PRNGKey(0)
    jr = JR.Renderer.create(JM.load_model(path), "nyu", PARAS, (640, 480),
                            (S, S))
    draws = jax_finetune_stage_draws(key, B, jr.depth_range, S)

    # ---- the port's step, recording the net's outputs and their gradient
    cfg = Config(dataset="nyu", batch_size=B, stage_num=2, input_size=S)
    tr = Trainer(cfg, path, steps_per_epoch=10, device="cpu")
    real = demo.real_batch(tr.renderer, B, np.random.RandomState(1))
    synth = TP.finetune_stage_sample(tr.renderer, draws,
                                     torch.from_numpy(para),
                                     torch.from_numpy(cube))
    state = tr.init_state(variables)
    recorded = []

    def keep(module, inputs, out):
        # clones: the tail's gradient alone (stage 1's outputs also feed
        # stage 2 inside the net)
        out = [[t.clone() for t in o] for o in out]
        for o in out:
            for t in o:
                t.retain_grad()
        recorded.append(out)
        return out

    head_in = []
    hooks = [state.net.register_forward_hook(keep),
             state.net.mano_regress[2].register_forward_hook(
                 lambda m, inputs, o: head_in.append(inputs[0].detach()))]
    state, metrics = tr.train_step_fn("FinetuneStage")(
        state, draws, dict(real, model_para=para, cube_synth=cube))
    for h in hooks:
        h.remove()
    net = state.net
    (out,) = recorded
    # the stage-1 MANO head's gradient from the losses alone (its output's
    # gradient from the tail); the rest reaches it through the stage-2
    # remap render and the stage-2 trunk
    g_para = out[0][1].grad
    tail_only = {"mano_regress.2.weight": g_para.T @ head_in[0],
                 "mano_regress.2.bias": g_para.sum(0)}
    port = dict(
        tail_only={n: t.numpy() for n, t in tail_only.items()},
        metrics={k: float(v) for k, v in metrics.items()},
        outputs=[[t.detach().numpy().copy() for t in o] for o in out],
        out_grads=[[t.grad.numpy().copy() for t in o] for o in out],
        grads={n: p.grad.numpy().copy() for n, p in net.named_parameters()},
        params={n: p.detach().numpy().copy() for n, p in net.named_parameters()},
        buffers={n: b.numpy().copy() for n, b in net.named_buffers()
                 if "running" in n},
        state=state)

    # ---- the JAX phase on the same synth sample and real batch
    jcfg = JConfig(dataset="nyu", batch_size=B, stage_num=2, input_size=S)
    jnet = JManoOCRStage(joint_num=21, depth=18, refine=True, bn_groups=2)
    fixed = tuple(jnp.asarray(x.numpy()) for x in synth)
    jreal = [jnp.asarray(real[k].numpy()) for k in BATCH_KEYS]
    stacked = jnp.concatenate([fixed[0], jreal[0]])
    centers = jnp.concatenate([fixed[5], jreal[1]])
    cubes = jnp.concatenate([fixed[6], jreal[2]])

    def tail(outs):
        def apply2_fn(v, img, rend, center, cube_, train, mutable=False):
            return outs, {}

        return JP.finetune_stage_loss(
            None, {}, key, jnp.asarray(para), jnp.asarray(cube), *jreal[:3],
            jreal[3], jreal[4], r=jr, transfer_fn=None, cfg=jcfg,
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
    # one program: optax's update op by op compiles each op on its own
    new_params = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, variables["params"])
    sd_grads = state_dict_from_jax({"params": grads,
                                    "batch_stats": variables["batch_stats"]})
    sd_after = state_dict_from_jax({"params": new_params,
                                    "batch_stats": new_state["batch_stats"]})
    ref = dict(
        tail_metrics=dict({k: float(v) for k, v in t_metrics.items()},
                          loss=float(t_loss)),
        tail_grads=[[np.asarray(t) for t in o] for o in t_grads],
        metrics=dict({k: float(v) for k, v in jmetrics.items()},
                     loss=float(loss)),
        grads={n: sd_grads[n].numpy() for n in port["grads"]},
        params={n: sd_after[n].numpy() for n in port["params"]},
        buffers={n: sd_after[n].numpy() for n in port["buffers"]},
        variables=variables,
        after={"params": new_params, "batch_stats": new_state["batch_stats"]},
        trainer=tr, path=path, jcfg=jcfg)
    return port, ref


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def test_loss_tail_matches_jax(step):
    """Same net outputs on both sides: the loss and every metric to 1e-5
    relative (float32 sums in other orders; the loss render, the clouds,
    the part labels and the nearest faces come out the same), and the
    gradient with respect to each output tensor to 1e-4 in relative L2
    (the raster and codec backward sum in other orders)."""
    port, ref = step
    pm, rm = port["metrics"], ref["tail_metrics"]
    assert set(pm) == set(rm)
    assert np.isfinite(pm["loss"]) and pm["loss"] > 0
    assert pm["d2m_0"] > 0 and pm["pd2m_1"] > 0 and pm["m2d_0"] > 0
    for k in pm:
        np.testing.assert_allclose(pm[k], rm[k], rtol=1e-5, atol=1e-12,
                                   err_msg=k)
    for stage in range(2):
        for i, name in enumerate(("img_result", "mano_para")):
            g, r = port["out_grads"][stage][i], ref["tail_grads"][stage][i]
            assert np.abs(r).max() > 0, (stage, name)
            assert _rel(g, r) <= 1e-4, (stage, name, _rel(g, r))


def test_loss_and_metrics_match_jax(step):
    """The whole step's loss to 2e-5 relative, as the Pretrain step's; the
    mm errors of stage 1 to 1e-3 mm and of stage 2 (which re-renders the
    stage-1 MANO inside the forward) to 1e-2 mm.  The other metrics are
    the tail's on outputs that differ by the two nets' float32 rounding
    (~1e-5 relative): 1e-3 relative."""
    port, ref = step
    pm, rm = port["metrics"], ref["metrics"]
    assert set(pm) == set(rm)
    np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=2e-5)
    for k in pm:
        if "error" in k:
            atol = 1e-3 if k.endswith("_0") else 1e-2
            np.testing.assert_allclose(pm[k], rm[k], rtol=0, atol=atol,
                                       err_msg=k)
        elif k != "loss":
            np.testing.assert_allclose(pm[k], rm[k], rtol=1e-3, atol=1e-9,
                                       err_msg=k)


def test_gradients_match_jax(step):
    """Every parameter's gradient in relative L2: the heads that feed the
    losses only to 2e-3, every layer behind a BatchNorm trunk to 0.15
    (test_torch_train_step.py gives the reason and the measurement).  The
    stage-1 MANO head feeds the losses and, through the stage-2 remap
    render, the stage-2 trunk: the share of its gradient that comes that
    way (``share``, measured on the port's step) is held at the trunks'
    0.15 and the rest at 2e-3."""
    port, ref = step
    for name, g in port["grads"].items():
        r = ref["grads"][name]
        assert g.shape == r.shape and np.isfinite(g).all(), name
        assert np.abs(r).max() > 0, name
        tol = 2e-3 if name.startswith(HEADS) else 0.15
        if name in port["tail_only"]:
            share = _rel(port["tail_only"][name], g)
            assert 0 < share < 0.2, (name, share)
            tol = 2e-3 + 0.15 * share
        assert _rel(g, r) <= tol, (name, _rel(g, r), tol)


def test_updated_params_match_jax(step):
    """One AdamW update from zero moments: the parameters differ from JAX's
    by exactly what the gradient difference explains, to float32 rounding
    of the parameter (as in test_torch_train_step.py)."""
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


def test_grouped_batch_stats_match_jax(step):
    """The BatchNorm running statistics after the stacked [synth | real]
    forward: two EMA updates per layer, synth first, from per-half
    statistics.  Held as in test_torch_train_step.py: 5e-5 of each
    tensor's largest entry for stage 1, 2e-4 for stage 2."""
    port, ref = step
    assert len(port["buffers"]) == len(ref["buffers"]) == 2 * 47
    before = state_dict_from_jax(ref["variables"])
    for name, b in port["buffers"].items():
        r = ref["buffers"][name]
        assert not np.array_equal(r, before[name].numpy()), name
        stage2 = "_s2" in name or name.startswith("fusion")
        tol = (2e-4 if stage2 else 5e-5) * np.abs(r).max()
        np.testing.assert_allclose(b, r, rtol=0, atol=tol, err_msg=name)


def test_m2p_gate_and_masked_sl1_match_jax():
    """The M2P gate and the masked SmoothL1 with a gate that passes some
    samples and joints (at the step's random weights no sample passes, so
    M2P is 0 there): the gate equal, the loss to 1e-6 relative and its
    gradient to 1e-6 of its largest entry."""
    rng = np.random.RandomState(5)
    n = 4
    crop = np.where(rng.rand(n, 1, 16, 16) < 0.3, 1.0,
                    rng.uniform(-0.2, 0.2, (n, 1, 16, 16))).astype(np.float32)
    mano = (crop + rng.randn(n, 1, 16, 16) * np.array(
        [0.001, 0.2, 0.001, 0.001])[:, None, None, None]).astype(np.float32)
    d2m = np.array([1e-4, 1e-4, 5e-3, 2e-4], np.float32)
    pd2m = rng.uniform(0, 2e-3, (n, 15)).astype(np.float32)
    a = rng.randn(n, 21, 3).astype(np.float32) * 0.02
    b = rng.randn(n, 21, 3).astype(np.float32) * 0.02
    gate = TP._m2p_mask(*(torch.from_numpy(x) for x in (crop, mano, d2m, pd2m)))
    gate_j = np.asarray(JP._m2p_mask(*(jnp.asarray(x)
                                       for x in (crop, mano, d2m, pd2m))))
    assert np.array_equal(gate.numpy(), gate_j)
    assert 0 < gate_j.sum() < gate_j.size and not gate_j[1].any()
    at = torch.from_numpy(a).requires_grad_(True)
    loss = TP._masked_select_sl1(at, torch.from_numpy(b), gate)
    loss.backward()
    loss_j, g_j = jax.value_and_grad(
        lambda x: JP._masked_select_sl1(x, jnp.asarray(b), gate_j))(
        jnp.asarray(a))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(at.grad.numpy(), g_j, rtol=0,
                               atol=1e-6 * np.abs(g_j).max())


def test_eval_after_step_matches_jax(step):
    """Eval mode after the FinetuneStage step (Queue 3 item 3), as
    test_torch_train_step.py's after Pretrain (``eval_after_step``): on
    the same weights JAX's eval gives the port's errors within the eval
    tolerances, and one float64 evaluator reproduces each side's own
    errors, so the gap between the two sides' own weights is the weights'
    (measured 1.88 mm at stage 1 and 7.76 mm at stage 2 after this one
    step; JAX on the port's weights within 2.4e-4 mm)."""
    port, ref = step
    tr = ref["trainer"]
    jtr = JT.Trainer(ref["jcfg"], ref["path"], steps_per_epoch=10)
    batch = {k: np.asarray(v) for k, v in demo.real_batch(
        tr.renderer, B, np.random.RandomState(3)).items()}
    eval_after_step(port["state"], tr, ref["after"], jtr, batch,
                    "FinetuneStage, one step")
