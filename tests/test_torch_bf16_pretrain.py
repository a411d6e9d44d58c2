"""Port parity for one Pretrain step in the bfloat16 compute dtype: the
port's ``Trainer.train_step_fn("Pretrain")`` with
``Config(compute_dtype="bfloat16")`` against the JAX package's
``phases.pretrain_loss`` with ``ManoOCRStage(dtype=bfloat16)`` under
``jax.value_and_grad`` and its optimizer, from the same weights, batch
statistics and synth sample (test_torch_train_step.py's set-up: two-stage
ResNet-18, 64x64 crops, B=2, synthetic MANO, the port's synth image fed
to both).

The witness is the port's float64 loss on the same weights and sample
(the float32 net in float64): bfloat16 rounds every activation to 8
significant bits, and at these random weights the trunks' gradients are
ill-conditioned (test_torch_train_step.py), so the two bfloat16 runs are
each held against float64, the port within a multiple of JAX's own
distance.  The parameters, the optimizer's moments, the losses and the
renders stay float32 on both sides.
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
from dsf_tpu_torch.models.layers import set_compute_dtype
from dsf_tpu_torch.models.weights import (random_reference_state_dict,
                                          state_dict_from_jax)
from dsf_tpu_torch.training import phases as TP
from dsf_tpu_torch.training.trainer import Trainer
from torch_parity import (check_batch_stats, check_gradients,
                          float64_renderer, jax_pretrain_draws)

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S, B = 64, 2


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
    draws = jax_pretrain_draws(key, B, jr.depth_range)

    # the port's bfloat16 step
    cfg = Config(dataset="nyu", batch_size=B, stage_num=2, input_size=S,
                 compute_dtype="bfloat16")
    tr = Trainer(cfg, path, steps_per_epoch=10, device="cpu")
    synth = TP.pretrain_sample(tr.renderer, draws, torch.from_numpy(para),
                               torch.from_numpy(cube))
    state = tr.init_state(variables)
    net64 = copy.deepcopy(state.net)
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

    # the witness: the same loss in float64 (the float32 net, doubled)
    set_compute_dtype(net64, torch.float32)
    net64.double().train()
    loss64, m64 = TP.pretrain_loss(net64, float64_renderer(tr.renderer),
                                   [x.double() for x in synth], cfg, 2)
    loss64.backward()
    exact = dict(
        metrics=dict({k: float(v) for k, v in m64.items()},
                     loss=float(loss64)),
        grads={n: p.grad.numpy() for n, p in net64.named_parameters()},
        buffers={n: b.numpy() for n, b in net64.named_buffers()
                 if "running" in n})

    # the JAX step in bfloat16 on the same synth sample
    jcfg = JConfig(dataset="nyu", batch_size=B, stage_num=2, input_size=S,
                   compute_dtype="bfloat16")
    jnet = JManoOCRStage(joint_num=21, depth=18, refine=True,
                         dtype=jnp.bfloat16)
    fixed = tuple(jnp.asarray(x.numpy()) for x in synth)

    def apply_fn(v, img, rend, center, cube_, train, mutable=False):
        return jnet.apply(v, img, rend, center, cube_, train=train,
                          mutable=mutable)

    def loss_fn(params, batch_stats):
        return JP.pretrain_loss(
            apply_fn, {"params": params, "batch_stats": batch_stats}, key,
            jnp.asarray(para), jnp.asarray(cube), r=jr, transfer_fn=None,
            cfg=jcfg, stage_num=2)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "synth_sample", lambda *a, **k: fixed)
        (loss, (new_state, jmetrics)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"], variables["batch_stats"])
    tx = JT.make_optimizer(jcfg, 10)
    new_params = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, variables["params"])
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
        variables=variables)
    return port, ref, exact


def test_loss_and_metrics_within_jax_distance_of_float64(step):
    """The loss and every metric, each side's distance from float64: the
    port's within 2x JAX's + 2e-3 of the float64 value (+ 1e-6 for the
    zero scale loss), and JAX's within 5% of it (measured in the printed
    line)."""
    port, ref, exact = step
    assert set(port["metrics"]) == set(ref["metrics"]) == set(exact["metrics"])
    rows = {}
    for k, e in exact["metrics"].items():
        p, j = port["metrics"][k], ref["metrics"][k]
        rows[k] = (abs(p - e), abs(j - e), e)
        assert np.isfinite(p)
        assert abs(j - e) <= 0.05 * abs(e) + 1e-6, (k, p, j, e)
        assert abs(p - e) <= 2 * abs(j - e) + 2e-3 * abs(e) + 1e-6, (k, p, j, e)
    print("Pretrain bf16 metric |port - f64|, |JAX - f64|, f64: "
          + ", ".join(f"{k} {a:.3g} {b:.3g} {c:.4g}" for k, (a, b, c)
                      in rows.items()))


def test_gradients_within_jax_distance_of_float64(step):
    """``torch_parity.check_gradients`` (its docstring gives the
    tolerances; the numbers there were measured on this step)."""
    check_gradients(*step, "Pretrain")


def test_updated_params_match_jax(step):
    """One AdamW update from zero moments on float32 parameters: the
    updated parameters differ from JAX's by exactly what the gradient
    difference explains, to float32 rounding of the parameter (as in
    test_torch_train_step.py): same learning rate, decay and moments."""
    port, ref, _ = step
    lr = 1e-3
    u = lambda g: g.astype(np.float64) / (np.abs(g.astype(np.float64)) + 1e-8)
    for name, p in port["params"].items():
        r = ref["params"][name]
        assert p.dtype == np.float32, name
        expected = -lr * (u(port["grads"][name]) - u(ref["grads"][name]))
        np.testing.assert_allclose(p - r.astype(np.float64), expected, rtol=0,
                                   atol=1e-6 * np.abs(r).max() + 2e-7,
                                   err_msg=name)
    assert port["state"].updates == 1


def test_batch_stats_within_jax_distance_of_float64(step):
    """``torch_parity.check_batch_stats``."""
    port, ref, exact = step
    assert len(port["buffers"]) == 2 * 47
    check_batch_stats(port, ref, exact, "Pretrain")
