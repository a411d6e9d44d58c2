"""Port parity for one FinetuneStage step in the bfloat16 compute dtype:
the port's ``Trainer.train_step_fn("FinetuneStage")`` with
``Config(compute_dtype="bfloat16")`` against the JAX package's
``phases.finetune_stage_loss`` with ``ManoOCRStage(dtype=bfloat16,
bn_groups=2)`` under ``jax.value_and_grad`` and its optimizer, from the
same weights, batch statistics, synth sample, real batch and draws
(test_torch_finetune_stage.py's set-up, at B=1: 64x64 crops, synthetic
MANO, the NYU camera).  This is the step whose stacked [synth | real]
forward runs the two-group BatchNorm, which rounds in bfloat16 as the JAX
package's ``_GroupedBN`` does (test_torch_bf16_layers.py holds it
bitwise); one image a half is the least batch that drives it, and keeps
the file's time to the JAX step's compile.

The witness is the port's float64 loss on the same weights, sample, real
batch and cloud-sampling draws (the float32 net in float64), as in
test_torch_bf16_pretrain.py: each bfloat16 run against it, the port
within a multiple of JAX's own distance (``torch_parity.check_gradients``
and ``check_batch_stats``).
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
from dsf_tpu.render import renderer as JR
from dsf_tpu.training import phases as JP
from dsf_tpu.training import trainer as JT
from dsf_tpu_torch import demo
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.data.synth_params import random_param_source
from dsf_tpu_torch.models.layers import set_compute_dtype
from dsf_tpu_torch.models.weights import (random_reference_state_dict,
                                          state_dict_from_jax)
from dsf_tpu_torch.training import phases as TP
from dsf_tpu_torch.training.trainer import Trainer
from torch_parity import (check_batch_stats, check_gradients,
                          float64_renderer, jax_finetune_stage_draws)

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S, B = 64, 1
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

    # the port's bfloat16 step
    cfg = Config(dataset="nyu", batch_size=B, stage_num=2, input_size=S,
                 compute_dtype="bfloat16")
    tr = Trainer(cfg, path, steps_per_epoch=10, device="cpu")
    real = demo.real_batch(tr.renderer, B, np.random.RandomState(1))
    synth = TP.finetune_stage_sample(tr.renderer, draws,
                                     torch.from_numpy(para),
                                     torch.from_numpy(cube))
    state = tr.init_state(variables)
    net64 = copy.deepcopy(state.net)
    state, metrics = tr.train_step_fn("FinetuneStage")(
        state, draws, dict(real, model_para=para, cube_synth=cube))
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
    loss64, m64 = TP.finetune_stage_loss(
        net64, float64_renderer(tr.renderer), [x.double() for x in synth],
        draws.scores.double(), *[real[k].double() for k in BATCH_KEYS], cfg)
    loss64.backward()
    exact = dict(
        metrics=dict({k: float(v) for k, v in m64.items()},
                     loss=float(loss64)),
        grads={n: p.grad.numpy() for n, p in net64.named_parameters()},
        buffers={n: b.numpy() for n, b in net64.named_buffers()
                 if "running" in n})

    # the JAX step in bfloat16 on the same synth sample and real batch
    jcfg = JConfig(dataset="nyu", batch_size=B, stage_num=2, input_size=S,
                   compute_dtype="bfloat16")
    jnet = JManoOCRStage(joint_num=21, depth=18, refine=True, bn_groups=2,
                         dtype=jnp.bfloat16)
    fixed = tuple(jnp.asarray(x.numpy()) for x in synth)
    jreal = [jnp.asarray(real[k].numpy()) for k in BATCH_KEYS]

    def apply2_fn(v, img, rend, center, cube_, train, mutable=False):
        return jnet.apply(v, img, rend, center, cube_, train=train,
                          mutable=mutable)

    def loss_fn(params):
        return JP.finetune_stage_loss(
            None, {"params": params, "batch_stats": variables["batch_stats"]},
            key, jnp.asarray(para), jnp.asarray(cube), *jreal, r=jr,
            transfer_fn=None, cfg=jcfg,
            transfer_map=transfer_for_dataset("nyu"), apply2_fn=apply2_fn)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "synth_sample", lambda *a, **k: fixed)
        (loss, (new_state, jmetrics)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
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
        buffers={n: sd_after[n].numpy() for n in port["buffers"]})
    return port, ref, exact


def test_loss_and_metrics_within_jax_distance_of_float64(step):
    """The loss and every metric, each side's distance from float64: the
    port's within 2x JAX's + 2e-3 of the float64 value + 1e-4 (the
    ICP-family metrics select part labels, nearest faces and silhouettes
    that bfloat16 moves; M2P's gate is closed at these weights, both 0),
    and JAX's within 10% of it + 1e-4 (measured in the printed line)."""
    port, ref, exact = step
    assert set(port["metrics"]) == set(ref["metrics"]) == set(exact["metrics"])
    rows = {}
    for k, e in exact["metrics"].items():
        p, j = port["metrics"][k], ref["metrics"][k]
        rows[k] = (abs(p - e), abs(j - e), e)
        assert np.isfinite(p), k
        assert abs(j - e) <= 0.1 * abs(e) + 1e-4, (k, p, j, e)
        assert abs(p - e) <= 2 * abs(j - e) + 2e-3 * abs(e) + 1e-4, (
            k, p, j, e)
    print("FinetuneStage bf16 metric |port - f64|, |JAX - f64|, f64: "
          + ", ".join(f"{k} {a:.3g} {b:.3g} {c:.4g}" for k, (a, b, c)
                      in rows.items()))


def test_gradients_within_jax_distance_of_float64(step):
    """``torch_parity.check_gradients`` on the FinetuneStage step."""
    check_gradients(*step, "FinetuneStage")


def test_updated_params_match_jax(step):
    """One AdamW update from zero moments on float32 parameters: the
    updated parameters differ from JAX's by exactly what the gradient
    difference explains, to float32 rounding of the parameter (as in
    test_torch_finetune_stage.py)."""
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


def test_grouped_batch_stats_within_jax_distance_of_float64(step):
    """The running statistics after the stacked forward (two EMA updates a
    layer, synth first, from the per-half bfloat16 activations' float32
    statistics): ``torch_parity.check_batch_stats``."""
    port, ref, exact = step
    assert len(port["buffers"]) == 2 * 47
    check_batch_stats(port, ref, exact, "FinetuneStage")
