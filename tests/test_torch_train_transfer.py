"""Port parity for two Pretrain steps with the frozen CycleGAN generator:
the port's ``Trainer.train_step_fn("Pretrain")`` with ``transferNet_pth``
naming a missing file (the seeded stand-in generator, full width: ngf 64,
9 blocks) against the JAX package's ``phases.pretrain_loss`` with the same
generator as ``transfer_fn``, under ``jax.value_and_grad`` and its
optimizer, twice, from the same weights, batch statistics and synth
sample.  Two-stage ManoOCRStage (ResNet-18), 64x64 crops, B=2, synthetic
MANO.

The second step is where the losses of the port's Pretrain runs jump (at
B=32 on the card, 3.56 then 316.3, and before the generator was
ported, 3.54 then 319.8): at lr 1e-3 AdamW's first update moves
every weight of the random net by about the learning rate whatever its
gradient's size.  The JAX step does the same from these weights.
"""

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
from dsf_tpu.models.cyclegan import ResnetGenerator as JGenerator
from dsf_tpu.render import renderer as JR
from dsf_tpu.training import phases as JP
from dsf_tpu.training import trainer as JT
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.data.synth_params import random_param_source
from dsf_tpu_torch.models.weights import (random_generator_state_dict,
                                          random_reference_state_dict)
from dsf_tpu_torch.training import phases as TP
from dsf_tpu_torch.training.trainer import Trainer
from torch_parity import jax_pretrain_draws

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S, B, STEPS = 64, 2, 2


@pytest.fixture(scope="module")
def losses(tmp_path_factory):
    """Each side's loss at each of the two steps, on one batch."""
    path = str(tmp_path_factory.mktemp("mano") / "syn.npz")
    JS.save_synthetic_mano(path)
    variables = jax.tree_util.tree_map(np.array, TI.convert_mano_ocr_stage(
        random_reference_state_dict(np.random.RandomState(0)), refine=True))
    para, cube = next(random_param_source(B, seed=0))
    key = jax.random.PRNGKey(0)
    jr = JR.Renderer.create(JM.load_model(path), "nyu", PARAS, (640, 480),
                            (S, S))
    draws = jax_pretrain_draws(key, B, jr.depth_range)

    # the port: the trainer's stand-in for a missing path (numpy seed 0)
    cfg = Config(dataset="nyu", batch_size=B, stage_num=2, input_size=S,
                 transferNet_pth="missing/latest_net_G_A.pth")
    tr = Trainer(cfg, path, steps_per_epoch=10, device="cpu")
    synth = TP.pretrain_sample(tr.renderer, draws, torch.from_numpy(para),
                               torch.from_numpy(cube))
    state, step = tr.init_state(variables), tr.train_step_fn("Pretrain")
    port = []
    for _ in range(STEPS):
        state, metrics = step(state, draws,
                              {"model_para": para, "cube_synth": cube})
        port.append(float(metrics["loss"]))

    # JAX: the same stand-in weights, converted by the JAX package
    gen_vars = TI.convert_cyclegan_generator(
        random_generator_state_dict(np.random.RandomState(0)))
    jgen = JGenerator()
    jcfg = JConfig(dataset="nyu", batch_size=B, stage_num=2, input_size=S)
    jnet = JManoOCRStage(joint_num=21, depth=18, refine=True)
    fixed = tuple(jnp.asarray(x.numpy()) for x in synth)

    def transfer_fn(img):
        return jax.lax.stop_gradient(jgen.apply(gen_vars, img))

    def apply_fn(v, img, rend, center, cube_, train, mutable=False):
        return jnet.apply(v, img, rend, center, cube_, train=train,
                          mutable=mutable)

    def loss_fn(params, batch_stats):
        return JP.pretrain_loss(
            apply_fn, {"params": params, "batch_stats": batch_stats}, key,
            jnp.asarray(para), jnp.asarray(cube), r=jr,
            transfer_fn=transfer_fn, cfg=jcfg, stage_num=2)

    tx = JT.make_optimizer(jcfg, 10)
    params, stats = variables["params"], variables["batch_stats"]
    opt, ref = tx.init(params), []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "synth_sample", lambda *a, **k: fixed)
        value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        for _ in range(STEPS):
            (loss, (new_state, _)), grads = value_and_grad(params, stats)
            ref.append(float(loss))
            updates, opt = tx.update(grads, opt, params)
            params = optax.apply_updates(params, updates)
            stats = new_state["batch_stats"]
    return port, ref


def test_first_step_loss_matches_jax(losses):
    """Before any update: the loss to 1e-4 relative (measured 1.8e-5; the
    two generators' images differ by their float32 rounding, up to 2.4e-5,
    on top of the step's own 2e-5 of test_torch_train_step.py)."""
    port, ref = losses
    assert np.isfinite(port[0]) and port[0] > 0
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-4)


def test_second_step_loss_jumps_as_in_jax(losses):
    """After one AdamW update from the same weights: the loss to 1e-2
    relative (measured 2.2e-3: the two first gradients differ in the
    trunks, which test_torch_train_step.py holds to 0.15 of their norm,
    and so do the signs of their smallest entries) and, on both
    sides, over ten times the first step's (measured 3.06 then 358.9 for
    the port, 358.2 for JAX)."""
    port, ref = losses
    np.testing.assert_allclose(port[1], ref[1], rtol=1e-2)
    assert port[1] > 10 * port[0] and ref[1] > 10 * ref[0]
