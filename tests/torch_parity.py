"""Shared by the port's training parity tests: the JAX package's random
draws of one Pretrain step, taken from a key with the same splits as
``dsf_tpu.training.phases._aug_keys``, ``renderer.synth_sample`` and
``renderer.mask_img``, handed to the port as tensors."""

import jax
import numpy as np
import torch

from dsf_tpu_torch.render import renderer as TRr
from dsf_tpu_torch.training import phases as TP


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_mask_draws(key, batch, joint_num=21, mask_offset=0.15, mask_para=0.3,
                   min_mask_num=3, max_mask_num=10):
    """renderer.mask_img's draws from its key."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    n_active = int(jax.random.randint(k1, (), min_mask_num, max_mask_num))
    ids = jax.random.permutation(k2, joint_num)[:max_mask_num]
    K = ids.shape[0]
    offs = (jax.random.uniform(k3, (batch, K, 3)) - 0.5) * mask_offset * 2
    radius = jax.random.uniform(k4, (batch, K)) * mask_para
    return TRr.MaskDraws(n_active, _t(ids).long(), _t(offs), _t(radius))


def jax_pretrain_draws(key, batch, depth_range, mask=True):
    """phases.pretrain_loss's draws from its key: _aug_keys, then the synth
    factory's depth placement and mask_img key (renderer.py:100-102,
    121-123)."""
    k1, k2, k3, _, k5, _ = jax.random.split(key, 6)
    shape = jax.random.normal(k1, (batch, 10)) * 3.0
    center = (jax.random.uniform(k2, (batch, 3)) - 0.5) * 40.0
    size = 1.0 + (jax.random.uniform(k3, (batch, 1)) - 0.5) * 0.4
    ks, sub = jax.random.split(k5)
    z = jax.random.uniform(sub, (batch, 1), minval=depth_range[0],
                           maxval=depth_range[1])
    mask_draws = None
    if mask:
        _, sub = jax.random.split(ks)
        mask_draws = jax_mask_draws(sub, batch)
    return TP.PretrainDraws(_t(shape), _t(center), _t(size), _t(z), mask_draws)


def gradient_spread(seed=0, batch=2, size=64):
    """The conditioning numbers test_torch_train_step.py states: on its
    inputs (seeded weights, batch and key), the relative L2 distance per
    parameter between the JAX package's jitted and eager Pretrain
    gradients, with the JAX factory's own images (``own``) and with the
    port's synth image fed to both (``one image``), and the port's
    gradient against each.  Slow: the eager run compiles op by op."""
    import jax.numpy as jnp
    from dsf_tpu.config import Config as JConfig
    from dsf_tpu.mano import model as JM, synthetic as JS
    from dsf_tpu.models import torch_import as TI
    from dsf_tpu.models.backbone import ManoOCRStage as JNet
    from dsf_tpu.render import renderer as JR
    from dsf_tpu.training import phases as JP
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.models.weights import (random_reference_state_dict,
                                              state_dict_from_jax)
    from dsf_tpu_torch.training.trainer import Trainer
    import tempfile, os

    paras = (588.03, 587.07, 320.0, 240.0)
    path = os.path.join(tempfile.mkdtemp(), "syn.npz")
    JS.save_synthetic_mano(path)
    variables = jax.tree_util.tree_map(np.array, TI.convert_mano_ocr_stage(
        random_reference_state_dict(np.random.RandomState(seed)), refine=True))
    para, cube = next(random_param_source(batch, seed=seed))
    key = jax.random.PRNGKey(seed)
    jr = JR.Renderer.create(JM.load_model(path), "nyu", paras, (640, 480),
                            (size, size))
    jcfg = JConfig(dataset="nyu", batch_size=batch, stage_num=2,
                   input_size=size)
    jnet = JNet(joint_num=21, depth=18, refine=True)
    draws = jax_pretrain_draws(key, batch, jr.depth_range)
    tr = Trainer(Config(dataset="nyu", batch_size=batch, stage_num=2,
                        input_size=size), path, device="cpu")
    synth = TP.pretrain_sample(tr.renderer, draws, torch.from_numpy(para),
                               torch.from_numpy(cube))
    state = tr.init_state(variables)
    state, _ = tr.train_step_fn("Pretrain")(
        state, draws, {"model_para": para, "cube_synth": cube})
    port = {n: p.grad.numpy() for n, p in state.net.named_parameters()}

    def apply_fn(v, img, rend, center, cube_, train, mutable=False):
        return jnet.apply(v, img, rend, center, cube_, train=train,
                          mutable=mutable)

    def loss_fn(params):
        return JP.pretrain_loss(
            apply_fn, {"params": params,
                       "batch_stats": variables["batch_stats"]}, key,
            jnp.asarray(para), jnp.asarray(cube), r=jr, transfer_fn=None,
            cfg=jcfg, stage_num=2)

    def grads(fn):
        g = fn(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])[1]
        sd = state_dict_from_jax({"params": g,
                                  "batch_stats": variables["batch_stats"]})
        return {n: sd[n].numpy() for n in port}

    def spread(a, b):
        r = [np.linalg.norm(a[n] - b[n]) / (np.linalg.norm(b[n]) + 1e-30)
             for n in a]
        return f"max {max(r):.3g} median {np.median(r):.3g}"

    out = {}
    jit_own, eager_own = grads(jax.jit), grads(lambda f: f)
    out["own images: jit vs eager"] = spread(jit_own, eager_own)
    fixed = tuple(jnp.asarray(x.numpy()) for x in synth)
    orig = JR.synth_sample
    JR.synth_sample = lambda *a, **k: fixed
    try:
        jit_one, eager_one = grads(jax.jit), grads(lambda f: f)
    finally:
        JR.synth_sample = orig
    out["one image: jit vs eager"] = spread(jit_one, eager_one)
    out["one image: port vs jit"] = spread(port, jit_one)
    out["one image: port vs eager"] = spread(port, eager_one)
    return out


if __name__ == "__main__":
    # python tests/torch_parity.py  (JAX on the CPU; a few minutes)
    jax.config.update("jax_platforms", "cpu")
    for k, v in gradient_spread().items():
        print(f"{k}: {v}")
