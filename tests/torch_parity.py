"""Shared by the port's training parity tests: the JAX package's random
draws of one Pretrain or FinetuneStage step, taken from a key with the same
splits as ``dsf_tpu.training.phases._aug_keys``, ``renderer.synth_sample``,
``renderer.mask_img`` and ``ops.cloud.img_to_pcl``, handed to the port as
tensors."""

import dataclasses

import jax
import jax.numpy as jnp
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


def jax_finetune_stage_draws(key, batch, depth_range, crop_size, mask=True):
    """phases.finetune_stage_loss's draws from its key: the split into
    (k_aug, k_prep, _), _aug_keys(k_aug) with its random view and the synth
    factory's draws as for Pretrain, and img_to_pcl's scores from k_prep
    (2B crops of crop_size^2, the clouds' feature size)."""
    k_aug, k_prep, _ = jax.random.split(key, 3)
    synth = jax_pretrain_draws(k_aug, batch, depth_range, mask=mask)
    k4 = jax.random.split(k_aug, 6)[3]
    view = jax.random.uniform(k4, (batch, 3)) * jnp.pi * 2.0
    scores = jax.random.uniform(k_prep, (2 * batch, crop_size * crop_size))
    return TP.FinetuneStageDraws(synth, _t(view), _t(scores))


def _deep_draw(path, shape, rng, damp):
    """One leaf of the JAX tree, drawn by its name (Flax layouts: conv
    kernels (kh, kw, in, out), transposed ones (kh, kw, out, in), dense
    (in, out))."""
    names = [str(getattr(k, "key", k)) for k in path]
    leaf, owner = names[-1], names[-2]
    if names[0] == "batch_stats":
        return (rng.randn(*shape) * 0.05 if leaf == "mean"
                else rng.uniform(0.8, 1.5, shape))
    if leaf == "scale":
        return rng.uniform(0.8, 1.2, shape) * (damp if "bn3" in names else 1.0)
    if "mano_regress" in names:
        if leaf == "kernel":
            return rng.randn(*shape) * 1e-3
        bias = np.zeros(shape)
        bias[58] = 1.0
        return bias
    if "final_offset" in names or "final_heat" in names:
        return rng.randn(*shape) * 1e-3
    if leaf == "bias":
        return rng.randn(*shape) * 0.05
    if owner == "deconv":
        return rng.randn(*shape) * np.sqrt(2.0 / (4 * shape[3]))
    kh, kw, cin, _ = shape
    if "conv3" in names:
        return rng.randn(*shape) * np.sqrt(1.0 / cin)
    return rng.randn(*shape) * np.sqrt(2.0 / (kh * kw * cin))


def jax_deep_variables(depth, jr, size, refine=True, seed=0):
    """Numpy-drawn variables of the JAX ManoOCRStage at ``depth`` (crops
    of ``size``), in the tree ``jax.eval_shape`` of its ``init`` gives: a
    jitted Flax ``init`` at depth 50 or more takes tens of seconds on the
    CPU, and the JAX package converts ResNet-18 weights alone.  Each leaf
    is drawn by its name as ``random_reference_state_dict`` draws the
    port's layout (every Bottleneck's ``bn3`` scale damped by the square
    root of the trunk's block count)."""
    from dsf_tpu.models.backbone import ManoOCRStage as JManoOCRStage
    from dsf_tpu.models.resnet import RESNET_SPECS as J_SPECS
    net = JManoOCRStage(joint_num=21, depth=depth, refine=refine)
    x = jnp.zeros((1, 1, size, size), jnp.float32)
    c = jnp.array([[0.0, 0.0, 700.0]], jnp.float32)
    cube = jnp.full((1, 3), 250.0, jnp.float32)
    tree = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), x, jr, c,
                                           cube, train=False))
    rng = np.random.RandomState(seed)
    damp = 1.0 / np.sqrt(sum(J_SPECS[depth][1]))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return jax.tree_util.tree_unflatten(treedef, [
        _deep_draw(p, leaf.shape, rng, damp).astype(np.float32)
        for p, leaf in leaves])


def gradient_spread(seed=0, batch=2, size=64):
    """The conditioning numbers test_torch_train_step.py states: on its
    inputs (seeded weights, batch and key), the relative L2 distance per
    parameter between the JAX package's jitted and eager Pretrain
    gradients, with the JAX factory's own images (``own``) and with the
    port's synth image fed to both (``one image``), and the port's
    gradient against each.  Slow: the eager run compiles op by op."""
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


# ---------------------------------------------------------------------------
# the bfloat16 step tests' float64 witness (test_torch_bf16_pretrain.py,
# test_torch_bf16_finetune_stage.py)

HEADS = ("mano_regress", "finals_s2")


def float64_renderer(r):
    """``r`` with its MANO constants in float64 (the faces stay int64)."""
    m = r.mano
    f64 = {f.name: getattr(m, f.name).double() for f in dataclasses.fields(m)
           if torch.is_tensor(getattr(m, f.name))
           and getattr(m, f.name).is_floating_point()}
    return dataclasses.replace(r, mano=dataclasses.replace(m, **f64))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-300))


def check_gradients(port, ref, exact, label):
    """Every parameter's gradient of a bfloat16 step (float32 on both
    sides) against the float64 witness, in relative L2.  The heads feed
    the losses only: JAX lies within 0.5 of float64 there (its offset
    heads' bias gradients, summed over the pixels of a bfloat16
    cotangent: 0.12 in the Pretrain step, up to 0.35 in FinetuneStage's;
    the port's 0.004 to 0.07), and the port within 1.5x JAX's + 0.02.
    Behind the BatchNorm trunks bfloat16 rounding dominates the gradient
    at these random weights: each side lies about the gradient's own norm
    from float64 (Pretrain: a median 0.94 for the port, 0.88 for JAX) and
    as far from the other.  There the port is held within 1.5x JAX's
    distance + 0.02 per parameter and 1.2x in the median, JAX's below
    1.5, and the signal too: the median cosine between the port's
    gradient and float64's at least 0.7x JAX's (Pretrain: 0.55 and 0.60),
    which a zero or random gradient does not reach."""
    d_port, d_jax, c_port, c_jax = {}, {}, {}, {}
    for name, g in port["grads"].items():
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        e = exact["grads"][name]
        d_port[name], d_jax[name] = _rel(g, e), _rel(ref["grads"][name], e)
        c_port[name], c_jax[name] = _cos(g, e), _cos(ref["grads"][name], e)
        head = name.startswith(HEADS)
        assert d_jax[name] < (0.5 if head else 1.5), (name, d_jax[name])
        assert d_port[name] <= 1.5 * d_jax[name] + 0.02, (
            name, d_port[name], d_jax[name])
    for part, names in (("heads", [n for n in d_port if n.startswith(HEADS)]),
                        ("trunks", [n for n in d_port
                                    if not n.startswith(HEADS)])):
        mp, mj, cp, cj = (float(np.median([d[n] for n in names]))
                          for d in (d_port, d_jax, c_port, c_jax))
        print(f"{label} bf16 gradients, {part}: median relative L2 from "
              f"float64 port {mp:.4g}, JAX {mj:.4g}; median cosine with "
              f"float64 port {cp:.4g}, JAX {cj:.4g}")
        assert mp <= 1.2 * mj + 1e-3, (part, mp, mj)
        assert cp >= 0.7 * cj and cj > 0.1, (part, cp, cj)


def check_batch_stats(port, ref, exact, label):
    """The float32 running statistics after a bfloat16 step, each side's
    largest distance from float64's relative to the tensor's largest
    entry: the port's within 2x JAX's + 0.01 per tensor, and within 1.5x
    JAX's in the median.  Both come from bfloat16 activations; stage 2's
    from a re-render of bfloat16 MANO parameters, where the two sides
    round apart (Pretrain: JAX up to 0.039 from float64)."""
    dp, dj = {}, {}
    for name, b in port["buffers"].items():
        e = exact["buffers"][name]
        scale = np.abs(e).max()
        dp[name] = np.abs(b - e).max() / scale
        dj[name] = np.abs(ref["buffers"][name] - e).max() / scale
        assert dp[name] <= 2 * dj[name] + 0.01, (name, dp[name], dj[name])
    mp, mj = np.median(list(dp.values())), np.median(list(dj.values()))
    print(f"{label} bf16 batch statistics from float64, median (largest): "
          f"port {mp:.3g} ({max(dp.values()):.3g}), JAX {mj:.3g} "
          f"({max(dj.values()):.3g})")
    assert mp <= 1.5 * mj + 1e-5


# ---------------------------------------------------------------------------
# eval mode after training steps (test_torch_train_step.py,
# test_torch_finetune_stage.py)

def eval_after_step(state, tr, jax_variables, jtr, batch, label):
    """Eval mode on one batch after a step, from each side's own weights:
    the port's eval errors (per stage pixel and MANO, per sample) and
    JAX's; JAX's eval on the port's weights and running statistics
    carried over; and one evaluator, the port's eval in float64, on each
    side's weights.  Holds the eval path (JAX on the port's weights
    within 1e-2 mm at stage 1 and 0.1 mm at stage 2, the eval tests'
    tolerances) and the float64 evaluator on each side's weights within
    the same of that side's own errors, so the gap between the two sides'
    own errors is the weights'.  Returns that gap (mm, the largest per
    stage) and the parameters' largest difference."""
    import copy
    import pytest
    from dsf_tpu.models import torch_import as TI
    from dsf_tpu_torch.models.weights import load_into, state_dict_from_jax
    from dsf_tpu_torch.training import trainer as TT

    def jax_eval(variables):
        e, _ = jtr.eval_step_fn()(
            variables["params"], variables["batch_stats"],
            {k: jnp.asarray(v) for k, v in batch.items()})
        return np.asarray(e)

    def port_eval(s, t, b):
        return t.eval_step_fn()(s, b)[0].double().numpy()

    sd = {k: v.detach().numpy() for k, v in state.net.state_dict().items()}
    got = port_eval(state, tr, batch)
    want = jax_eval(jax_variables)
    carried = jax_eval(jax.tree_util.tree_map(
        np.asarray, TI.convert_mano_ocr_stage(sd, refine=True)))
    tr64 = copy.copy(tr)
    tr64.renderer = float64_renderer(tr.renderer)
    b64 = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    own, theirs = copy.deepcopy(state), copy.deepcopy(state)
    load_into(theirs.net, state_dict_from_jax(jax_variables))
    with pytest.MonkeyPatch.context() as mp:
        # the eval step casts its batch to float32; the witness keeps float64
        mp.setattr(TT, "_tensor", lambda x, dev: torch.as_tensor(x).to(dev))
        e_own = port_eval(_double(own), tr64, b64)
        e_theirs = port_eval(_double(theirs), tr64, b64)
    tol = np.array([1e-2, 1e-2, 0.1, 0.1])[:len(got), None]
    assert np.isfinite(got).all() and np.isfinite(want).all(), label
    assert (np.abs(carried - got) <= tol).all(), (label, carried - got)
    assert (np.abs(e_own - got) <= tol).all(), (label, e_own - got)
    assert (np.abs(e_theirs - want) <= tol).all(), (label, e_theirs - want)
    jsd = state_dict_from_jax(jax_variables)
    dw = max(float((p.detach() - jsd[k]).abs().max())
             for k, p in state.net.named_parameters())
    gap = np.abs(got - want).reshape(-1, 2, got.shape[-1]).max(axis=(1, 2))
    print(f"{label}: eval errors, port's own weights against JAX's own, "
          f"largest gap per stage {np.round(gap, 4).tolist()} mm; parameters' "
          f"largest difference {dw:.3g}; JAX on the port's weights "
          f"{float(np.abs(carried - got).max()):.3g} mm")
    return gap, dw


def _double(state):
    state.net.double()
    return state


if __name__ == "__main__":
    # python tests/torch_parity.py  (JAX on the CPU; a few minutes)
    jax.config.update("jax_platforms", "cpu")
    for k, v in gradient_spread().items():
        print(f"{k}: {v}")
