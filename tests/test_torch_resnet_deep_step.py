"""The deep trunks in training, on the CPU: one Pretrain step at depth 50
against the JAX package's (as test_torch_train_step.py at depth 18),
``DSF_REMAT`` against no rematerialization (bitwise), and the trainer's
command line with ``--net ResNet_stage_50`` (train, evaluate, save,
resume bitwise; a checkpoint of another depth refused before any step).

The JAX variables are drawn on ``jax.eval_shape``'s tree
(``torch_parity.jax_deep_variables``; see test_torch_resnet_deep.py).
"""

import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dsf_tpu.config import Config as JConfig
from dsf_tpu.data.fake import make_fake_nyu
from dsf_tpu.mano import model as JM, synthetic as JS
from dsf_tpu.models.backbone import ManoOCRStage as JManoOCRStage
from dsf_tpu.render import renderer as JR
from dsf_tpu.training import phases as JP
from dsf_tpu_torch import demo
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.data.synth_params import random_param_source
from dsf_tpu_torch.models import backbone as TB
from dsf_tpu_torch.models.layers import BatchNorm2d
from dsf_tpu_torch.models.weights import (load_into,
                                          random_reference_state_dict,
                                          state_dict_from_jax)
from dsf_tpu_torch.training import checkpoints as ckpt
from dsf_tpu_torch.training import loop as TL
from dsf_tpu_torch.training import phases as TP
from dsf_tpu_torch.training.__main__ import parse_config
from dsf_tpu_torch.training.trainer import Trainer
from torch_parity import jax_deep_variables, jax_pretrain_draws

torch.set_num_threads(2)

PARAS = (588.03, 587.07, 320.0, 240.0)
S, B = 64, 2
HEADS = ("mano_regress", "finals_s2")


@pytest.fixture(scope="module")
def mano(tmp_path_factory):
    return JS.save_synthetic_mano(str(tmp_path_factory.mktemp("m") / "m.npz"))


# ------------------------------------------------------------ Pretrain step

@pytest.fixture(scope="module")
def step(mano):
    """One two-stage Pretrain step at depth 50, 64^2, B=2: the port's
    ``Trainer.train_step_fn`` and the JAX package's ``pretrain_loss`` under
    ``jax.value_and_grad``, from the same weights,
    draws and synth sample (the port's, as test_torch_train_step.py)."""
    jr = JR.Renderer.create(JM.load_model(mano), "nyu", PARAS, (640, 480),
                            (S, S))
    variables = jax_deep_variables(50, jr, S)
    para, cube = next(random_param_source(B, seed=0))
    key = jax.random.PRNGKey(0)
    draws = jax_pretrain_draws(key, B, jr.depth_range)

    cfg = Config(dataset="nyu", batch_size=B, stage_num=2, input_size=S,
                 net="ResNet_stage_50")
    tr = Trainer(cfg, mano, steps_per_epoch=10, device="cpu")
    synth = TP.pretrain_sample(tr.renderer, draws, torch.from_numpy(para),
                               torch.from_numpy(cube))
    state = tr.init_state(variables)
    state, metrics = tr.train_step_fn("Pretrain")(
        state, draws, {"model_para": para, "cube_synth": cube})
    net = state.net
    port = dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: p.grad.numpy().copy() for n, p in net.named_parameters()},
        params={n: p.detach().numpy().copy()
                for n, p in net.named_parameters()},
        buffers={n: b.numpy().copy() for n, b in net.named_buffers()
                 if "running" in n},
        updates=int(state.updates))

    jcfg = JConfig(dataset="nyu", batch_size=B, stage_num=2, input_size=S,
                   net="ResNet_stage_50")
    jnet = JManoOCRStage(joint_num=21, depth=50, refine=True)
    fixed = tuple(jnp.asarray(x.numpy()) for x in synth)

    def apply_fn(v, img, rend, center, cube_, train, mutable=False):
        return jnet.apply(v, img, rend, center, cube_, train=train,
                          mutable=mutable)

    def loss_fn(params, batch_stats, key, sample):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JR, "synth_sample", lambda *a, **k: sample)
            return JP.pretrain_loss(
                apply_fn, {"params": params, "batch_stats": batch_stats},
                key, jnp.asarray(para), jnp.asarray(cube), r=jr,
                transfer_fn=None, cfg=jcfg, stage_num=2)

    (loss, (new_state, jmetrics)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], key, fixed)
    sd_grads = state_dict_from_jax({"params": grads,
                                    "batch_stats": variables["batch_stats"]})
    sd_after = state_dict_from_jax({"params": variables["params"],
                                    "batch_stats": new_state["batch_stats"]})
    ref = dict(
        metrics=dict({k: float(v) for k, v in jmetrics.items()},
                     loss=float(loss)),
        grads={n: sd_grads[n].numpy() for n in port["grads"]},
        params={n: sd_after[n].numpy() for n in port["params"]},
        buffers={n: sd_after[n].numpy() for n in port["buffers"]},
        before=state_dict_from_jax(variables))
    return port, ref


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def test_pretrain_loss_and_metrics_match_jax(step):
    """The loss within 2e-5 relative, the stage-1 mm errors within 1e-3
    mm and stage 2's within 1e-2 mm (test_torch_train_step.py's bounds)."""
    port, ref = step
    pm, rm = port["metrics"], ref["metrics"]
    assert set(pm) == set(rm)
    assert np.isfinite(pm["loss"]) and pm["loss"] > 0
    np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=2e-5)
    for k in pm:
        if k != "loss":
            atol = 1e-3 if k.endswith("_0") else 1e-2
            np.testing.assert_allclose(pm[k], rm[k], rtol=0, atol=atol,
                                       err_msg=k)


def test_pretrain_gradients_match_jax(step):
    """Every parameter's gradient in relative L2: the MANO heads and the
    stage-2 offset head (losses only) within 2e-3, the layers behind
    BatchNorm trunks within 0.15 (their ill-conditioning at random
    weights; test_torch_train_step.py)."""
    port, ref = step
    worst = {}
    for name, g in port["grads"].items():
        r = ref["grads"][name]
        assert g.shape == r.shape and np.isfinite(g).all(), name
        assert np.abs(r).max() > 0, name
        worst[name] = _rel(g, r)
        assert worst[name] <= (2e-3 if name.startswith(HEADS) else 0.15), (
            name, worst[name])
    assert len(worst) == len(ref["grads"])
    print(f"worst gradient {max(worst.values()):.2e}, median "
          f"{np.median(list(worst.values())):.2e}")


def test_pretrain_update_and_batch_stats_match_jax(step):
    """The AdamW update from zero moments (optax's first step, p' = p - lr
    (u(g) + 0.01 p) with u(g) = g / (|g| + 1e-8); the optimizer itself is
    held against optax at depth 18 by test_torch_train_step.py) taken on
    JAX's gradients differs from the port's by what the gradients'
    difference explains, lr (u(g) - u(g_jax)), to float32 rounding of the
    parameter; the running statistics within 5e-5 (stage 1) and 2e-4
    (stage 2) of each tensor's largest entry, every one moved by the
    step."""
    port, ref = step
    lr = 1e-3
    u = lambda g: g.astype(np.float64) / (np.abs(g.astype(np.float64)) + 1e-8)
    for name, p in port["params"].items():
        p0 = ref["params"][name].astype(np.float64)
        r = p0 - lr * (u(ref["grads"][name]) + 0.01 * p0)
        expected = -lr * (u(port["grads"][name]) - u(ref["grads"][name]))
        np.testing.assert_allclose(p - r, expected, rtol=0,
                                   atol=1e-6 * np.abs(r).max() + 2e-7,
                                   err_msg=name)
    assert port["updates"] == 1
    assert len(port["buffers"]) == 2 * 111      # BatchNorms at depth 50
    for name, b in port["buffers"].items():
        r = ref["buffers"][name]
        assert not np.array_equal(r, ref["before"][name].numpy()), name
        stage2 = "_s2" in name or name.startswith("fusion")
        np.testing.assert_allclose(
            b, r, rtol=0, atol=(2e-4 if stage2 else 5e-5) * np.abs(r).max(),
            err_msg=name)


# ------------------------------------------------------------ DSF_REMAT

REMAT_S = 32


def _remat_run(monkeypatch, renderer, sd, remat, groups, dtype):
    """One train-mode forward and backward of the two-stage depth-50 net
    (``groups`` stacked batches of 2 crops of 32^2) with DSF_REMAT set to
    ``remat``: the outputs, the state dict after it (running statistics),
    the gradients, and the BatchNorm forwards run inside the backward."""
    monkeypatch.setenv("DSF_REMAT", "1" if remat else "0")
    net = TB.ManoOCRStage(depth=50, dtype=dtype)
    load_into(net, sd)
    net.train()
    img, center, _, cube = demo.requests(renderer, 2 * groups,
                                         np.random.RandomState(1))
    img, center, cube = map(torch.from_numpy, (img, center, cube))
    calls = [0]
    bns = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    hooks = [m.register_forward_hook(
        lambda *a: calls.__setitem__(0, calls[0] + 1)) for m in bns]
    out = net(img, renderer, center, cube, bn_groups=groups)
    forwards = calls[0]
    sum((o.float() ** 2).sum() for st in out for o in st).backward()
    for h in hooks:
        h.remove()
    assert all(m.sync is None and not m.replay for m in bns)
    return dict(out=[o.detach() for st in out for o in st],
                state={k: v.clone() for k, v in net.state_dict().items()},
                grads={n: p.grad.clone() for n, p in net.named_parameters()},
                replayed=calls[0] - forwards, forwards=forwards)


@pytest.fixture(scope="module")
def remat_env(mano):
    """The renderer at 32^2, the seeded depth-50 weights, and the
    DSF_REMAT=0 runs by (groups, dtype), made once."""
    from dsf_tpu_torch.mano import model as TM
    from dsf_tpu_torch.render import renderer as TR
    r = TR.Renderer.create(TM.load_model(mano, device="cpu"), "nyu",
                           PARAS, (640, 480), (REMAT_S, REMAT_S))
    sd = random_reference_state_dict(np.random.RandomState(0), depth=50)
    return dict(renderer=r, sd=sd, plain={})


def _plain(monkeypatch, env, groups, dtype):
    if (groups, dtype) not in env["plain"]:
        env["plain"][groups, dtype] = _remat_run(
            monkeypatch, env["renderer"], env["sd"], False, groups, dtype)
    return env["plain"][groups, dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2])
def test_remat_is_bitwise_neutral(monkeypatch, remat_env, groups, dtype):
    """DSF_REMAT=1 at depth 50 (the JAX package's
    test_remat_flag_is_bitwise_neutral): outputs, running statistics
    after the step and gradients bitwise those of DSF_REMAT=0, with one
    and two BatchNorm groups, in float32 and bfloat16.  The recompute ran
    (every checkpointed BatchNorm forwards again inside the backward:
    all but the fusion's) and took no second statistics update; under
    ``torch.no_grad`` nothing is checkpointed."""
    plain = _plain(monkeypatch, remat_env, groups, dtype)
    remat = _remat_run(monkeypatch, remat_env["renderer"], remat_env["sd"],
                       True, groups, dtype)
    assert plain["replayed"] == 0
    assert remat["replayed"] == remat["forwards"] - 1
    for a, b in zip(plain["out"], remat["out"]):
        assert torch.equal(a, b)
    for part in ("state", "grads"):
        assert plain[part].keys() == remat[part].keys()
        for k, v in plain[part].items():
            assert torch.equal(v, remat[part][k]), (part, k)
    monkeypatch.setenv("DSF_REMAT", "1")
    assert TB.remat_enabled()
    with torch.no_grad():
        net = TB.ManoOCRStage(depth=50, refine=False)
        seen = []
        net.register_forward_hook(lambda *a: seen.append(
            torch.is_grad_enabled()))
        net(torch.zeros(1, 1, REMAT_S, REMAT_S))
    assert seen == [False]


def test_remat_recompute_without_replay_is_caught(monkeypatch, remat_env):
    """Mutation check: with the replay flag ignored, the recompute takes a
    second statistics update and the running statistics part from
    DSF_REMAT=0's, so the test above would fail."""
    plain = _plain(monkeypatch, remat_env, 1, torch.float32)
    monkeypatch.setattr(BatchNorm2d, "replay", property(
        lambda self: False, lambda self, v: None))
    broken = _remat_run(monkeypatch, remat_env["renderer"], remat_env["sd"],
                        True, 1, torch.float32)
    assert not all(torch.equal(v, broken["state"][k])
                   for k, v in plain["state"].items())


# ------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def fake_nyu(mano, tmp_path_factory):
    root = tmp_path_factory.mktemp("nyu")
    make_fake_nyu(str(root), mano, n_train=2, n_test=2)
    return str(root)


def _cli(fake_nyu, mano, save_dir, *extra):
    return parse_config([
        "--net", "ResNet_stage_50", "--root_dir", fake_nyu,
        "--mano_model_path", mano, "--save_dir", save_dir,
        "--batch_size", "2", "--input_size", "32", "--image_every", "0",
        "--train_stage", "Pretrain", "--save_mesh", "false", *extra])


def test_cli_trains_evaluates_and_resumes_at_depth_50(fake_nyu, mano,
                                                      tmp_path, monkeypatch):
    """``--net ResNet_stage_50`` through the command line's own parser and
    ``loop.run`` on the CPU: two epochs of one Pretrain step each
    write train.log (Epoch#0, Epoch#1, test:), ``latest``, ``best`` and
    every view's results; resumed from the epoch-0 checkpoint, the run
    ends bitwise where the uninterrupted one does.  A depth-18 checkpoint
    given to a depth-50 run raises, naming the keys, before any step:
    the net is not touched."""
    monkeypatch.setattr(Config, "max_epoch", property(lambda self: 2))
    snap = tmp_path / "epoch0"
    save = ckpt.save

    def keep_epoch0(path, tr, state, epoch):
        save(path, tr, state, epoch)
        if epoch == 0 and os.path.basename(path) == "latest":
            ckpt.wait_until_finished()
            shutil.copytree(path, snap / "latest")

    monkeypatch.setattr(ckpt, "save", keep_epoch0)
    cfg = _cli(fake_nyu, mano, str(tmp_path / "runs"), "--add_info", "whole")
    assert cfg.net == "ResNet_stage_50"
    whole = TL.run(cfg, device="cpu")
    monkeypatch.setattr(ckpt, "save", save)
    log = open(os.path.join(whole, "train.log")).read()
    assert "Epoch#0:" in log and "Epoch#1:" in log and "test:" in log
    for view in range(3):
        rows = np.loadtxt(os.path.join(whole, f"result_1_{view}.txt"))
        assert rows.shape == (2, 63) and np.isfinite(rows).all()
    a = torch.load(os.path.join(whole, "latest", ckpt.FILE),
                   weights_only=True)
    assert a["net"]["layer3.5.conv3.weight"].shape == (1024, 256, 1, 1)

    resumed = TL.run(_cli(fake_nyu, mano, str(tmp_path / "runs"),
                          "--add_info", "resumed", "--load_model", str(snap),
                          "--test_during_train", "false"), device="cpu")
    b = torch.load(os.path.join(resumed, "latest", ckpt.FILE),
                   weights_only=True)
    assert a["epoch"] == b["epoch"] == 1 and a["step"] == b["step"] == 2
    for part in ("net", "optimizer"):
        for k, v in a[part].items():
            assert (torch.equal(b[part][k], v) if torch.is_tensor(v)
                    else b[part][k] == v), (part, k)

    # a depth-18 checkpoint into a depth-50 trainer
    tr18 = Trainer(cfg.replace(net="ResNet_stage_18"), mano, device="cpu")
    ckpt.save(str(tmp_path / "r18" / "latest"), tr18, tr18.init_state(), 0)
    ckpt.wait_until_finished()
    tr50 = Trainer(cfg, mano, device="cpu")
    state = tr50.init_state()
    before = {k: v.clone() for k, v in state.net.state_dict().items()}
    with pytest.raises(RuntimeError, match="layer1.0.conv3.weight"):
        ckpt.restore(str(tmp_path / "r18"), tr50, state)
    assert all(torch.equal(v, state.net.state_dict()[k])
               for k, v in before.items())
    steps = []
    monkeypatch.setattr(Trainer, "train_step_fn",
                        lambda *a, **k: steps.append(1))
    with pytest.raises(RuntimeError, match="does not fit the net"):
        TL.run(_cli(fake_nyu, mano, str(tmp_path / "runs"), "--add_info",
                    "from18", "--load_model", str(tmp_path / "r18")),
               device="cpu")
    assert not steps
    # the depth-50 checkpoints take ~0.8 GB each
    shutil.rmtree(tmp_path)


# ------------------------------------------------------------ serving

def test_engine_replicas_at_depth_50(mano):
    """The depth-50 engine (``net="ResNet_stage_50"``, the seeded draw of
    its depth) on two CPU replicas against one device, as
    test_torch_parallel.py holds depth 18's: a request of 3 split over the
    replicas within 1e-6 of each output's scale, finite, its MANO
    parameters of the seeded hand's cam scale."""
    from dsf_tpu_torch.serving import InferenceEngine
    cfg = Config(input_size=32, mano_model_path=mano, net="ResNet_stage_50")
    sd = random_reference_state_dict(np.random.RandomState(0), depth=50)
    one = InferenceEngine(cfg, sd, buckets=(4,), device="cpu")
    two = InferenceEngine(cfg.replace(num_devices=2), sd, buckets=(4,),
                          devices=("cpu", "cpu"))
    from dsf_tpu_torch.models.resnet import Bottleneck
    assert len(two.replicas) == 2
    assert two.replicas[0][0] is not two.replicas[1][0]
    assert isinstance(two.replicas[1][0].layer3_s2[5], Bottleneck)
    req = demo.requests(one.renderer, 3, np.random.RandomState(3))
    a, b = one.predict(*req), two.predict(*req)
    assert a.keys() == b.keys()
    for k in a:
        assert np.isfinite(a[k]).all(), k
        np.testing.assert_allclose(b[k], a[k], rtol=0,
                                   atol=1e-6 * np.abs(a[k]).max(), err_msg=k)
    np.testing.assert_allclose(a["mano_para_0"][:, 58], 1.0, atol=0.2)
