"""Port parity for the Pretrain step's optimizer: the learning-rate
schedule, and AdamW behind the finite guard against the JAX package's
optax chain, on the same numbers.  (Train-mode BatchNorm is held against
Flax in test_torch_train_bn.py.)"""

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from dsf_tpu.config import Config as JConfig
from dsf_tpu.training import trainer as JT
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.training import trainer as TT

torch.set_num_threads(2)


@pytest.mark.parametrize("scheduler", ["step", "multi_step", "auto"])
def test_lr_schedule_matches_jax(scheduler):
    spe = 7
    jsch = JT.lr_schedule(JConfig(dataset="nyu", scheduler=scheduler), spe)
    tsch = TT.lr_schedule(Config(dataset="nyu", scheduler=scheduler), spe)
    for count in (0, 1, 69, 70, 71, 139, 140, 300):
        np.testing.assert_allclose(tsch(count), float(jsch(count)), rtol=1e-6)


def _tiny_params(rng):
    return {"w": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(3).astype(np.float32)}


def test_guarded_adamw_matches_optax():
    """AdamW(wd 0.01) behind the finite guard, step by step against the JAX
    package's make_optimizer (optax adamw + _apply_if_finite_select) on the
    same gradient sequence.  Non-finite gradients skip the update and the
    moment update; the 9th non-finite in a row is applied, NaN where
    optax has NaN.  Parameters agree to a few float32 ulps (1e-6 relative
    and 5e-7 absolute) over 15 steps: each side forms the update in its own order
    (torch applies the decay as a separate product)."""
    cfg_j = JConfig(dataset="nyu", lr=1e-2)
    tx = JT.make_optimizer(cfg_j, 3)
    rng = np.random.RandomState(0)
    p0 = _tiny_params(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(p0["w"].copy()))
            self.b = torch.nn.Parameter(torch.from_numpy(p0["b"].copy()))

    net = Net()
    cfg = Config(dataset="nyu", lr=1e-2)
    state = TT.TrainState(net=net, optimizer=TT.make_optimizer(cfg, net.parameters()))
    sch = TT.lr_schedule(cfg, 3)
    pattern = [1, 1, 0, 1] + [0] * 9 + [1, 1]      # 0: a NaN in the gradient
    accepted = []
    for finite in pattern:
        g = _tiny_params(rng)
        if not finite:
            g["w"][1, 2] = np.nan
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        net.w.grad = torch.from_numpy(g["w"])
        net.b.grad = torch.from_numpy(g["b"])
        accepted.append(TT.guarded_update(state, [net.w, net.b],
                                          sch(state.updates)))
        for k in ("w", "b"):
            np.testing.assert_allclose(getattr(net, k).detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6, atol=5e-7)
        assert state.notfinite_count == int(opt_state.notfinite_count)
        assert state.total_notfinite == int(opt_state.total_notfinite)
        assert state.last_finite == bool(opt_state.last_finite)
    assert accepted == [True, True, False, True] + [False] * 8 + [True] * 3
    assert np.isnan(net.w.detach().numpy()).any()


def test_guard_gives_parameters_without_gradient_a_zero_one():
    """As in the JAX step, every parameter gets a gradient (zero where the
    loss does not reach it), so weight decay moves it."""
    p = torch.nn.Parameter(torch.ones(3))
    state = TT.TrainState(net=None, optimizer=TT.make_optimizer(Config(), [p]))
    assert TT.guarded_update(state, [p], 0.1)
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - 0.1 * 0.01, rtol=1e-6)


def test_trainer_phases_other_than_pretrain_raise(tmp_path):
    """Pretrain, Finetune (one stage) and FinetuneStage (two stages) are
    ported, the last two on the NYU camera at their own stage count, and
    so is the CycleGAN transfer net; other phases, the self-supervised
    steps off the NYU camera or at the other stage count, compute dtypes
    other than float32 and bfloat16, and optimizers other than AdamW
    raise."""
    from dsf_tpu_torch.mano import synthetic
    path = str(tmp_path / "syn.npz")
    synthetic.save_synthetic_mano(path)
    tr = TT.Trainer(Config(input_size=64), path, device="cpu")
    assert callable(tr.train_step_fn("Pretrain"))
    assert callable(tr.train_step_fn("FinetuneStage"))
    with pytest.raises(NotImplementedError, match="1-stage NYU"):
        tr.train_step_fn("Finetune")
    one = TT.Trainer(Config(input_size=64, stage_num=1), path, device="cpu")
    assert callable(one.train_step_fn("Finetune"))
    with pytest.raises(NotImplementedError, match="2-stage NYU"):
        one.train_step_fn("FinetuneStage")
    with pytest.raises(NotImplementedError, match="Pretrain, Finetune"):
        tr.train_step_fn("CycleGAN")
    with pytest.raises(NotImplementedError, match="NYU"):
        TT.Trainer(Config(dataset="icvl", input_size=64), path,
                   device="cpu").train_step_fn("FinetuneStage")
    assert TT.Trainer(Config(input_size=64, transferNet_pth=str(
        tmp_path / "missing.pth")), path, device="cpu").transfer_net is not None
    assert tr.transfer_net is None
    assert TT.Trainer(Config(input_size=64, compute_dtype="bfloat16"), path,
                      device="cpu").dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        TT.Trainer(Config(compute_dtype="float16"), path, device="cpu")
    with pytest.raises(NotImplementedError, match="AdamW"):
        TT.make_optimizer(Config(opt="sgd"), [torch.nn.Parameter(torch.ones(1))])
