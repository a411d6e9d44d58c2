"""Port parity for the steps' optimizer: the learning-rate schedule, and
AdamW, Adam and SGD behind the finite guard against the JAX package's
optax chains, on the same numbers (bitwise).  (Train-mode BatchNorm is held against
Flax in test_torch_train_bn.py.)"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dsf_tpu.config import Config as JConfig
from dsf_tpu.training import trainer as JT
from dsf_tpu_torch.config import CAMERA, Config
from dsf_tpu_torch.training import trainer as TT

torch.set_num_threads(2)


@pytest.mark.parametrize("scheduler", ["step", "multi_step", "auto"])
def test_lr_schedule_matches_jax(scheduler):
    """The schedule on the optimizer's int32 count, a float32 tensor, as
    the JAX package's float32 rate."""
    spe = 7
    jsch = JT.lr_schedule(JConfig(dataset="nyu", scheduler=scheduler), spe)
    tsch = TT.lr_schedule(Config(dataset="nyu", scheduler=scheduler), spe)
    for count in (0, 1, 69, 70, 71, 139, 140, 300):
        got = tsch(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(jsch(count)), rtol=1e-6)


def _tiny_params(rng):
    return {"w": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(3).astype(np.float32)}


def _guarded_run(opt, pattern, lr=1e-2):
    """The JAX package's make_optimizer (optax + _apply_if_finite_select)
    and the port's GuardedOptimizer over the same gradient sequence (0 in
    ``pattern``: a NaN in the gradient); yields both sides after each
    step."""
    cfg_j = JConfig(dataset="nyu", lr=lr, opt=opt)
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
    cfg = Config(dataset="nyu", lr=lr, opt=opt)
    state = TT.TrainState(net=net, optimizer=TT.make_optimizer(
        cfg, net.parameters(), 3))
    for finite in pattern:
        g = _tiny_params(rng)
        if not finite:
            g["w"][1, 2] = np.nan
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        net.w.grad = torch.from_numpy(g["w"])
        net.b.grad = torch.from_numpy(g["b"])
        accept = TT.guarded_update(state)
        yield net, state, accept, jp, opt_state


PATTERN = [1, 1, 0, 1] + [0] * 9 + [1, 1]      # 0: a NaN in the gradient


def test_guarded_adamw_matches_optax():
    """AdamW(wd 0.01) behind the finite guard, step by step against the JAX
    package's make_optimizer (optax adamw + _apply_if_finite_select) on the
    same gradient sequence.  Non-finite gradients skip the update and the
    moment update; the 9th non-finite in a row is applied, NaN where
    optax has NaN.  The port takes optax's operations in optax's order,
    so the parameters are optax's bitwise (NaN where optax has NaN)."""
    accepted = []
    for net, state, accept, jp, opt_state in _guarded_run("adamw", PATTERN):
        accepted.append(bool(accept))
        for k in ("w", "b"):
            np.testing.assert_array_equal(getattr(net, k).detach().numpy(),
                                          np.asarray(jp[k]))
        assert int(state.notfinite_count) == int(opt_state.notfinite_count)
        assert int(state.total_notfinite) == int(opt_state.total_notfinite)
        assert bool(state.last_finite) == bool(opt_state.last_finite)
    assert accepted == [True, True, False, True] + [False] * 8 + [True] * 3
    assert np.isnan(net.w.detach().numpy()).any()


def _inner(opt_state):
    """The optax chain's states under the guard, by type."""
    out = {}
    for s in jax.tree_util.tree_leaves(
            opt_state.inner_state,
            is_leaf=lambda x: hasattr(x, "_fields")):
        out[type(s).__name__] = s
    return out


@pytest.mark.parametrize("opt", ["adamw", "adam", "sgd"])
def test_guarded_optimizers_match_optax_bitwise(opt):
    """adamw, adam and sgd (add_decayed_weights 1e-4, momentum 0.9) behind
    the guard, over 20 finite steps with 9 NaN gradients in a row among
    them: the accepts, the guard's counters, the count of updates (the
    schedule's and the bias correction's), the parameters and the moments
    (or SGD's trace) equal optax's bitwise at every step, NaN for NaN."""
    pattern = [1, 1, 0, 1] + [0] * 9 + [1] * 16
    n_accept = 0
    for net, state, accept, jp, opt_state in _guarded_run(opt, pattern):
        inner = _inner(opt_state)
        n_accept += bool(accept)
        assert int(state.updates) == n_accept
        counts = [int(s.count) for name, s in inner.items()
                  if "count" in s._fields]
        assert counts and all(c == n_accept for c in counts), counts
        for k in ("notfinite_count", "total_notfinite", "last_finite"):
            assert int(getattr(state, k)) == int(getattr(opt_state, k)), k
        flat = lambda tree: np.concatenate(
            [np.asarray(tree[k]).reshape(-1) for k in ("w", "b")])
        bufs = state.optimizer.buffers
        if opt == "sgd":
            ref = {"trace": flat(inner["TraceState"].trace)}
        else:
            ref = {"mu": flat(inner["ScaleByAdamState"].mu),
                   "nu": flat(inner["ScaleByAdamState"].nu)}
        for k, v in ref.items():
            np.testing.assert_array_equal(bufs[k].numpy(), v)
        np.testing.assert_array_equal(
            torch.cat([net.w.detach().reshape(-1),
                       net.b.detach().reshape(-1)]).numpy(), flat(jp))
    assert n_accept == 3 + 1 + 16


def test_guard_gives_parameters_without_gradient_a_zero_one():
    """As in the JAX step, every parameter gets a gradient (zero where the
    loss does not reach it), so weight decay moves it."""
    p = torch.nn.Parameter(torch.ones(3))
    sched = TT.lr_schedule(Config(lr=0.1, scheduler="auto"), 1)
    state = TT.TrainState(net=None, optimizer=TT.GuardedOptimizer(
        [p], "adamw", sched))
    assert bool(TT.guarded_update(state))
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - 0.1 * 0.01, rtol=1e-6)


def test_guarded_optimizer_state_round_trip():
    """state_dict / load_state_dict carry the moments and the counters, and
    refuse another optimizer's state or shape."""
    p = torch.nn.Parameter(torch.ones(3))
    a = TT.make_optimizer(Config(), [p])
    p.grad = torch.ones(3)
    a.step()
    b = TT.make_optimizer(Config(), [torch.nn.Parameter(torch.ones(3))])
    b.load_state_dict(a.state_dict())
    for k, v in a.state_dict().items():
        assert torch.equal(b.state_dict()[k], v) if torch.is_tensor(v) \
            else b.state_dict()[k] == v
    with pytest.raises(ValueError, match="adamw state for a sgd"):
        TT.make_optimizer(Config(opt="sgd"), [p]).load_state_dict(
            a.state_dict())
    with pytest.raises(ValueError, match="mu"):
        TT.make_optimizer(Config(), [torch.nn.Parameter(torch.ones(4))]
                          ).load_state_dict(a.state_dict())


def test_trainer_phases_other_than_pretrain_raise(tmp_path):
    """Pretrain, Finetune (one stage) and FinetuneStage (two stages) are
    ported, the last two on every dataset's camera at their own stage
    count, and so is the CycleGAN transfer net; other phases, the
    self-supervised steps at the other stage count, compute dtypes other
    than float32 and bfloat16, and optimizers other than AdamW, Adam and
    SGD raise."""
    from dsf_tpu_torch.mano import synthetic
    path = str(tmp_path / "syn.npz")
    synthetic.save_synthetic_mano(path)
    tr = TT.Trainer(Config(input_size=64), path, device="cpu")
    assert callable(tr.train_step_fn("Pretrain"))
    assert callable(tr.train_step_fn("FinetuneStage"))
    with pytest.raises(ValueError, match="1-stage step"):
        tr.train_step_fn("Finetune")
    one = TT.Trainer(Config(input_size=64, stage_num=1), path, device="cpu")
    assert callable(one.train_step_fn("Finetune"))
    with pytest.raises(ValueError, match="2-stage step"):
        one.train_step_fn("FinetuneStage")
    with pytest.raises(ValueError, match="^CycleGAN$"):
        tr.train_step_fn("CycleGAN")
    for dataset in ("icvl", "msra", "shrec"):
        other = TT.Trainer(Config(dataset=dataset, input_size=64), path,
                           device="cpu")
        assert callable(other.train_step_fn("FinetuneStage"))
        assert other.renderer.paras == CAMERA[dataset][0]
    assert TT.Trainer(Config(input_size=64, transferNet_pth=str(
        tmp_path / "missing.pth")), path, device="cpu").transfer_net is not None
    assert tr.transfer_net is None
    assert TT.Trainer(Config(input_size=64, compute_dtype="bfloat16"), path,
                      device="cpu").dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        TT.Trainer(Config(compute_dtype="float16"), path, device="cpu")
    with pytest.raises(ValueError, match="optimizer 'rmsprop'"):
        TT.make_optimizer(Config(opt="rmsprop"),
                          [torch.nn.Parameter(torch.ones(1))])
