"""The port's training steps and loop over two gloo ranks on the CPU
(tests/torch_parallel_workers.py), held against the port's own world-1
run, which the step tests (test_torch_train_step.py,
test_torch_finetune.py, test_torch_finetune_stage.py) hold against JAX.

Every rank takes its own rows of the global batch (synth parameters,
draws and the real batch), so per-rank BatchNorm statistics, a local
masked count, a local finite test or a gradient that is not averaged
would each move the results away from world 1's.
"""

import os

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from dsf_tpu.data.fake import make_fake_nyu
from dsf_tpu.mano import synthetic as JS
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.training import checkpoints as ckpt
from dsf_tpu_torch.training import loop as TL
from dsf_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)

S, B = 64, 4            # crops, global batch (two rows a rank)
BASE = dict(dataset="nyu", batch_size=B, input_size=S, stage_num=2)
PHASES = [("Pretrain", BASE), ("Finetune", dict(BASE, stage_num=1)),
          ("FinetuneStage", BASE)]
# the mutation the tolerances must catch: BatchNorm on each rank's own rows
LOCAL_BN = ("local", "Pretrain", BASE, True)


@pytest.fixture(scope="module")
def mano(tmp_path_factory):
    return JS.save_synthetic_mano(str(tmp_path_factory.mktemp("m") / "m.npz"))


@pytest.fixture(scope="module")
def steps(mano, tmp_path_factory):
    runs = [(p, p, kw, False) for p, kw in PHASES]
    two = W.run_world("steps", 2, dict(mano=mano, runs=runs + [LOCAL_BN],
                                       fsdp=BASE, remat=("FinetuneStage",)),
                      str(tmp_path_factory.mktemp("w")), timeout=900)
    return W.steps(dict(mano=mano, runs=runs)), two


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _stage2(name):
    return "_s2" in name or name.startswith("fusion")


def _compare(one, two):
    """(loss relative distance, worst metric distance over its scale, mean
    gradient's relative L2, worst stage-1 and stage-2 running statistic
    over its scale) of a two-rank step from world 1's."""
    m1, m2 = one["metrics"], two[0]["metrics"]
    g2 = (two[0]["grad"] + two[1]["grad"]) / 2
    stats = {True: [0.0], False: [0.0]}
    for name, ref in one["stats"].items():
        stats[_stage2(name)].append(float(
            np.abs(two[0]["stats"][name] - ref).max() / np.abs(ref).max()))
    return (abs(m2["loss"] - m1["loss"]) / abs(m1["loss"]),
            max(abs(m2[k] - v) / max(abs(v), 1e-3) for k, v in m1.items()),
            _rel(g2, one["grad"]), max(stats[False]), max(stats[True]))


@pytest.mark.parametrize("phase", [p for p, _ in PHASES])
def test_step_over_two_ranks_is_world_one(steps, phase):
    """One step on two ranks, each with two of the four rows, against
    world 1 on all four: the loss (the ranks' mean) within 2e-4 relative,
    every metric within 2e-3 of its scale, the ranks' mean flat gradient
    within 5e-2 relative L2 (1e-3 for the one-stage Finetune), the
    BatchNorm running statistics (the same on both ranks) within 1e-4 of
    each tensor's scale in stage 1 and 1e-2 in stage 2, and the
    parameters after the update the same on both ranks.

    The one-stage step meets 1e-5, 1e-4 and 1e-5 (measured 2.3e-7,
    1.6e-4, 1.0e-5).  The two-stage net re-renders its stage-1 MANO
    inside the forward, a raster discontinuous in those parameters, and a
    rank's batch of two rows rounds its convolutions and its LBS
    otherwise than a batch of four (oneDNN blocks by the batch: the
    render's joints lie 4.8e-7 apart, the engine's outputs 1e-7 of their
    scale), so stage 2 sees another render at a few edge pixels: measured
    loss 8.0e-5 and 2.2e-5, gradient 1.6e-2, statistics 3.2e-5 in stage 1
    and 2.6e-3 in stage 2 (the step tests hold the port against JAX with the same split of
    stage 1 and 2).  BatchNorm on each rank's own rows, the mutation,
    lies 6e-3 (loss), 0.19 (gradient) and 0.21 (statistics) away, and
    fails every bound (``test_rank_local_batch_norm_is_caught``)."""
    one, two = steps[0][phase], [r[phase] for r in steps[1]]
    loss, metric, grad, st1, st2 = _compare(one, two)
    for t in two:
        assert t["metrics"].keys() == one["metrics"].keys()
        assert t["metrics"] == two[0]["metrics"]
        for name in one["stats"]:
            assert np.array_equal(t["stats"][name], two[0]["stats"][name])
    assert np.isfinite(two[0]["grad"]).all()
    assert loss <= 2e-4 and metric <= 2e-3, (loss, metric)
    assert grad <= (1e-3 if phase == "Finetune" else 5e-2), grad
    assert st1 <= 1e-4 and st2 <= 1e-2, (st1, st2)
    # each rank's own gradient is not the global one
    assert _rel(two[0]["grad"], one["grad"]) > 1e-2
    assert np.array_equal(two[0]["params"], two[1]["params"])


def test_rank_local_batch_norm_is_caught(steps):
    """Mutation check: the Pretrain step with each rank's BatchNorm on its
    own rows (``net.sync`` unset) breaks every bound above."""
    loss, metric, grad, st1, st2 = _compare(
        steps[0]["Pretrain"], [r["local"] for r in steps[1]])
    assert loss > 1e-3 and grad > 0.1 and st1 > 1e-2, (loss, grad, st1)


def test_remat_over_two_ranks_is_bitwise(steps):
    """DSF_REMAT=1 on two ranks: the FinetuneStage step (two BatchNorm
    groups, statistics over both ranks' rows) gives each rank the metrics,
    gradient, running statistics and parameters of DSF_REMAT=0 bitwise.
    The recompute in the backward pass runs each BatchNorm with its
    forward's groups and global statistics (an all-reduce on both ranks)
    and takes no second update of the running statistics."""
    for r in steps[1]:
        a, b = r["FinetuneStage"], r["FinetuneStage_remat"]
        assert a["metrics"] == b["metrics"]
        for k in ("grad", "params"):
            assert np.array_equal(a[k], b[k]), k
        for name, v in a["stats"].items():
            assert np.array_equal(v, b["stats"][name]), name


def test_fsdp_two_equals_data_parallel(steps):
    """Two Pretrain steps with ``n_fsdp=2`` (the AdamW moments in two
    shards, the gradient reduce-scattered, the parameters all-gathered)
    leave every parameter and the gathered moments bitwise those of the
    data-parallel run on the same ranks (a sum of two is the same sum in
    either collective)."""
    for r in steps[1]:
        assert np.array_equal(r["fsdp2"]["params"], r["fsdp1"]["params"])
        for k, v in r["fsdp1"]["moments"].items():
            assert np.array_equal(r["fsdp2"]["moments"][k], v), k
    assert np.array_equal(steps[1][0]["fsdp2"]["params"],
                          steps[1][1]["fsdp2"]["params"])


@pytest.fixture(scope="module")
def fake_nyu(mano, tmp_path_factory):
    d = tmp_path_factory.mktemp("nyu")
    make_fake_nyu(str(d / "data"), mano, n_train=8, n_test=6)
    return d


def _loop_cfg(d, mano, **kw):
    return dict(dataset="nyu", batch_size=B, stage_num=1,
                train_stage="Finetune", input_size=S, root_dir=str(d / "data"),
                mano_model_path=mano, save_result=True, save_mesh=True,
                image_every=0, opt="sgd", save_dir=str(d / "ckpt"), **kw)


def test_loop_over_two_ranks_writes_world_ones_run(fake_nyu, mano,
                                                   monkeypatch):
    """``loop.run`` on a fake NYU set (8 train frames, 6 test frames in 3
    views), one epoch of two Finetune steps at the global batch of 4, SGD
    (its update is continuous in the gradient), test during train: two
    ranks with ``n_fsdp=2``, where a write by rank 1 under the save
    directory raises, leave world 1's run: ``latest`` and ``best`` with
    the same step, epoch and update count, the parameters and running
    statistics within 1e-4 of each tensor's scale (measured 4.1e-5: two
    updates of gradients 1.6e-4 apart in relative L2, as the step test
    measures), the momentum within 1e-3 relative L2, and every view's
    result, mesh and MANO files with world 1's six rows in dataset order
    (the tail of two padded and striped) within 1e-3 of their scale.  The
    checkpoint written under ``n_fsdp=2`` holds whole buffers and
    restores into a world-1 trainer."""
    monkeypatch.setattr(Config, "max_epoch", property(lambda self: 1))
    one = TL.run(Config(**_loop_cfg(fake_nyu, mano, add_info="one")),
                 device="cpu")
    two = W.run_world("loop_run", 2, dict(epochs=1, cfg=_loop_cfg(
        fake_nyu, mano, add_info="two", n_fsdp=2)),
        str(fake_nyu / "w"), timeout=900)
    assert two[0] == two[1] and two[0] != one
    for which in ("latest", "best"):
        a = torch.load(os.path.join(two[0], which, ckpt.FILE),
                       weights_only=True)
        b = torch.load(os.path.join(one, which, ckpt.FILE),
                       weights_only=True)
        assert (a["step"], a["epoch"]) == (b["step"], b["epoch"]) == (2, 0)
        assert int(a["optimizer"]["count"]) == int(b["optimizer"]["count"])
        for part in ("net", "optimizer"):
            for k, v in b[part].items():
                if not torch.is_tensor(v) or not v.is_floating_point():
                    assert a[part][k] == v if not torch.is_tensor(v) \
                        else torch.equal(a[part][k], v), k
                    continue
                if part == "net":
                    np.testing.assert_allclose(
                        a[part][k].numpy(), v.numpy(), rtol=0,
                        atol=1e-4 * float(v.abs().max()) + 1e-12, err_msg=k)
                else:
                    assert _rel(a[part][k].numpy(), v.numpy()) < 1e-3, k
    names = sorted(f for f in os.listdir(one) if f.endswith(".txt"))
    assert names == sorted(f for f in os.listdir(two[0]) if f.endswith(".txt"))
    assert len(names) == 3 * 5      # result_0/1, mesh, MANO, coll per view
    for name in names:
        if name.startswith("coll"):
            continue
        a = np.loadtxt(os.path.join(two[0], name))
        b = np.loadtxt(os.path.join(one, name))
        assert a.shape == b.shape and len(b) == 6, name
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-3 * np.abs(b).max() + 2e-3,
                                   err_msg=name)
    assert os.path.exists(os.path.join(two[0], "train.log"))

    tr = Trainer(Config(**_loop_cfg(fake_nyu, mano)), mano, device="cpu")
    state, epoch = ckpt.restore(os.path.join(two[0], "latest"), tr,
                                tr.init_state())
    saved = torch.load(os.path.join(two[0], "latest", ckpt.FILE),
                       weights_only=True)
    assert epoch == 1 and state.step == 2
    for k, v in state.optimizer.state_dict().items():
        assert torch.equal(v, saved["optimizer"][k]) if torch.is_tensor(v) \
            else v == saved["optimizer"][k], k
    for k, v in state.net.state_dict().items():
        assert torch.equal(v, saved["net"][k]), k


def test_resume_over_two_ranks_continues_bitwise(fake_nyu, mano):
    """Two ranks with ``n_fsdp=2``: ``loop.run`` for two epochs, its
    epoch-0 ``latest`` kept as it is saved, and a run resumed from that
    checkpoint for the second epoch under two ranks (every rank restores
    the whole buffers to its shard, the loop starts at epoch 1 with that
    epoch's seeds): the resumed run's ``latest`` is the uninterrupted
    run's bitwise (parameters, running statistics, moments, the guard's
    counters, step and epoch), and so are its exports, as a world-1
    resume is (test_torch_eval_loop.py)."""
    snap = fake_nyu / "two_epoch0"
    cfg = dict(test_during_train=False, n_fsdp=2)
    whole, resumed = W.run_world("loop_run", 2, dict(
        epochs=2, keep_epoch0=str(snap),
        cfg=_loop_cfg(fake_nyu, mano, add_info="two_whole", **cfg),
        resume=_loop_cfg(fake_nyu, mano, add_info="two_resumed",
                         load_model=str(snap), **cfg)),
        str(fake_nyu / "w_resume"), timeout=900)[0]
    saved = torch.load(os.path.join(snap, "latest", ckpt.FILE),
                       weights_only=True)
    assert (saved["step"], saved["epoch"]) == (2, 0)
    log = open(os.path.join(resumed, "train.log")).read()
    assert "Epoch#1:" in log and "Epoch#0:" not in log
    a, b = (torch.load(os.path.join(d, "latest", ckpt.FILE),
                       weights_only=True) for d in (resumed, whole))
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"]) == (4, 1)
    for part in ("net", "optimizer"):
        assert a[part].keys() == b[part].keys()
        for k, v in b[part].items():
            assert torch.equal(a[part][k], v) if torch.is_tensor(v) \
                else a[part][k] == v, (part, k)
    names = sorted(f for f in os.listdir(whole) if f.endswith(".txt"))
    assert len(names) == 3 * 5
    assert names == sorted(f for f in os.listdir(resumed)
                           if f.endswith(".txt"))
    for name in names:
        assert open(os.path.join(resumed, name)).read() == \
            open(os.path.join(whole, name)).read(), name
