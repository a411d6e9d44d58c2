"""The port's training steps and loop over two gloo ranks on the CPU
(tests/torch_parallel_workers.py), held against the port's own world-1
run, which the step tests (test_torch_train_step.py,
test_torch_finetune.py, test_torch_finetune_stage.py) hold against JAX.

Every rank takes its own rows of the global batch (synth parameters,
draws and the real batch), so per-rank BatchNorm statistics, a local
masked count, a local finite test or a gradient that is not averaged
would each move the results away from world 1's.
"""

import functools
import os
import shutil

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from dsf_tpu.data.fake import make_fake_nyu
from dsf_tpu.mano import synthetic as JS
from dsf_tpu_torch.config import Config, net_depth
from dsf_tpu_torch.models.backbone import ManoOCRStage
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
BF16 = dict(BASE, stage_num=1, compute_dtype="bfloat16")
DEEP = dict(BASE, input_size=32, stage_num=1, net="ResNet_stage_50")
# ZeRO-3 (n_fsdp=2) against data parallelism (n_fsdp=1) on the same ranks:
# (label of the data-parallel run, label of the ZeRO-3 run)
ZERO3 = [("Finetune", "Finetune_z3"),
         ("FinetuneStage", "FinetuneStage_z3_remat"),
         ("Finetune_bf16", "Finetune_bf16_z3_remat"),
         ("Pretrain_d50", "Pretrain_d50_z3_remat")]


@pytest.fixture(scope="module")
def mano(tmp_path_factory):
    return JS.save_synthetic_mano(str(tmp_path_factory.mktemp("m") / "m.npz"))


@pytest.fixture(scope="module")
def steps(mano, tmp_path_factory):
    """World 1's step of each phase, and the two-rank world: each phase's
    step, the local-BatchNorm control, DSF_REMAT, the ZeRO-3 runs of
    ZERO3 and their data-parallel partners, two Pretrain steps under
    n_fsdp 1 and 2 (each writing a checkpoint after the first and
    evaluating after the second), and the second step resumed from the
    n_fsdp=2 checkpoint under n_fsdp 1 and 2 (the latter writing its
    state and evaluating it); world 1 evaluates that state too.  The runs
    added for ZeRO-3 bring back digests of their large arrays
    (``W.digest``).  The checkpoints are read into memory and deleted
    (0.4 GB each)."""
    runs = [(p, p, kw, False) for p, kw in PHASES]
    w = tmp_path_factory.mktemp("w")
    saved = {n: str(w / f"ckpt{n}") for n in (1, 2, 3)}
    d = dict(digests=True)
    z3, z3_remat = dict(d, n_fsdp=2), dict(d, n_fsdp=2, remat=True)
    two_steps = dict(d, steps=2, seed=3, evaluate=True)
    zero3 = [("Finetune_z3", "Finetune", PHASES[1][1], False, z3),
             ("FinetuneStage_z3_remat", "FinetuneStage", BASE, False,
              z3_remat),
             ("Finetune_bf16", "Finetune", BF16, False, d),
             ("Finetune_bf16_z3_remat", "Finetune", BF16, False, z3_remat),
             ("Pretrain_d50", "Pretrain", DEEP, False, d),
             ("Pretrain_d50_z3_remat", "Pretrain", DEEP, False, z3_remat),
             ("fsdp1", "Pretrain", BASE, False,
              dict(two_steps, save=saved[1])),
             ("fsdp2", "Pretrain", BASE, False,
              dict(two_steps, n_fsdp=2, save=saved[2])),
             ("resume1", "Pretrain", BASE, False,
              dict(d, seed=3, skip=1, load=saved[2])),
             ("resume2", "Pretrain", BASE, False,
              dict(z3, seed=3, skip=1, load=saved[2], save=saved[3],
                   evaluate=True))]
    world = W.World("steps", 2, dict(
        mano=mano, runs=runs + [LOCAL_BN] + zero3, remat=("FinetuneStage",)),
        str(w), timeout=900)
    one = W.steps(dict(mano=mano, runs=runs))      # while the ranks run
    two = world.wait()
    one["eval"] = W.step_run(mano, "Pretrain", BASE, steps=0,
                             load=saved[3], evaluate=True)
    files = {n: torch.load(os.path.join(saved[n], ckpt.FILE),
                           weights_only=True) for n in (1, 2)}
    for p in saved.values():
        shutil.rmtree(p)
    return one, two, files


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


def _d(x):
    """A large array as its digest (``W.digest``); a digest as it is."""
    return x if isinstance(x, str) else W.digest(x)


def _zero3_is_data_parallel(two, dp, z3):
    """Each rank's ZeRO-3 run ``z3`` against the data-parallel run ``dp``
    on the same ranks and inputs: every step's loss, the metrics, the
    parameters, the gathered moments, the guard's counters and the
    running statistics after the steps bitwise, and the mean gradient the
    optimizer read bitwise the ranks' mean of their own."""
    mean = [r[dp].get("mean_grad") for r in two]
    if mean[0] is None:
        mean = [(two[0][dp]["grad"] + two[1][dp]["grad"]) / np.float32(2)] * 2
    for r, m in zip(two, mean):
        a, b = r[dp], r[z3]
        assert b["loss"] == a["loss"] and b["metrics"] == a["metrics"]
        assert _d(b["params"]) == _d(a["params"])
        assert a["moments"].keys() == b["moments"].keys() == {"mu", "nu"}
        for k, v in a["moments"].items():
            assert _d(b["moments"][k]) == _d(v), k
        assert b["counters"] == a["counters"]
        assert a["stats"].keys() == b["stats"].keys()
        for name, v in a["stats"].items():
            assert _d(b["stats"][name]) == _d(v), name
        assert _d(b["mean_grad"]) == _d(m)


def test_fsdp_two_equals_data_parallel(steps):
    """Two Pretrain steps with ``n_fsdp=2`` (ZeRO-3: the parameters and
    the AdamW moments in two pieces, each unit gathered for its forward
    and its backward, its gradient reduce-scattered) leave the losses,
    every parameter, the gathered moments, the guard's counters and the
    running statistics bitwise those of the data-parallel run on the
    same ranks (a sum of two is the same sum in either collective)."""
    _zero3_is_data_parallel(steps[1], "fsdp1", "fsdp2")
    assert len(steps[1][0]["fsdp2"]["loss"]) == 2
    assert steps[1][0]["fsdp2"]["params"] == steps[1][1]["fsdp2"]["params"]


@pytest.mark.parametrize("dp,z3", ZERO3, ids=[z for _, z in ZERO3])
def test_zero3_step_is_data_parallel(steps, dp, z3):
    """ZeRO-3 against data parallelism, one step: Finetune in float32;
    FinetuneStage with DSF_REMAT=1 (each unit gathered again for the
    recompute) against DSF_REMAT=0 (which test_remat_over_two_ranks_is_
    bitwise holds to DSF_REMAT=1), in float32; Finetune in bfloat16 with
    DSF_REMAT=1 (the per-layer casts read the gathered float32
    parameters); and a one-stage Pretrain step at depth 50 and 32^2 with
    DSF_REMAT=1: bitwise in every reading."""
    _zero3_is_data_parallel(steps[1], dp, z3)


@functools.lru_cache(maxsize=None)
def _unit_sizes(depth, refine):
    net = ManoOCRStage(depth=depth, refine=refine)
    return tuple(sum(p.numel() for p in u.parameters())
                 for u in net.fsdp_units())


def _piece_bytes(kw, n_fsdp):
    """A rank's parameter storage under ``n_fsdp``: the units' pieces
    (1/n_fsdp of each unit, rounded up), float32."""
    sizes = _unit_sizes(net_depth(Config(**kw)), kw["stage_num"] == 2)
    return 4 * sum(-(-n // n_fsdp) for n in sizes)


def test_zero3_holds_the_pieces_alone(steps):
    """Under ``n_fsdp=2`` each rank's parameter storages hold its pieces
    alone after init_state, after each step and after a restore (at
    depth 18 128.3 MB whole, 64.2 MB in pieces; the one-stage net at
    depth 50 136.5 MB and 68.3 MB), where the data-parallel runs hold the
    whole parameters;
    at most two units are whole at once (one in its backward, one
    gathered by a recompute)."""
    kws = {"Finetune": PHASES[1][1], "Finetune_z3": PHASES[1][1],
           "Finetune_bf16": BF16, "Finetune_bf16_z3_remat": BF16,
           "Pretrain_d50": DEEP, "Pretrain_d50_z3_remat": DEEP}
    seen = 0
    for r in steps[1]:
        for label, run in r.items():
            z3 = "peak_held" in run
            want = _piece_bytes(kws.get(label, BASE), 2 if z3 else 1)
            assert run["bytes"] == [want] * len(run["bytes"]), label
            if z3:
                seen += 1
                assert 1 <= run["peak_held"] <= 2, label
    assert seen == 2 * 6
    assert (_piece_bytes(BASE, 1), _piece_bytes(BASE, 2)) == (128344464,
                                                             64172240)
    assert (_piece_bytes(DEEP, 1), _piece_bytes(DEEP, 2)) == (136544584,
                                                             68272296)


def test_zero3_checkpoint_is_world_ones_and_resumes(steps):
    """The checkpoint written under ``n_fsdp=2`` after the first Pretrain
    step is the data-parallel run's, bitwise (whole parameters, running
    statistics, moments, counters, step and epoch: world 1's layout), and
    restored under ``n_fsdp`` 1 and 2 the second step continues bitwise
    as the uninterrupted ZeRO-3 run."""
    files = steps[2]
    assert files[1].keys() == files[2].keys()
    assert (files[2]["step"], files[2]["epoch"]) == (1, 0)
    assert files[2]["optimizer"]["mu"].shape == (128344464 // 4,)
    for part in ("net", "optimizer"):
        assert files[1][part].keys() == files[2][part].keys()
        for k, v in files[1][part].items():
            assert torch.equal(files[2][part][k], v) if torch.is_tensor(v) \
                else files[2][part][k] == v, (part, k)
    for r in steps[1]:
        whole = r["fsdp2"]
        for label in ("resume1", "resume2"):
            run = r[label]
            assert run["loss"] == whole["loss"][1:], label
            for k in ("params", "moments", "counters", "stats"):
                assert run[k] == whole[k], (label, k)


def test_zero3_eval_is_world_ones(steps):
    """The eval step under ``n_fsdp=2`` (each unit gathered for its
    forward, no gradient) gives each rank the errors and outputs of the
    data-parallel run's eval bitwise, and of the resumed run's (the same
    state).  On that state, the two ranks' rows are world 1's eval of all
    four rows within 1e-4 mm (errors) and 1e-5 of each output's scale:
    eval mode is row by row, but a batch of two rows rounds its
    convolutions otherwise than four."""
    one, two = steps[0], steps[1]
    for r in two:
        a = r["fsdp1"]["eval"]
        for label in ("fsdp2", "resume2"):
            b = r[label]["eval"]
            assert a.keys() == b.keys()
            for k, v in a.items():
                assert np.array_equal(b[k], v), (label, k)
    ref = one["eval"]["eval"]
    for k, v in ref.items():
        got = np.concatenate([r["resume2"]["eval"][k] for r in two],
                             axis=-1 if k == "errors" else 0)
        assert got.shape == v.shape, k
        tol = 1e-4 if k == "errors" else 1e-5 * np.abs(v).max()
        np.testing.assert_allclose(got, v, rtol=0, atol=tol, err_msg=k)


def test_zero3_state_dict_outside_a_gather_raises(steps):
    """``net.state_dict()`` and ``net.load_state_dict()`` of a sharded
    net raise (they would read or write freed storage);
    ``parallel.fsdp.state_dict`` and ``load_state_dict`` are the ways in
    and out."""
    for r in steps[1]:
        for label, run in r.items():
            if "peak_held" in run:
                assert len(run["raised"]) == 2, label
                assert all("sharded over n_fsdp=2" in m
                           for m in run["raised"]), label


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
    world = W.World("loop_run", 2, dict(epochs=1, cfg=_loop_cfg(
        fake_nyu, mano, add_info="two", n_fsdp=2)),
        str(fake_nyu / "w"), timeout=900)
    one = TL.run(Config(**_loop_cfg(fake_nyu, mano, add_info="one")),
                 device="cpu")                  # while the ranks run
    two = world.wait()
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
