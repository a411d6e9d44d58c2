"""Port parity for training and evaluation off NYU: the self-supervised
losses on ICVL's and MSRA's cameras, the eval step, ``loop.run`` with its
exports, and the skeleton exports of SHREC and DHG, each against the
JAX package on the same weights and inputs.

* the loss tail: FinetuneStage on ICVL's camera and Finetune on MSRA's
  (a real batch with two subjects' cubes), the port's loss and the JAX
  phase on the same net outputs, synth sample and draws (the JAX side
  jits the tail only, not the whole step): loss and metrics to 1e-5
  relative, the outputs' gradients to 1e-4 in relative L2, as
  tests/test_torch_finetune.py holds NYU's, with the loss render's
  pixels that XLA's jitted float32 decides the other way counted and
  taken out;
* the eval step and ``_test_view`` on ICVL (two stages) and MSRA (one),
  within the serving engine's bounds (stage 1 1e-2 mm, stage 2 0.1 mm),
  ICVL's exports with u un-flipped, and ``loop.run`` on each for one
  epoch of two steps;
* ``export_skeletons`` over a SHREC set and ``DHGDataset.write_joints``
  from the eval step's joints, against the JAX package's.

The sets are tests/torch_fake_sets.py's (one render a sequence on the
CPU).  Crops 64^2, train batches of 2, eval batches of 8 (the JAX package shards them over 8 CPU devices).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsf_tpu.config import Config as JConfig
from dsf_tpu.data import datasets as JD
from dsf_tpu.mano import model as JM
from dsf_tpu.mano.constants import transfer_for_dataset
from dsf_tpu.models import torch_import as TI
from dsf_tpu.render import renderer as JR
from dsf_tpu.tools.skeleton_export import export_skeletons as jax_export
from dsf_tpu.training import loop as JL
from dsf_tpu.training import phases as JP
from dsf_tpu.training.trainer import Trainer as JTrainer
from dsf_tpu_torch.config import CAMERA, Config
from dsf_tpu_torch.data import datasets as TD
from dsf_tpu_torch.data.synth_params import random_param_source
from dsf_tpu_torch.mano import synthetic
from dsf_tpu_torch.models.weights import random_reference_state_dict
from dsf_tpu_torch.ops import cloud
from dsf_tpu_torch.render import renderer as rnd
from dsf_tpu_torch.tools.skeleton_export import export_skeletons
from dsf_tpu_torch.training import checkpoints as ckpt
from dsf_tpu_torch.training import loop as TL
from dsf_tpu_torch.training import phases as TP
from dsf_tpu_torch.training.trainer import Trainer
import torch_fake_sets as F
from torch_parity import jax_finetune_stage_draws

torch.set_num_threads(2)

S, B, EVAL_B = 64, 2, 8
N_TRAIN, N_TEST = 4, 3
KEYS = ("img", "xyz_gt", "center", "M", "cube")
STAGE_MM = (1e-2, 0.1)
STAGES = {"icvl": 2, "msra": 1, "shrec": 1}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The stand-ins (ICVL: 4 train and 3 test frames; MSRA: P3 and P7, 2
    frames each, train, P2's 3 frames test; SHREC: 3 frames; DHG: two
    sequences), seeded weights for one and two stages, and the JAX
    trainers, built once each."""
    d = tmp_path_factory.mktemp("data")
    mano = str(d / "mano.npz")
    synthetic.save_synthetic_mano(mano)
    kw = dict(device="cpu", unique=1)
    F.make_icvl(str(d), mano, N_TRAIN, N_TEST, **kw)
    F.make_msra(str(d), mano, {2: (("1",), N_TEST), 3: (("1",), 2),
                               7: (("2",), 2)}, test_id=2, **kw)
    F.make_shrec(str(d), mano, n=3, **kw)
    F.make_dhg(str(d), mano, seqs=((1, 1, 1, 1, 3, 0, 2),
                                   (3, 2, 1, 1, 3, 1, 2)), **kw)
    variables = {n: jax.tree_util.tree_map(np.array, TI.convert_mano_ocr_stage(
        random_reference_state_dict(np.random.RandomState(0), refine=n == 2),
        refine=n == 2)) for n in (1, 2)}
    return dict(dir=d, root=str(d), mano=mano, variables=variables, jax={})


def _kw(env, dataset, **kw):
    base = dict(dataset=dataset, batch_size=EVAL_B, stage_num=STAGES[dataset],
                train_stage="Finetune", input_size=S, root_dir=env["root"],
                mano_model_path=env["mano"], test_id=2, save_result=True,
                save_mesh=True, image_every=0)
    base.update(kw)
    return base


def _jax(env, dataset):
    """The JAX trainer, its config and a state of the seeded weights."""
    if dataset not in env["jax"]:
        cfg = JConfig(**_kw(env, dataset))
        v = env["variables"][STAGES[dataset]]
        env["jax"][dataset] = (
            JTrainer(cfg, env["mano"], steps_per_epoch=1), cfg,
            types.SimpleNamespace(params=v["params"],
                                  batch_stats=v["batch_stats"]))
    return env["jax"][dataset]


def _port(env, dataset, **kw):
    cfg = Config(**_kw(env, dataset, **kw))
    tr = Trainer(cfg, env["mano"], device="cpu")
    return tr, cfg, tr.init_state(env["variables"][STAGES[dataset]])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _real(env, dataset):
    """B unaugmented frames of the train split: ICVL's first two, MSRA's
    last P3 and first P7 frame (cubes 180 and 160)."""
    root = os.path.join(env["root"], dataset)
    if dataset == "icvl":
        ds, idx = TD.ICVLDataset(root, "train", img_size=S), [0, 1]
    else:
        ds, idx = TD.MSRADataset(root, "train", test_persons=2,
                                 img_size=S), [1, 2]
    ds.augment = False
    b = ds._fetch_batch(np.asarray(idx))
    ds.close()
    return b


@pytest.mark.parametrize("dataset, phase", [("icvl", "FinetuneStage"),
                                            ("msra", "Finetune")])
def test_loss_tail_matches_jax(env, dataset, phase):
    """The self-supervised loss after the net, on the dataset's camera
    (synth hands 150-600 mm away), its joint order and error rule (ICVL's
    z bias, MSRA's mean without the wrist), and the real batch's own
    cubes: loss and metrics to 1e-5 relative, the gradients with respect
    to the net's outputs to 1e-4.  Where JAX's jitted loss render finds
    another nearest face on a pixel (XLA's fused float32 code deciding an
    edge the other way; counted, at most 2), the m2d share of those
    pixels is taken out of JAX's m2d and loss, and the MANO output's
    gradient of that stage may move by the pixels' share of the render's
    foreground."""
    stages = STAGES[dataset]
    cfg = Config(**_kw(env, dataset, batch_size=B))
    tr = Trainer(cfg, env["mano"], device="cpu")
    real = _real(env, dataset)
    if dataset == "msra":
        assert real["cube"][:, 0].tolist() == [180.0, 160.0]
    para, cube = next(random_param_source(B, cube_size=cfg.cube_size, seed=0))
    key = jax.random.PRNGKey(0)
    paras, wh = CAMERA[dataset]
    jr = JR.Renderer.create(JM.load_model(env["mano"]), dataset, paras, wh,
                            (S, S))
    assert tuple(jr.depth_range) == tr.renderer.depth_range == (150.0, 600.0)
    draws = jax_finetune_stage_draws(key, B, jr.depth_range, S)
    synth = TP.finetune_stage_sample(tr.renderer, draws,
                                     torch.from_numpy(para),
                                     torch.from_numpy(cube))
    img_r, center_r, cube_r, M_r, xyz_r = [torch.from_numpy(real[k]) for k in
                                           ("img", "center", "cube", "M",
                                            "xyz_gt")]
    net = tr.init_state(env["variables"][stages]).net
    with torch.no_grad():
        outs = net(torch.cat([synth[0], img_r]), tr.renderer,
                   torch.cat([synth[5], center_r]),
                   torch.cat([synth[6], cube_r]), bn_groups=2)
    leaves = [[t.detach().clone().requires_grad_() for t in o] for o in outs]
    loss_fn = TP.finetune_stage_loss if stages == 2 else TP.finetune_loss
    loss, metrics = loss_fn(lambda *a, **k: leaves, tr.renderer, synth,
                            draws.scores, img_r, center_r, cube_r, M_r, xyz_r,
                            cfg)
    loss.backward()

    jcfg = JConfig(**_kw(env, dataset, batch_size=B))
    fixed = tuple(jnp.asarray(x.numpy()) for x in synth)
    jreal = [jnp.asarray(real[k]) for k in ("img", "center", "cube", "M",
                                            "xyz_gt")]
    jloss_fn = JP.finetune_stage_loss if stages == 2 else JP.finetune_loss

    def tail(o):
        return jloss_fn(
            None, {}, key, jnp.asarray(para), jnp.asarray(cube), *jreal, r=jr,
            transfer_fn=None, cfg=jcfg,
            transfer_map=transfer_for_dataset(dataset),
            apply2_fn=lambda *a, **k: (o, {}))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "synth_sample", lambda *a, **k: fixed)
        (j_loss, (_, j_metrics)), j_grads = jax.jit(jax.value_and_grad(
            tail, has_aux=True))([[jnp.asarray(t.detach().numpy()) for t in o]
                                  for o in leaves])
    got = dict({k: float(v) for k, v in metrics.items()}, loss=float(loss))
    ref = dict({k: float(v) for k, v in j_metrics.items()},
               loss=float(j_loss))
    assert set(got) == set(ref) and np.isfinite(got["loss"])
    assert all(got[k] > 0 for k in got if "error" in k)
    flips, fg, shift = _loss_render_flips(tr, jr, leaves, real, stages)
    print(f"{dataset} loss render: pixels whose nearest face differs from "
          f"JAX's jitted render, per stage: {flips}; their m2d share "
          f"{shift}")
    assert max(flips) <= 2
    names = ["m2d_0", "m2d_1"] if stages == 2 else ["m2d"]
    weight = cfg.model_weight * (1.0 if stages == 2 else 0.1)
    expected = dict(ref, loss=ref["loss"] - weight * float(sum(shift)),
                    **{n: ref[n] - float(d) for n, d in zip(names, shift)})
    for k in ref:
        np.testing.assert_allclose(got[k], expected[k], rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    for st in range(stages):
        for i in range(2):
            g, r = leaves[st][i].grad.numpy(), np.asarray(j_grads[st][i])
            tol = 1e-4 + (flips[st] / fg[st] if i == 1 else 0.0)
            assert np.abs(r).max() > 0 and _rel(g, r) <= tol, (st, i,
                                                               _rel(g, r))


def _loss_render_flips(tr, jr, leaves, real, stages):
    """The loss render of the real outputs (both stages' stacked for
    FinetuneStage), the port's against the JAX package's jitted one as
    its tail runs it: XLA's fused float32 code can decide a pixel on a
    face's edge the other way, so another face is nearest there (JAX's
    own eager run decides as the port does).  Returns per stage the
    count of such pixels (depths more than 1e-3 apart), the render's
    foreground pixels, and the m2d those pixels move (m2d from JAX's
    render less m2d from it with the port's depth at those pixels)."""
    r = tr.renderer
    t = {k: torch.from_numpy(real[k]) for k in ("img", "center", "cube", "M")}
    rep = lambda x: torch.cat([x] * stages)
    para = torch.cat([o[1][B:].detach() for o in leaves])
    with torch.no_grad():
        port = rnd.render_params(r, para, rep(t["center"]), rep(t["cube"]))[0]
    jimg = torch.from_numpy(np.asarray(jax.jit(
        lambda p, c, k: JR.render_params(jr, p, c, k)[0])(
            *(jnp.asarray(x.numpy()) for x in (para, rep(t["center"]),
                                                rep(t["cube"]))))))
    flipped = (port - jimg).abs() > 1e-3
    # the crop box: the joints of the last stage's MANO (the teacher, or
    # the one-stage net's own)
    box = rnd.get_mesh_xyz(r, leaves[-1][1][B:].detach())[0]
    crop = lambda img, k: cloud.crop_hand(img, rep(box) if k else box,
                                          rep(t["center"]) if k else
                                          t["center"], rep(t["M"]) if k
                                          else t["M"], rep(t["cube"]) if k
                                          else t["cube"], r.paras, S,
                                          flip=r.flip)
    crop_real = rep(crop(t["img"], False))

    def m2d(img):
        v = TP._m2d(crop_real, crop(img, True), masked_numerator=stages == 2)
        return v.reshape(stages, B).mean(1) * (0.1 if stages == 2 else 1.0)

    shift = (m2d(jimg) - m2d(torch.where(flipped, port, jimg))).numpy()
    per = lambda m: m.reshape(stages, -1).sum(1).tolist()
    return per(flipped), per(port < 0.99), shift


def _eval_batch(env, dataset):
    ds = TL._test_dataset(Config(**_kw(env, dataset)))
    b = next(ds.batches(EVAL_B, drop_last=False))
    ds.close()
    pad = EVAL_B - len(b["img"])
    return {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
            for k, v in b.items() if k in KEYS}


@pytest.mark.parametrize("dataset", ["icvl", "msra"])
def test_eval_step_matches_jax(env, dataset):
    """The eval step's per-sample errors (pixel and MANO per stage, on
    the dataset's joint order and error rule) and joints on the test
    split's first batch (its 3 frames padded to 8), within the engine's
    bounds of the JAX eval step's."""
    jtr, _, jstate = _jax(env, dataset)
    batch = _eval_batch(env, dataset)
    jerr, jres = jtr.eval_step_fn()(jstate.params, jstate.batch_stats,
                                    {k: jnp.asarray(v) for k, v in
                                     batch.items()})
    tr, _, state = _port(env, dataset)
    err, res = tr.eval_step_fn()(state, batch)
    err = err.numpy()
    assert err.shape == (2 * STAGES[dataset], EVAL_B) and np.isfinite(err).all()
    for stage in range(STAGES[dataset]):
        tol = STAGE_MM[stage]
        np.testing.assert_allclose(err[2 * stage:2 * stage + 2],
                                   np.asarray(jerr)[2 * stage:2 * stage + 2],
                                   atol=tol, rtol=0)
        for k in ("joint_xyz", "mano_joint_xyz"):
            np.testing.assert_allclose(res[f"{k}_{stage}"].numpy(),
                                       np.asarray(jres[f"{k}_{stage}"]),
                                       atol=tol / 100.0, rtol=0)


@pytest.mark.parametrize("dataset", ["icvl", "msra"])
def test_loop_runs_and_exports_match_jax(env, dataset, tmp_path, monkeypatch):
    """loop.run on the CPU for one epoch of two steps (FinetuneStage on
    ICVL, Finetune on MSRA) leaves train.log, latest, best and one view's
    result_0/1 with a row per test frame; and the test view's exports on
    the seeded weights match the JAX package's _test_view within 0.1 px
    in u and v and 0.1 mm in d (ICVL's u un-flipped on both sides), its
    mean errors within 0.1 mm."""
    monkeypatch.setattr(Config, "max_epoch", property(lambda self: 1))
    run_dir = TL.run(Config(**_kw(env, dataset, batch_size=B,
                                  save_dir=str(tmp_path / "ckpt"),
                                  save_mesh=False)), device="cpu")
    log = open(os.path.join(run_dir, "train.log")).read()
    assert "Epoch#0:" in log and "test:" in log
    for name in ("latest", "best"):
        assert os.path.exists(os.path.join(run_dir, name, ckpt.FILE))
    assert torch.load(os.path.join(run_dir, "latest", ckpt.FILE),
                      weights_only=True)["step"] == 2
    for i in (0, 1):
        rows = np.loadtxt(os.path.join(run_dir, f"result_{i}_0.txt"))
        assert rows.shape == (N_TEST, 63) and np.isfinite(rows).all()
    assert not os.path.exists(os.path.join(run_dir, "result_0_1.txt"))

    jtr, jcfg, jstate = _jax(env, dataset)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir(), tdir.mkdir()
    jerr = JL._test_view(jtr, jstate, jcfg, 0, str(jdir))
    tr, cfg, state = _port(env, dataset)
    terr = TL._test_view(tr, state, cfg, 0, str(tdir))
    np.testing.assert_allclose(terr, jerr, atol=0.1, rtol=0)
    for i in (0, 1):
        got = np.loadtxt(tdir / f"result_{i}_0.txt").reshape(N_TEST, -1, 3)
        ref = np.loadtxt(jdir / f"result_{i}_0.txt").reshape(N_TEST, -1, 3)
        np.testing.assert_allclose(got, ref, atol=0.1 + 1e-3, rtol=0)
    s = 2 * STAGES[dataset] - 1
    for name in (f"mesh_result_{s}_0.txt", f"MANO_result_{s}_0.txt"):
        assert np.loadtxt(tdir / name).shape == np.loadtxt(jdir / name).shape


def test_skeleton_exports_match_jax(env):
    """export_skeletons over the SHREC set (one sequence of 3 frames,
    batches of 8) and DHGDataset.write_joints from the eval step's MANO
    joints in world mm, each against the JAX package's on the same
    weights: within the engine's stage-1 bound (1e-2 mm, plus the files'
    rounding).  export_skeletons refuses a DHG set, whose samples carry
    no sequence directory."""
    jtr, _, jstate = _jax(env, "shrec")
    tr, _, state = _port(env, "shrec")
    root = os.path.join(env["root"], "shrec")
    seqs = export_skeletons(tr, state, TD.SHRECDataset(root, img_size=S),
                            batch_size=EVAL_B, out_name="port.txt")
    jseqs = jax_export(jtr, jstate, JD.SHRECDataset(root, img_size=S),
                       batch_size=EVAL_B, out_name="jax.txt")
    assert seqs == jseqs and len(seqs) == 1
    got = np.loadtxt(os.path.join(seqs[0], "port.txt"))
    ref = np.loadtxt(os.path.join(seqs[0], "jax.txt"))
    assert got.shape == (3, 63) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-2 + 1e-4, rtol=0)

    dhg = os.path.join(env["root"], "dhg")
    tds, jds = TD.DHGDataset(dhg, img_size=S), JD.DHGDataset(dhg, img_size=S)
    with pytest.raises(ValueError, match="write_joints"):
        export_skeletons(tr, state, tds, batch_size=EVAL_B)
    step, jstep = tr.eval_step_fn(), jtr.eval_step_fn()
    preds, jpreds = [], []
    b = next(tds.batches(len(tds)))
    assert len(tds) == 5 and len(b["img"]) == 5
    for s in range(0, 5, EVAL_B):
        idx = np.minimum(np.arange(s, s + EVAL_B), 4)
        tb = {k: b[k][idx] for k in KEYS}
        jb = {k: jnp.asarray(np.stack([jds[i][k] for i in idx])) for k in KEYS}
        _, res = step(state, tb)
        _, jres = jstep(jstate.params, jstate.batch_stats, jb)
        for out, r, bb in ((preds, res["mano_joint_xyz_0"].numpy(), tb),
                           (jpreds, np.asarray(jres["mano_joint_xyz_0"]),
                            jb)):
            out.append((r * np.asarray(bb["cube"])[:, None] / 2.0
                        + np.asarray(bb["center"])[:, None])[:min(EVAL_B,
                                                                  5 - s)])
    assert tds.write_joints(np.concatenate(preds), "port.txt") == \
        jds.write_joints(np.concatenate(jpreds), "jax.txt") == 5
    for seq in tds.sequences:
        got = np.loadtxt(os.path.join(seq["dir"], "port.txt"), ndmin=2)
        ref = np.loadtxt(os.path.join(seq["dir"], "jax.txt"), ndmin=2)
        assert got.shape == (seq["end"] - seq["start"] + 1, 63)
        np.testing.assert_allclose(got, ref, atol=1e-2 + 1e-7, rtol=0)
