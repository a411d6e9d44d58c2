"""Port parity for the trainer's evaluation and its loop: the eval step
(per-sample pixel and MANO errors per stage, the exported joints) and
``xyz2error_mm``'s dataset options against the JAX package, in float32
and bfloat16, and the port's ``loop.run`` end to end on the CPU over a
fake NYU set (the artifacts of tests/test_loop_e2e.py, a resume that
continues bitwise as the uninterrupted run, and the 3-view exports
against the JAX package's ``_test_view`` on the same weights).  The fake
set, the JAX trainers and their compiled eval steps are built once for
the module (``setup``, ``_jax_trainer``).

Shapes follow test_loop_e2e.py (input 64, eval batch 8), so the
persistent JAX cache can serve the JAX eval step.  The port's loop runs
at B=2 (two steps over four train frames) to keep the CPU time small.
"""

import os
import shutil
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dsf_tpu.config import Config as JConfig
from dsf_tpu.data import datasets as JD
from dsf_tpu.data.fake import make_fake_nyu
from dsf_tpu.mano import synthetic as JS
from dsf_tpu.models import torch_import as TI
from dsf_tpu.parallel import mesh as pmesh
from dsf_tpu.serving import InferenceEngine as JEngine
from dsf_tpu.training import loop as JL
from dsf_tpu.training import phases as JP
from dsf_tpu.training.trainer import Trainer as JTrainer
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.models.weights import random_reference_state_dict
from dsf_tpu_torch.serving import InferenceEngine
from dsf_tpu_torch.training import checkpoints as ckpt
from dsf_tpu_torch.training import loop as TL
from dsf_tpu_torch.training import phases as TP
from dsf_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)

S, EVAL_B, N_TRAIN, N_TEST = 64, 8, 4, 6
KEYS = ("img", "xyz_gt", "center", "M", "cube")
# the serving engine's bounds (tests/test_torch_serving.py), in mm
STAGE_MM = (1e-2, 0.1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop")
    mano = JS.save_synthetic_mano(str(d / "mano.npz"))
    make_fake_nyu(str(d / "data"), mano, n_train=N_TRAIN, n_test=N_TEST)
    variables = TI.convert_mano_ocr_stage(
        random_reference_state_dict(np.random.RandomState(0)), refine=True)
    kw = dict(dataset="nyu", batch_size=EVAL_B, stage_num=2,
              train_stage="Finetune", input_size=S, root_dir=str(d / "data"),
              mano_model_path=mano, save_result=True, save_mesh=True,
              image_every=0)
    batch = next(JD.NYUDataset(str(d / "data" / "nyu"), "test",
                               img_size=S).batches(N_TEST, drop_last=False))
    pad = EVAL_B - N_TEST
    batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
             for k, v in batch.items()}
    return dict(dir=d, mano=mano, variables=variables, kw=kw, batch=batch,
                jax={})


def _jax_trainer(setup, dtype):
    """The JAX trainer and its eval outputs on the padded test batch, once
    per dtype (sharded as its _test_view shards)."""
    if dtype not in setup["jax"]:
        cfg = JConfig(compute_dtype=dtype, **setup["kw"])
        tr = JTrainer(cfg, setup["mano"], steps_per_epoch=1)
        v = setup["variables"]
        b = pmesh.shard_batch(tr.mesh, {k: jnp.asarray(setup["batch"][k])
                                        for k in KEYS})
        errors, results = tr.eval_step_fn()(v["params"], v["batch_stats"], b)
        setup["jax"][dtype] = (tr, cfg, np.asarray(errors),
                               {k: np.asarray(x, np.float32)
                                for k, x in results.items()})
    return setup["jax"][dtype]


def _port_eval(setup, dtype):
    tr = Trainer(Config(compute_dtype=dtype, **setup["kw"]), setup["mano"],
                 device="cpu")
    state = tr.init_state(setup["variables"])
    errors, results = tr.eval_step_fn()(state, setup["batch"])
    assert state.net.training          # the step restores the net's mode
    return errors.numpy(), {k: v.float().numpy() for k, v in results.items()}


RESULT_KEYS = ("joint_xyz", "mano_joint_xyz", "mano_mesh", "mano_para")


def test_eval_step_matches_jax_float32(setup):
    """Per-sample errors (pixel, MANO per stage) within the engine's
    bounds (stage 1 1e-2 mm, stage 2 0.1 mm) of the JAX eval step's, and
    the joints and meshes within the same bounds in normalized units (1 =
    half the 250 mm cube)."""
    _, _, jerr, jres = _jax_trainer(setup, "float32")
    err, res = _port_eval(setup, "float32")
    assert err.shape == jerr.shape == (4, EVAL_B)
    assert np.isfinite(err).all()
    for stage, tol in enumerate(STAGE_MM):
        np.testing.assert_allclose(err[2 * stage:2 * stage + 2],
                                   jerr[2 * stage:2 * stage + 2], atol=tol,
                                   rtol=0)
        for k in RESULT_KEYS[:3]:
            np.testing.assert_allclose(res[f"{k}_{stage}"],
                                       jres[f"{k}_{stage}"],
                                       atol=tol / 125.0, rtol=0)
    assert sorted(res) == sorted(jres)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_eval_step_matches_jax_bfloat16(setup):
    """In bfloat16 each package's eval is held against its float32 eval on
    the same weights (the witness; float32 itself agrees across the
    packages, above): per stage, the port's relative L2 distance of the
    errors and of the pixel and MANO joints within 1.5x JAX's + 1e-3, and
    JAX's below 5% (the bf16 tests' rule; the port decodes the bfloat16
    field in float32, the JAX package in bfloat16)."""
    _, _, jerr32, jres32 = _jax_trainer(setup, "float32")
    _, _, jerr16, jres16 = _jax_trainer(setup, "bfloat16")
    err32, res32 = _port_eval(setup, "float32")
    err16, res16 = _port_eval(setup, "bfloat16")
    assert np.isfinite(err16).all()
    rows = []
    for stage in range(2):
        pairs = [(err16[2 * stage:2 * stage + 2], err32[2 * stage:2 * stage + 2],
                  jerr16[2 * stage:2 * stage + 2],
                  jerr32[2 * stage:2 * stage + 2])]
        pairs += [(res16[f"{k}_{stage}"], res32[f"{k}_{stage}"],
                   jres16[f"{k}_{stage}"], jres32[f"{k}_{stage}"])
                  for k in ("joint_xyz", "mano_joint_xyz")]
        for p16, p32, j16, j32 in pairs:
            d_port, d_jax = _rel(p16, p32), _rel(j16, j32)
            rows.append((round(d_port, 5), round(d_jax, 5)))
            assert d_jax < 0.05, (stage, d_jax)
            assert d_port <= 1.5 * d_jax + 1e-3, (stage, d_port, d_jax)
    print("bf16 relative L2 from float32 (port, JAX), per stage: errors, "
          f"pixel joints, MANO joints: {rows}")


@pytest.mark.parametrize("dataset, J", [(None, 14), ("icvl", 15),
                                        ("icvl", 16), ("msra", 20)])
@pytest.mark.parametrize("keep", ["mean", "batch", "joint"])
def test_xyz2error_mm_options_match_jax(dataset, J, keep):
    """keep_batch / keep_joint and the ICVL z bias (its first min(J, 16)
    joints) and MSRA's mean without the wrist, on seeded arrays."""
    rng = np.random.RandomState(J)
    pd, gt = rng.randn(2, 5, J, 3).astype(np.float32) * 0.3
    center = rng.uniform(-50, 800, (5, 3)).astype(np.float32)
    cube = np.full((5, 3), 200.0, np.float32)
    kw = dict(keep_batch=keep == "batch", keep_joint=keep == "joint",
              dataset=dataset)
    ref = np.asarray(JP.xyz2error_mm(*map(jnp.asarray, (pd, gt, center, cube)),
                                     **kw))
    got = TP.xyz2error_mm(*map(torch.from_numpy, (pd, gt, center, cube)),
                          **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)


def _loop_cfg(setup, **kw):
    base = dict(setup["kw"], batch_size=2, save_dir=str(setup["dir"] / "ckpt"),
                save_mesh=False)
    base.update(kw)
    return Config(**base)


def _epochs(monkeypatch, n):
    monkeypatch.setattr(Config, "max_epoch", property(lambda self: n))


def _state(run_dir):
    return torch.load(os.path.join(run_dir, "latest", ckpt.FILE),
                      weights_only=True)


def test_loop_trains_saves_evaluates_and_resumes(setup, monkeypatch):
    """loop.run on the CPU: two epochs of FinetuneStage (2 steps each)
    leave train.log (Epoch#0, Epoch#1, test:), config.json, the source
    snapshot, ``latest`` and ``best``, and every test frame's rows in
    result_0/1 of each view (the 2-frame tail padded and masked); its
    ``latest`` after epoch 0 holds 2 steps and 2 updates.  Resumed from
    that checkpoint for the second epoch, a run matches the uninterrupted
    one bitwise: parameters, moments, the guard's counters and the
    exports.  (The uninterrupted run's epoch-0 ``latest`` is kept as it
    is saved, so one run serves as both the first run and the whole.)"""
    snap = setup["dir"] / "ckpt" / "epoch0"
    save = ckpt.save

    def keep_epoch0(path, tr, state, epoch):
        save(path, tr, state, epoch)
        if epoch == 0 and os.path.basename(path) == "latest":
            ckpt.wait_until_finished()
            shutil.copytree(path, snap / "latest")

    monkeypatch.setattr(ckpt, "save", keep_epoch0)
    _epochs(monkeypatch, 2)
    whole = TL.run(_loop_cfg(setup, add_info="whole"), device="cpu")
    monkeypatch.setattr(ckpt, "save", save)
    log = open(os.path.join(whole, "train.log")).read()
    assert "Epoch#0:" in log and "Epoch#1:" in log and "test:" in log
    for name in ("config.json", "latest", "best"):
        assert os.path.exists(os.path.join(whole, name))
    assert sorted(os.listdir(os.path.join(whole, "files"))) == sorted(
        r.replace("/", "_") for r in TL.SNAPSHOT)
    for view in range(3):
        for i in (0, 1):
            rows = np.loadtxt(os.path.join(whole, f"result_{i}_{view}.txt"))
            assert rows.shape == (N_TEST, 21 * 3) and np.isfinite(rows).all()
        for i in (2, 3):
            assert os.path.exists(os.path.join(whole, f"result_{i}_{view}.txt"))
    saved = _state(str(snap))
    assert saved["epoch"] == 0 and saved["step"] == 2
    assert int(saved["optimizer"]["count"]) == 2

    resumed = TL.run(_loop_cfg(setup, add_info="resumed", load_model=str(snap),
                               test_during_train=False), device="cpu")
    log = open(os.path.join(resumed, "train.log")).read()
    assert "Epoch#1:" in log and "Epoch#0:" not in log
    a, b = _state(resumed), _state(whole)
    assert a["epoch"] == b["epoch"] == 1 and a["step"] == b["step"] == 4
    for part in ("net", "optimizer"):
        for k, v in b[part].items():
            assert torch.equal(a[part][k], v) if torch.is_tensor(v) \
                else a[part][k] == v, (part, k)
    for view in range(3):
        for i in (0, 1):
            name = f"result_{i}_{view}.txt"
            assert open(os.path.join(resumed, name)).read() == \
                open(os.path.join(whole, name)).read()

    # the run's directory serves: its config and its best weights
    eng = InferenceEngine.from_run_dir(whole, device="cpu")
    assert eng.cfg == _loop_cfg(setup, add_info="whole")
    best = torch.load(os.path.join(whole, "best", ckpt.FILE),
                      weights_only=True)["net"]
    for k, v in eng.net.state_dict().items():
        assert torch.equal(v, best[k]), k


def test_test_view_exports_match_jax(setup, tmp_path):
    """The 3-view export of one view: the port's _test_view and the JAX
    package's, on the same weights (test_during_train's view 0 at batch 8,
    the 6 frames padded), write rows within 0.1 px in u and v and 0.1 mm
    in d, in both result files; and the mean errors within 0.1 mm."""
    jtr, jcfg, _, _ = _jax_trainer(setup, "float32")
    v = setup["variables"]
    jstate = types.SimpleNamespace(params=v["params"],
                                   batch_stats=v["batch_stats"])
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir(), tdir.mkdir()
    jerr = JL._test_view(jtr, jstate, jcfg, 0, str(jdir))
    cfg = Config(**setup["kw"])
    tr = Trainer(cfg, setup["mano"], device="cpu")
    terr = TL._test_view(tr, tr.init_state(v), cfg, 0, str(tdir))
    np.testing.assert_allclose(terr, jerr, atol=0.1, rtol=0)
    for i in (0, 1):
        got = np.loadtxt(tdir / f"result_{i}_0.txt").reshape(N_TEST, -1, 3)
        ref = np.loadtxt(jdir / f"result_{i}_0.txt").reshape(N_TEST, -1, 3)
        np.testing.assert_allclose(got[..., :2], ref[..., :2], atol=0.1 + 1e-3)
        np.testing.assert_allclose(got[..., 2], ref[..., 2], atol=0.1 + 1e-3)
    for name in ("mesh_result_3_0.txt", "MANO_result_3_0.txt"):
        assert np.loadtxt(tdir / name).shape == np.loadtxt(jdir / name).shape
    # the port's tools/eval_coll reads the mesh file the port's loop wrote
    # (779 vertices x 3 a row), as the JAX package's tool reads it; at a
    # 50 mm pitch, which keeps its voxel arrays small
    from dsf_tpu.tools import eval_coll as JE
    from dsf_tpu_torch.tools import eval_coll as TE
    mesh_file = str(tdir / "mesh_result_3_0.txt")
    assert np.loadtxt(mesh_file).shape == (N_TEST, 779 * 3)
    np.testing.assert_array_equal(
        TE.evaluate_meshes(mesh_file, setup["mano"], 50.0, 50.0, limit=2),
        JE.evaluate_meshes(mesh_file, setup["mano"], 50.0, 50.0, limit=2))


def test_predict_from_depth_matches_jax(setup):
    """The engine's raw-frame call on one fake frame (the foreground's
    centre of mass, the host crop) against the JAX engine's on the same
    weights: the centre and crop bitwise, the joints within the engine's
    stage-2 bound (0.1 mm)."""
    from dsf_tpu.data import readers as JR
    path = os.path.join(str(setup["dir"]), "data", "nyu", "test",
                        "depth_1_0000002.png")
    depth = JR.nyu_reader(path)
    cfg = Config(**setup["kw"])
    eng = InferenceEngine(cfg, setup["variables"], device="cpu")
    jeng = JEngine(JConfig(**setup["kw"]), setup["variables"])
    np.testing.assert_array_equal(eng._com(depth), jeng._com(depth))
    got = eng.predict_from_depth(depth)
    ref = jeng.predict_from_depth(depth)
    for k in ("joint_xyz_mm", "mano_joint_xyz_mm"):
        assert got[k].shape == (1, 12, 3)
        np.testing.assert_allclose(got[k], ref[k], atol=0.1, rtol=0)
