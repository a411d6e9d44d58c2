"""The train and test loop: epochs, checkpoints, logging and the test
exports (counterpart of dsf_tpu/training/loop.py; ref:
Trainer.train/test, train_render.py:231-353, and the __main__ block
:874-889: train -> per-epoch test -> best, then the 3-view NYU eval).

``run(cfg)`` trains on the card (``device`` "cpu" for tests) from the
dataset ``cfg.dataset`` under ``cfg.root_dir/{dataset}``: NYU, ICVL,
MSRA (``cfg.test_id`` the left-out subject) or SHREC
(``_make_datasets``).  The augmented train batches come from the loader
on a prefetch thread, which also copies them to the device; each epoch
runs ``Trainer.fit_epoch``, saves ``latest``, and with
``cfg.test_during_train`` evaluates view 0 and keeps ``best``.  At the
end (or with ``cfg.phase == "test"``) every test frame is evaluated (NYU:
its three views; the other datasets: their one), the tail batch padded
and masked, and the result_*, mesh_result_*, MANO_result_* files (and
with ``cfg.save_obj`` one .obj per frame) are written to the run
directory; ICVL's exported u is un-flipped (W - u), as its loader flips
the images.

Each epoch's random streams (the shuffle, the augmentation draws, the
synth parameters, the steps' draws) are seeded from (``cfg.seed``,
epoch), so a run resumed from ``latest`` continues as the uninterrupted
run would.

Under ``torchrun --nproc-per-node N`` (``parallel.distributed.initialize``
reads its environment) every rank runs this loop on its own card with
the global ``cfg.batch_size``: each rank reads only its stripe of every
train and test batch (the same permutation, disjoint rows), and the
steps and the evaluation reduce over the ranks, so the run is world 1's.
Rank 0 alone writes the run directory (``train.log``, ``config.json``,
the snapshot, TensorBoard, the checkpoints and the exports, in dataset
order); every rank restores a checkpoint.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time

import numpy as np
import torch

import torch.distributed as dist

from dsf_tpu_torch.config import Config, check_world
from dsf_tpu_torch.parallel import distributed
from dsf_tpu_torch.parallel.mesh import ONE, all_gather_rows

SNAPSHOT = ("training/phases.py", "training/trainer.py", "config.py",
            "models/backbone.py", "render/renderer.py", "mano/model.py",
            "ops/rasterize.py")
BATCH_KEYS = ("img", "xyz_gt", "center", "M", "cube")
DATASETS = ("nyu", "icvl", "msra", "shrec")


def _check_dataset(cfg: Config) -> None:
    if cfg.dataset not in DATASETS:
        raise ValueError(f"dataset {cfg.dataset!r}: one of {DATASETS}")


def _epoch_seed(cfg: Config, epoch: int, stream: int):
    return [cfg.seed, epoch, stream]


def _test_dataset(cfg: Config, view: int = 0):
    """The test split: NYU's ``view``, or the other datasets' one (SHREC's
    frames are both its train and its test split)."""
    from dsf_tpu_torch.data import datasets as D
    root = os.path.join(cfg.root_dir, cfg.dataset)
    if cfg.dataset == "nyu":
        return D.NYUDataset(root, "test", view=view, img_size=cfg.input_size,
                            cube_size=cfg.cube_size,
                            center_type=cfg.center_type)
    if cfg.dataset == "icvl":
        return D.ICVLDataset(root, "test", img_size=cfg.input_size,
                             cube_size=cfg.cube_size)
    if cfg.dataset == "msra":
        return D.MSRADataset(root, "test", test_persons=cfg.test_id,
                             img_size=cfg.input_size)
    return D.SHRECDataset(root, img_size=cfg.input_size,
                          cube_size=cfg.cube_size)


def _make_datasets(cfg: Config):
    """(the train dataset, or None for ``phase="test"``, and a factory of
    synth parameter iterators by seed)."""
    from dsf_tpu_torch.data import datasets as D
    from dsf_tpu_torch.data.synth_params import (ModelParaDataset,
                                                 random_param_source)
    _check_dataset(cfg)
    root = os.path.join(cfg.root_dir, cfg.dataset)
    train_ds = None
    if cfg.phase == "train":
        if cfg.dataset == "nyu":
            train_ds = D.NYUDataset(root, "train", img_size=cfg.input_size,
                                    cube_size=cfg.cube_size,
                                    center_type=cfg.center_type,
                                    aug_para=cfg.augment_para)
        elif cfg.dataset == "icvl":
            train_ds = D.ICVLDataset(root, "train", img_size=cfg.input_size,
                                     cube_size=cfg.cube_size,
                                     aug_para=cfg.augment_para)
        elif cfg.dataset == "msra":
            train_ds = D.MSRADataset(root, "train", test_persons=cfg.test_id,
                                     img_size=cfg.input_size,
                                     aug_para=cfg.augment_para)
        else:
            train_ds = _test_dataset(cfg)
    if train_ds is not None and cfg.cache_depths:
        # decode-once RAM cache, bounded to half of the available RAM
        try:
            avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        except (ValueError, OSError):
            avail = 16 << 30
        train_ds.enable_depth_cache(max_bytes=avail // 2)

    synth_root = os.path.join(cfg.root_dir, "hands20")
    if os.path.isdir(os.path.join(synth_root, "posePara_lm_collosion")):
        synth = ModelParaDataset(synth_root, "hands", cube_size=cfg.cube_size)
        synth_iter = lambda seed: synth.iterator(cfg.batch_size, seed=seed)
    else:
        logging.warning("hands20 params not found; using random synth params")
        synth_iter = lambda seed: random_param_source(
            cfg.batch_size, cube_size=cfg.cube_size, seed=seed)
    return train_ds, synth_iter


def _to_device(device):
    """A prefetch transform: the batch's arrays as tensors on ``device``
    (pinned and copied without waiting on a card; the prefetch thread
    works on ``device``'s card, not the thread's default one)."""
    def transform(b):
        if device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in b.items()}
        with torch.cuda.device(device):
            return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    .to(device, non_blocking=True) for k, v in b.items()}
    return transform


def _real_iter(ds, cfg: Config, device, epoch: int, mesh=ONE):
    """One shuffled pass over ``ds`` in full batches on ``device``, its
    shuffle and augmentation seeded from (``cfg.seed``, epoch); this
    rank's stripe of each global batch of ``mesh``."""
    ds.rng = np.random.RandomState(_epoch_seed(cfg, epoch, 1))
    return ds.prefetch_batches(cfg.batch_size, shuffle=True,
                               seed=_epoch_seed(cfg, epoch, 0),
                               drop_last=True, transform=_to_device(device),
                               rank=mesh.rank, world=mesh.world)


def _barrier() -> None:
    if distributed.world() > 1:
        dist.barrier()


def run(cfg: Config, device=None) -> str:
    """Train (and test) per ``cfg`` on ``device`` (``cuda`` when None:
    this rank's card; raises without it).  Under ``torchrun`` it joins the
    process group first (``distributed.initialize``: NCCL, or gloo with
    ``device="cpu"``) and leaves it at the end; ``cfg.n_fsdp`` and the
    global ``cfg.batch_size`` must divide over the ranks, which is checked
    before anything is touched (``config.check_world``).  Returns the run
    directory, ``{cfg.save_dir}/{cfg.dataset}/{cfg.run_name()}``, which
    gets ``train.log`` and ``config.json``."""
    _check_dataset(cfg)
    joined = dist.is_initialized()
    check_world(cfg, distributed.world() if joined
                else int(os.environ.get("WORLD_SIZE", "1")))
    device = distributed.initialize(device)
    try:
        return _run_logged(cfg, device)
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()


def _run_logged(cfg: Config, device) -> str:
    run_dir = os.path.join(cfg.save_dir, cfg.dataset, cfg.run_name())
    if distributed.rank() != 0:
        _run(cfg, run_dir, device)
        return run_dir
    os.makedirs(run_dir, exist_ok=True)
    # a per-run file handler, detached when the run ends (basicConfig would
    # be a no-op once any handler exists)
    root = logging.getLogger()
    handler = logging.FileHandler(os.path.join(run_dir, "train.log"))
    handler.setFormatter(logging.Formatter("%(asctime)s %(message)s",
                                           "%Y/%m/%d %H:%M:%S"))
    handler.setLevel(logging.INFO)
    prev_level = root.level
    if root.level > logging.INFO or root.level == logging.NOTSET:
        root.setLevel(logging.INFO)
    root.addHandler(handler)
    try:
        _run(cfg, run_dir, device)
    finally:
        root.removeHandler(handler)
        handler.close()
        root.setLevel(prev_level)
    return run_dir


def _snapshot_sources(run_dir: str) -> None:
    """Copy the core sources into the run directory (ref:
    train_render.py:78-84 copies its 5 core files)."""
    import dsf_tpu_torch
    pkg = os.path.dirname(dsf_tpu_torch.__file__)
    files_dir = os.path.join(run_dir, "files")
    os.makedirs(files_dir, exist_ok=True)
    for rel in SNAPSHOT:
        shutil.copyfile(os.path.join(pkg, rel),
                        os.path.join(files_dir, rel.replace("/", "_")))


def _summary_writer(cfg: Config, run_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        logging.warning("tensorboard unavailable; skipping TB logging")
        return None
    return SummaryWriter(os.path.join(run_dir, "tb",
                                      f"{cfg.dataset}-{cfg.add_info}"))


def _run(cfg: Config, run_dir: str, device) -> None:
    from dsf_tpu_torch.training import checkpoints as ckpt
    from dsf_tpu_torch.training.trainer import Trainer

    lead = distributed.rank() == 0
    if lead:
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump({k: str(v) for k, v in vars(cfg).items()}, f, indent=2)
        _snapshot_sources(run_dir)
    _barrier()

    train_ds, synth_iter = _make_datasets(cfg)
    steps = (len(train_ds) // cfg.batch_size if train_ds is not None
             else 1000)
    tr = Trainer(cfg, cfg.mano_model_path, steps_per_epoch=steps,
                 device=device)
    state = tr.init_state()
    start_epoch = 0
    if cfg.load_model:
        state, start_epoch = ckpt.restore(cfg.load_model, tr, state)
    if cfg.finetune_dir:
        state, _ = ckpt.restore(cfg.finetune_dir, tr, state,
                                weights_only=True)

    if cfg.phase == "test":
        _test_views(tr, state, cfg, run_dir)
        return

    writer = _summary_writer(cfg, run_dir) if lead else None
    best = np.inf
    try:
        for epoch in range(start_epoch, cfg.max_epoch):
            t0 = time.time()
            tr.generator.manual_seed(
                int(np.random.SeedSequence(_epoch_seed(cfg, epoch, 2))
                    .generate_state(1)[0]))
            synth = synth_iter(_epoch_seed(cfg, epoch, 3))
            real = (_real_iter(train_ds, cfg, tr.device, epoch, tr.mesh)
                    if tr.phase() != "Pretrain" else None)
            try:
                state, metrics = tr.fit_epoch(
                    state, synth, real, num_steps=steps, writer=writer,
                    epoch=epoch, image_every=cfg.image_every)
            finally:
                if real is not None:
                    real.close()
            logging.info("Epoch#%d: %s (%.1fs)", epoch,
                         " ".join(f"{k}={v:.3f}" for k, v in metrics.items()),
                         time.time() - t0)
            if writer is not None:
                for k, v in metrics.items():
                    writer.add_scalar(f"epoch/{k}", v, global_step=epoch)
            ckpt.save(os.path.join(run_dir, "latest"), tr, state, epoch)
            if cfg.test_during_train:
                errs = _test_view(tr, state, cfg, 0)
                mean_err = float(np.mean(errs))
                logging.info("Epoch#%d test: %.2f mm", epoch, mean_err)
                if mean_err <= best:
                    best = mean_err
                    ckpt.save(os.path.join(run_dir, "best"), tr, state,
                              epoch)
    finally:
        if writer is not None:
            writer.close()
        if train_ds is not None:
            train_ds.close()
    ckpt.wait_until_finished()
    _test_views(tr, state, cfg, run_dir)
    _barrier()


def _test_views(tr, state, cfg: Config, run_dir: str) -> None:
    for view in range(3 if cfg.dataset == "nyu" else 1):
        errs = _test_view(tr, state, cfg, view, run_dir)
        if tr.mesh.rank == 0:
            print(f"view {view}: " + " ".join(f"[{e:.2f}mm]" for e in errs))


def _test_view(tr, state, cfg: Config, view: int, run_dir=None):
    """Evaluate every frame of one test view (NYU's ``view``, or the
    other datasets' one) -> the mean per-stage errors (2 * stages,); with
    ``run_dir``, also write its exports (ref: train_render.py:320-325,
    383-398).  In a world of ranks each reads and evaluates its stripe of
    every batch (the tail padded first), and the errors, the outputs and
    the crops' centres and cubes are gathered, so every rank holds the
    global batch and rank 0 writes world 1's files."""
    from dsf_tpu_torch.data import crop as C
    from dsf_tpu_torch.device import widen

    ds = _test_dataset(cfg, view)
    mesh = tr.mesh
    export = run_dir is not None and (cfg.save_result or cfg.save_mesh
                                      or cfg.save_obj)
    files = {}
    last = cfg.stage_num - 1
    if export and mesh.rank == 0:
        # the reference's file set: result_{i}_{view} for i < 2S, of which
        # only 0 and 1 get rows (its save block sits after the stage loop
        # and writes the last stage's two branches), and the mesh / MANO /
        # collision files named with 2S - 1
        s = cfg.stage_num * 2 - 1
        if cfg.save_obj:
            os.makedirs(os.path.join(run_dir, "obj"), exist_ok=True)
        if cfg.save_result:
            for i in range(cfg.stage_num * 2):
                files[f"r{i}"] = open(
                    os.path.join(run_dir, f"result_{i}_{view}.txt"), "w")
        if cfg.save_mesh:
            for key, name in (("mesh", "mesh_result"), ("mano", "MANO_result"),
                              ("coll", "coll")):
                files[key] = open(
                    os.path.join(run_dir, f"{name}_{s}_{view}.txt"), "w")

    step = tr.eval_step_fn()
    totals, n = None, 0
    try:
        # drop_last=False, pad and mask: every frame counts (the NYU
        # protocol's 8,252 rows per view); the step runs at one batch size
        for i, b in enumerate(ds.prefetch_batches(
                cfg.batch_size, shuffle=False, drop_last=False,
                rank=mesh.rank, world=mesh.world)):
            valid = min(len(ds) - i * cfg.batch_size, len(b["img"])
                        * mesh.world)
            if len(b["img"]) < cfg.batch_size // mesh.world:
                pad = cfg.batch_size - valid
                b = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                     for k, v in b.items()}
            errors, results = step(state, {k: b[k] for k in BATCH_KEYS})
            if mesh.world > 1:
                errors = all_gather_rows(errors.t(), mesh).t()
                results = {k: all_gather_rows(v, mesh)
                           for k, v in results.items()}
                b = {k: all_gather_rows(torch.from_numpy(b[k]).to(
                    tr.device), mesh).cpu().numpy() for k in ("center", "cube")}
            errors = errors.cpu().numpy()[:, :valid]
            totals = (errors.sum(-1) if totals is None
                      else totals + errors.sum(-1))
            n += valid
            if not export or mesh.rank != 0:
                continue
            res = {k: widen(v).cpu().numpy()[:valid] for k, v in results.items()}
            center = b["center"][:valid, None]
            cube = b["cube"][:valid, None]
            if cfg.save_result:
                for key, fh in ((f"joint_xyz_{last}", files["r0"]),
                                (f"mano_joint_xyz_{last}", files["r1"])):
                    world = res[key] * cube / 2 + center
                    uvd = C.joint_3d_to_img(world, ds.paras, ds.flip)
                    if cfg.dataset == "icvl":
                        # the loader flips the images: un-flip u (ref
                        # train_render.py:857-860)
                        uvd[:, :, 0] = ds.ori_img_size[0] - uvd[:, :, 0]
                    np.savetxt(fh, uvd.reshape(valid, -1), fmt="%.3f")
            mesh_world = res[f"mano_mesh_{last}"] * cube / 2 + center
            if cfg.save_mesh:
                np.savetxt(files["mesh"], mesh_world.reshape(valid, -1),
                           fmt="%.3f")
                np.savetxt(files["mano"], res[f"mano_para_{last}"],
                           fmt="%.3f")
            if cfg.save_obj:
                from dsf_tpu_torch.utils.vis import save_obj
                faces = tr.renderer.mano.faces.cpu().numpy()
                batch_index = (n - valid) // cfg.batch_size
                for bi in range(valid):
                    save_obj(os.path.join(run_dir, "obj",
                                          f"{view}_{batch_index}_{bi}.obj"),
                             mesh_world[bi], faces)
    finally:
        for fh in files.values():
            fh.close()
        ds.close()
    return totals / max(n, 1)
