"""Drivers of the auxiliary training pipelines (counterpart of
dsf_tpu/training/pipelines.py).

* ``run_cyclegan`` trains the synth -> real translator on (rendered synth
  crop, real NYU crop) streams on the card and exports G_A as
  ``transfer_G_A.npz``, which ``Config(transferNet_pth=...)`` reads as the
  frozen transfer net of the training steps (``trainer.load_transfer_net``)
  and the JAX package reads with ``load_variables_npz``.
* ``run_ccssl`` labels the NYU train split with the current net by
  test-time augmentation, then trains on those labels with
  confidence-weighted losses (``training.ccssl_trainer``), on the card.

Command line: ``python -m dsf_tpu_torch.training cyclegan|ccssl --key
value ...``.
"""

from __future__ import annotations

import logging
import os
from typing import Mapping

import numpy as np
import torch

from dsf_tpu_torch.config import CAMERA, Config
from dsf_tpu_torch.device import exact_float32, resolve_device
from dsf_tpu_torch.models.weights import load_variables_npz  # noqa: F401


# ---------------------------------------------------------------------------
# variable trees as npz: each leaf under its "/"-joined path
# ---------------------------------------------------------------------------

def _flatten(tree: Mapping, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, key)
        else:
            yield key, np.asarray(v)


def save_variables_npz(path: str, variables: Mapping) -> str:
    """Write a nested dict of arrays as an npz keyed by "/"-joined paths
    (the JAX package's ``save_variables_npz`` layout; read back by
    ``load_variables_npz``)."""
    np.savez(path, **dict(_flatten(variables)))
    return path


# ---------------------------------------------------------------------------
# CCSSL (ref pieces: CCSSL/consis.py, nyu_CCSSL_loader)
# ---------------------------------------------------------------------------

def run_ccssl(cfg: Config, epochs=None, regenerate=True, device=None):
    """The CCSSL pipeline on ``device`` (``cuda`` when None; raises
    without it before it writes anything): the net of ``Trainer(cfg)``
    (seeded from ``cfg.seed``, or restored from ``cfg.load_model``)
    labels every frame of the NYU train split under
    ``{root_dir}/{dataset}`` (unaugmented crops, 5 test-time passes,
    ``ccssl_trainer.generate_pseudo_labels``) into
    ``{save_dir}/{dataset}/ccssl_{run_name}/pseudo`` (kept when it exists
    and ``regenerate`` is False), then trains ``epochs`` (``cfg.max_epoch``
    when None) epochs of ``Trainer.ccssl_step_fn`` on
    ``datasets.NYUCCSSLDataset`` (augmented, shuffled, full batches; each
    epoch's streams seeded from (seed, epoch), as ``loop.run``'s) and
    saves ``latest`` after each.  One process only: a world of more than
    one rank raises ValueError first.  Returns (the run directory, the
    final ``TrainState``)."""
    from dsf_tpu_torch.data import datasets as D
    from dsf_tpu_torch.parallel import distributed
    from dsf_tpu_torch.training import checkpoints as ckpt
    from dsf_tpu_torch.training.ccssl_trainer import generate_pseudo_labels
    from dsf_tpu_torch.training.loop import _real_iter
    from dsf_tpu_torch.training.trainer import Trainer

    world = max(distributed.world(), int(os.environ.get("WORLD_SIZE", "1")))
    if world > 1:
        raise ValueError(f"the CCSSL pipeline runs in one process; this is "
                         f"a world of {world}")
    device = resolve_device(device)
    root = os.path.join(cfg.root_dir, cfg.dataset)
    run_dir = os.path.join(cfg.save_dir, cfg.dataset,
                           "ccssl_" + cfg.run_name())
    pseudo_dir = os.path.join(run_dir, "pseudo")
    kw = dict(img_size=cfg.input_size, cube_size=cfg.cube_size,
              center_type=cfg.center_type)
    base = D.NYUDataset(root, "train", **kw)
    tr = Trainer(cfg, cfg.mano_model_path,
                 steps_per_epoch=max(len(base) // cfg.batch_size, 1),
                 device=device)
    state = tr.init_state()
    if cfg.load_model:
        state, _ = ckpt.restore(cfg.load_model, tr, state)
    os.makedirs(pseudo_dir, exist_ok=True)
    if regenerate or not os.path.exists(os.path.join(pseudo_dir,
                                                     "joint_uvd.txt")):
        logging.info("CCSSL: labelling %d frames", len(base))
        base.augment = False
        try:
            generate_pseudo_labels(tr, state, base, pseudo_dir,
                                   batch_size=cfg.batch_size, seed=cfg.seed)
        finally:
            base.close()
    ds = D.NYUCCSSLDataset(root, "train", pseudo_dir, **kw)
    step = tr.ccssl_step_fn()
    try:
        for epoch in range(epochs or cfg.max_epoch):
            losses = [step(state, b)[1]["loss"]
                      for b in _real_iter(ds, cfg, device, epoch)]
            logging.info("CCSSL epoch#%d loss=%.4f (%d steps)", epoch,
                         float(torch.stack(losses).mean()) if losses
                         else float("nan"), len(losses))
            ckpt.save(os.path.join(run_dir, "latest"), tr, state, epoch)
        ckpt.wait_until_finished()
    finally:
        ds.close()
    return run_dir, state


# ---------------------------------------------------------------------------
# CycleGAN (the reference loads latest_net_G_A.pth and has no trainer)
# ---------------------------------------------------------------------------

def synth_batch(r, gen: torch.Generator, model_para, cube):
    """The CycleGAN stream's synth crops (B, 1, S, S) on the renderer's
    device: ``model_para`` (B, 62) rendered at a depth drawn uniformly in
    the renderer's range from ``gen`` (Pretrain's draw), with no view,
    shape, centre or size augmentation and no occlusion, as the JAX
    pipeline's ``synth_sample(r, key, model_para, cube, mask=False)``;
    without TF32; on a GPU the render is K1."""
    from dsf_tpu_torch.render import renderer as rnd
    dev = r.mano.faces.device
    para, cube = (torch.as_tensor(np.asarray(x, np.float32)).to(dev)
                  for x in (model_para, cube))
    lo, hi = r.depth_range
    depth_z = lo + torch.rand(para.shape[0], 1, generator=gen) * (hi - lo)
    with exact_float32():
        img, *_ = rnd.synth_sample(r, para, cube, depth_z.to(dev), None,
                                   None, None, None, None)
    return img


def run_cyclegan(cfg: Config, steps=None, log_every=50, device=None):
    """Train the CycleGAN (``CycleGANTrainer``'s defaults: ngf 64, 9
    blocks, lr 2e-4) on ``device`` (``cuda`` when None; raises without
    it) for ``steps`` steps (``cfg.max_epoch * 1000`` when None), each on
    ``cfg.batch_size`` synth crops (``synth_batch``: MANO parameters from
    ``{root_dir}/hands20/posePara_lm_collosion`` when it exists, else
    ``random_param_source``) and as many real crops of the NYU train
    split under ``{root_dir}/{dataset}`` (augmented, shuffled, looping).
    The weights and the depth draws are seeded from ``cfg.seed``.  Logs
    the metrics every ``log_every`` steps, then writes G_A to
    ``{save_dir}/{dataset}/cyclegan_{run_name}/transfer_G_A.npz``.
    Returns (that path, the final ``CycleGANState``)."""
    from dsf_tpu_torch.data import datasets as D
    from dsf_tpu_torch.data.synth_params import (ModelParaDataset,
                                                 random_param_source)
    from dsf_tpu_torch.mano import model as mano_model
    from dsf_tpu_torch.render import renderer as rnd
    from dsf_tpu_torch.training.cyclegan_trainer import CycleGANTrainer
    from dsf_tpu_torch.training.loop import _to_device

    device = resolve_device(device)
    root = os.path.join(cfg.root_dir, cfg.dataset)
    run_dir = os.path.join(cfg.save_dir, cfg.dataset,
                           "cyclegan_" + cfg.run_name())
    os.makedirs(run_dir, exist_ok=True)

    paras, img_size = CAMERA[cfg.dataset]
    r = rnd.Renderer.create(
        mano_model.load_model(cfg.mano_model_path, device=device),
        cfg.dataset, paras, img_size, (cfg.input_size, cfg.input_size))

    synth_root = os.path.join(cfg.root_dir, "hands20")
    if os.path.isdir(os.path.join(synth_root, "posePara_lm_collosion")):
        synth_iter = ModelParaDataset(synth_root, "hands",
                                      cube_size=cfg.cube_size).iterator(
            cfg.batch_size)
    else:
        synth_iter = random_param_source(cfg.batch_size,
                                         cube_size=cfg.cube_size)

    real_ds = D.NYUDataset(root, "train", img_size=cfg.input_size,
                           cube_size=cfg.cube_size,
                           center_type=cfg.center_type)
    gan = CycleGANTrainer(device=device)
    gen = torch.Generator().manual_seed(cfg.seed)
    state = gan.init_state(gen, (1, 1, cfg.input_size, cfg.input_size))
    gan_step = gan.train_step_fn()
    real_batches = real_ds.prefetch_batches(
        cfg.batch_size, shuffle=True, loop=True, drop_last=True,
        transform=_to_device(device))
    try:
        for i in range(steps or cfg.max_epoch * 1000):
            model_para, cube = next(synth_iter)
            synth = synth_batch(r, gen, model_para, cube)
            real = next(real_batches)["img"]
            state, metrics = gan_step(state, synth, real)
            if i % log_every == 0:
                logging.info("cyclegan step %d: %s", i,
                             " ".join(f"{k}={float(v):.3f}"
                                      for k, v in metrics.items()))
    finally:
        real_batches.close()
        real_ds.close()
    out = os.path.join(run_dir, "transfer_G_A.npz")
    save_variables_npz(out, gan.export_transfer_variables(state))
    logging.info("cyclegan: exported G_A to %s", out)
    return out, state
