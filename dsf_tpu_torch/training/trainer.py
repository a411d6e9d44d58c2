"""Trainer: the Pretrain, Finetune and FinetuneStage train steps, their
optimizer and learning-rate schedule, and the frozen CycleGAN transfer net
(counterpart of dsf_tpu/training/trainer.py; ref: train_render.py:38-864).

One step: draw (or take) the random draws, render the synth batch
(``phases.pretrain_sample`` / ``phases.finetune_stage_sample``), run the
phase's loss with the net in train mode (BatchNorm statistics update in
the forward, whatever the guard decides, as in the JAX step) on the synth
image, passed through the frozen generator when ``cfg.transferNet_pth``
is set, backpropagate, then AdamW(weight_decay=0.01) at the schedule's
learning rate behind a finite guard: a non-finite gradient skips the
update and the moment update, unless it is the 9th or later in a row (ref:
``_apply_if_finite_select`` with max_consecutive_errors=8).  Float32 with
TF32 off.

Ported: Pretrain; Finetune (one stage, ``cfg.stage_num=1``) and
FinetuneStage (two stages) on the NYU camera, whose real batch is
NYU-shaped.  Not yet: the bfloat16 compute dtype, and the self-supervised
steps on other datasets.

Example::

    tr = Trainer(cfg, "mano.npz")                    # device defaults to cuda
    state = tr.init_state()                          # seeded random weights
    step = tr.train_step_fn("Pretrain")
    para, cube = next(random_param_source(cfg.batch_size))
    state, metrics = step(state, tr.draw(cfg.batch_size),
                          {"model_para": para, "cube_synth": cube})

    step = tr.train_step_fn("FinetuneStage")         # + a real batch
    real = demo.real_batch(tr.renderer, cfg.batch_size, rng)
    state, metrics = step(state, tr.draw(cfg.batch_size, "FinetuneStage"),
                          {"model_para": para, "cube_synth": cube, **real})

With ``Config(transferNet_pth=...)`` every step runs the net on the
generator's image: a ``.npz`` exported by the JAX package's CycleGAN
pipeline, a reference ``.pth`` (or a directory holding
``latest_net_G_A.pth``), or, when the path does not exist, a seeded random
generator, as the JAX trainer does (it logs a warning).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch.profiler import record_function

from dsf_tpu_torch.config import CAMERA, Config
from dsf_tpu_torch.device import exact_float32, resolve_device
from dsf_tpu_torch.mano import model as mano_model
from dsf_tpu_torch.models.backbone import ManoOCRStage
from dsf_tpu_torch.models.cyclegan import ResnetGenerator
from dsf_tpu_torch.models.weights import (load_generator_npz, load_into,
                                          load_reference_generator,
                                          random_generator_state_dict,
                                          random_reference_state_dict,
                                          state_dict_from_jax)
from dsf_tpu_torch.render import renderer as rnd
from dsf_tpu_torch.training import phases

MAX_CONSECUTIVE_ERRORS = 8
TRANSFER_RANGE = "transfer_net"     # the profiler range around the generator


def lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """The reference's three scheduler modes, read at the optimizer's count
    of updates before this one (optax's convention):

    * ``step``       — StepLR(step_size epochs, gamma=0.1)
    * ``multi_step`` — MultiStepLR(milestones, 0.1); ``cfg.step_size`` is
                       one milestone epoch or a sequence of them
    * ``auto``       — ReduceLROnPlateau is constructed but never stepped
                       in the reference: constant lr
    """
    milestones = cfg.step_size
    if not isinstance(milestones, (tuple, list)):
        milestones = (milestones,)

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        if cfg.scheduler == "multi_step":
            return cfg.lr * 0.1 ** sum(epoch >= m for m in milestones)
        if cfg.scheduler == "auto":
            return cfg.lr
        return cfg.lr * 0.1 ** (epoch // cfg.step_size)

    return schedule


def make_optimizer(cfg: Config, params) -> torch.optim.AdamW:
    """AdamW(weight_decay=0.01, betas (0.9, 0.999), eps 1e-8), as optax's
    adamw; the learning rate is set before each update from the schedule."""
    if cfg.opt != "adamw":
        raise NotImplementedError(
            f"optimizer {cfg.opt!r}: the port has AdamW only (ROADMAP "
            "Queue 1, item 8)")
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


@dataclasses.dataclass
class TrainState:
    """The net (train mode), its optimizer, and the step and guard
    counters: ``updates`` counts accepted updates (the schedule's count),
    ``notfinite_count`` consecutive non-finite gradients,
    ``total_notfinite`` all of them."""
    net: ManoOCRStage
    optimizer: torch.optim.AdamW
    step: int = 0
    updates: int = 0
    notfinite_count: int = 0
    last_finite: bool = True
    total_notfinite: int = 0


def guarded_update(state: TrainState, params, lr: float) -> bool:
    """Apply the optimizer to ``params``' gradients unless one is not
    finite; after more than MAX_CONSECUTIVE_ERRORS non-finite gradients in
    a row the update is applied all the same (ref:
    ``_apply_if_finite_select``).  Parameters without a gradient get a
    zero one, as in the JAX step, so weight decay reaches them.  Updates
    the guard counters of ``state`` and returns whether the update was
    applied."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
    state.notfinite_count = 0 if finite else state.notfinite_count + 1
    state.total_notfinite += 0 if finite else 1
    state.last_finite = finite
    accept = finite or state.notfinite_count > MAX_CONSECUTIVE_ERRORS
    if accept:
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.updates += 1
    return accept


def load_transfer_net(path: str, device) -> Optional[ResnetGenerator]:
    """The frozen CycleGAN generator of ``cfg.transferNet_pth`` on
    ``device``, in eval mode with no parameter requiring a gradient; None
    for an empty path.  As the JAX trainer (trainer.py:196-218): a path
    ending in ``.npz`` is the JAX pipeline's export, another existing path
    a reference checkpoint, and a missing path gives a seeded random
    generator (numpy seed 0, the JAX trainer's PRNGKey(0)) with a
    warning."""
    if not path:
        return None
    if os.path.exists(path):
        sd = (load_generator_npz(path) if path.endswith(".npz")
              else load_reference_generator(path))
    else:
        logging.warning("transferNet_pth %r not found; using a randomly "
                        "initialized frozen generator", path)
        sd = random_generator_state_dict(np.random.RandomState(0))
    gen = ResnetGenerator.from_state_dict(sd)
    return gen.to(device).eval().requires_grad_(False)


def _tensor(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x, np.float32))
    return t.to(device, torch.float32)


class Trainer:
    """The port's trainer.

    Args:
      cfg: a ``Config``; ``cfg.net`` must be a ResNet and
        ``cfg.compute_dtype`` float32.  ``cfg.transferNet_pth`` names the
        frozen CycleGAN generator (``load_transfer_net``), or is empty.
      mano_npz: the converted MANO asset.
      steps_per_epoch: for the epoch-based learning-rate schedule.
      device: ``cuda`` when None; raises if CUDA is missing.  ``"cpu"``
        runs the plain versions of the kernels.
    """

    def __init__(self, cfg: Config, mano_npz: str, steps_per_epoch: int = 1000,
                 device=None):
        if "ResNet" not in cfg.net:
            raise NotImplementedError(cfg.net)
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {cfg.compute_dtype}: the port trains float32 "
                "(ROADMAP Queue 1, item 8)")
        self.cfg = cfg
        self.device = resolve_device(device)
        paras, img_size = CAMERA[cfg.dataset]
        self.renderer = rnd.Renderer.create(
            mano_model.load_model(mano_npz, device=self.device), cfg.dataset,
            paras, img_size, (cfg.input_size, cfg.input_size))
        self.schedule = lr_schedule(cfg, steps_per_epoch)
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.transfer_net = load_transfer_net(cfg.transferNet_pth,
                                              self.device)

    @property
    def transfer(self) -> Optional[Callable]:
        """The phases' ``transfer``: the frozen generator's forward, or
        None without a transfer net."""
        return None if self.transfer_net is None else self._run_transfer_net

    def _run_transfer_net(self, img):
        """The frozen generator's image of ``img``, with no gradient (the
        JAX step's stop_gradient), inside the profiler range
        ``TRANSFER_RANGE``."""
        with torch.no_grad(), record_function(TRANSFER_RANGE):
            return self.transfer_net(img)

    def init_state(self, variables: Optional[Mapping] = None) -> TrainState:
        """A fresh state: the net from ``variables`` (the JAX package's
        ``{"params", "batch_stats"}`` tree), or from numpy weights seeded
        with ``cfg.seed`` (``random_reference_state_dict``); AdamW moments
        at zero."""
        cfg = self.cfg
        net = ManoOCRStage(joint_num=21, depth=int(cfg.net.split("_")[-1]),
                           refine=cfg.stage_num == 2)
        if variables is None:
            sd = random_reference_state_dict(np.random.RandomState(cfg.seed),
                                             refine=cfg.stage_num == 2)
        else:
            sd = state_dict_from_jax(variables)
        load_into(net, sd)
        net.to(self.device).train()
        return TrainState(net=net,
                          optimizer=make_optimizer(cfg, net.parameters()))

    def draw(self, batch_size: int, phase_name: str = "Pretrain"):
        """The next step's random draws for a phase, from the trainer's
        generator (seeded with ``cfg.seed``); the sphere occlusion's with
        ``cfg.mask``.  Finetune takes FinetuneStage's draws (the JAX
        phases split their keys alike)."""
        if phase_name in ("Finetune", "FinetuneStage"):
            return phases.draw_finetune_stage(
                self.generator, batch_size, self.renderer.depth_range,
                self.cfg.input_size, mask=self.cfg.mask)
        return phases.draw_pretrain(self.generator, batch_size,
                                    self.renderer.depth_range,
                                    mask=self.cfg.mask)

    def train_step_fn(self, phase_name: str):
        """The train step of a phase: ``step(state, draws, batch) ->
        (state, metrics)``, with ``draws`` from ``draw(B, phase_name)`` (or
        the caller's own) and ``batch`` of arrays or tensors:
        {"model_para" (B, 62), "cube_synth" (B, 3)} for Pretrain, and for
        Finetune and FinetuneStage also the real batch {"img" (B, 1, S, S),
        "center" (B, 3), "cube" (B, 3), "M" (B, 3, 3), "xyz_gt" (B, 14,
        3)}.  The state is updated in place and returned; metrics are 0-d
        tensors on the device, ``loss`` included."""
        if phase_name == "Pretrain":
            return self._pretrain_step
        stages = {"Finetune": 1, "FinetuneStage": 2}.get(phase_name)
        if stages is None:
            raise NotImplementedError(
                f"phase {phase_name!r}: the port has Pretrain, Finetune and "
                "FinetuneStage; not yet ported: the bfloat16 compute dtype "
                "and the self-supervised steps off the NYU camera")
        if self.cfg.dataset != "nyu" or self.cfg.stage_num != stages:
            raise NotImplementedError(
                f"{phase_name} on {self.cfg.dataset!r} with stage_num "
                f"{self.cfg.stage_num}: the port has the {stages}-stage NYU "
                "step only (datasets other than NYU are not ported)")
        return functools.partial(self._self_supervised_step,
                                 phases.finetune_loss if stages == 1
                                 else phases.finetune_stage_loss)

    def _update(self, state: TrainState, loss) -> None:
        loss.backward()
        guarded_update(state, list(state.net.parameters()),
                       self.schedule(state.updates))
        state.step += 1

    def _pretrain_step(self, state: TrainState, draws: phases.PretrainDraws,
                       batch: Mapping) -> tuple:
        cfg = self.cfg
        net, dev = state.net, self.device
        para, cube = [_tensor(batch[k], dev)
                      for k in ("model_para", "cube_synth")]
        draws = draws.to(dev)
        net.train()
        state.optimizer.zero_grad(set_to_none=True)
        with exact_float32():
            sample = phases.pretrain_sample(self.renderer, draws, para, cube)
            loss, metrics = phases.pretrain_loss(net, self.renderer, sample,
                                                 cfg, cfg.stage_num,
                                                 self.transfer)
            self._update(state, loss)
        metrics: Dict[str, torch.Tensor] = dict(metrics, loss=loss.detach())
        return state, metrics

    def _self_supervised_step(self, loss_fn, state: TrainState,
                              draws: phases.FinetuneStageDraws,
                              batch: Mapping) -> tuple:
        net, dev = state.net, self.device
        para, cube, img_r, center_r, cube_r, M_r, xyz_gt = [
            _tensor(batch[k], dev) for k in ("model_para", "cube_synth", "img",
                                             "center", "cube", "M", "xyz_gt")]
        draws = draws.to(dev)
        net.train()
        state.optimizer.zero_grad(set_to_none=True)
        with exact_float32():
            sample = phases.finetune_stage_sample(self.renderer, draws, para,
                                                  cube)
            loss, metrics = loss_fn(
                net, self.renderer, sample, draws.scores, img_r, center_r,
                cube_r, M_r, xyz_gt, self.cfg, self.transfer)
            self._update(state, loss)
        metrics: Dict[str, torch.Tensor] = dict(metrics, loss=loss.detach())
        return state, metrics
