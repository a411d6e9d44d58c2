"""Trainer: the Pretrain, Finetune and FinetuneStage train steps, their
optimizer and learning-rate schedule, and the frozen CycleGAN transfer net
(counterpart of dsf_tpu/training/trainer.py; ref: train_render.py:38-864).

One step: draw (or take) the random draws, render the synth batch
(``phases.pretrain_sample`` / ``phases.finetune_stage_sample``), run the
phase's loss with the net in train mode (BatchNorm statistics update in
the forward, whatever the guard decides, as in the JAX step) on the synth
image, passed through the frozen generator when ``cfg.transferNet_pth``
is set, backpropagate, then ``cfg.opt`` (AdamW with weight decay 0.01 by
default, or Adam, or SGD) at the schedule's learning rate behind a finite
guard: a non-finite gradient skips the update and the moment update,
unless it is the 9th or later in a row (ref: ``_apply_if_finite_select``
with max_consecutive_errors=8).  The guard, its counters and the
schedule run on the device (``GuardedOptimizer``): a step does not wait
for the device to decide.  TF32 off.

``cfg.compute_dtype`` "bfloat16" runs the net and the generator in
bfloat16, as the JAX package's trainer does: their parameters, the
optimizer state, the losses, MANO's LBS, every render and the codec stay
float32 (``phases`` casts the net's outputs and the generator's image to
float32).  "float32" runs everything in float32.

Ported: Pretrain; Finetune (one stage, ``cfg.stage_num=1``) and
FinetuneStage (two stages) on ``cfg.dataset``'s camera (NYU, ICVL, MSRA
or SHREC), whose real batch is that dataset's, in both compute dtypes;
the CCSSL step on pseudo labels (``ccssl_step_fn``); the eval step
(``eval_step_fn``, ``evaluate``) and one epoch of the configured phase
(``fit_epoch``).

Example::

    tr = Trainer(cfg, "mano.npz")                    # device defaults to cuda
    state = tr.init_state()                          # seeded random weights
    step = tr.train_step_fn("Pretrain")
    para, cube = next(random_param_source(cfg.batch_size))
    state, metrics = step(state, tr.draw(cfg.batch_size),
                          {"model_para": para, "cube_synth": cube})

    step = tr.train_step_fn("FinetuneStage")         # + a real batch
    real = demo.real_batch(tr.renderer, cfg.batch_size, rng, dataset=cfg.dataset)
    state, metrics = step(state, tr.draw(cfg.batch_size, "FinetuneStage"),
                          {"model_para": para, "cube_synth": cube, **real})

With ``Config(transferNet_pth=...)`` every step runs the net on the
generator's image: a ``.npz`` exported by a CycleGAN pipeline (the port's
``python -m dsf_tpu_torch.training cyclegan`` or the JAX package's), a
reference ``.pth`` (or a directory holding ``latest_net_G_A.pth``), or,
when the path does not exist, a seeded random generator, as the JAX
trainer does (it logs a warning).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
from typing import Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.config import CAMERA, Config, check_world, net_depth
from dsf_tpu_torch.device import (compute_dtype, exact_float32,
                                  resolve_device, widen)
from dsf_tpu_torch.mano import model as mano_model
from dsf_tpu_torch.models.backbone import ManoOCRStage
from dsf_tpu_torch.models.cyclegan import ResnetGenerator
from dsf_tpu_torch.mano.constants import transfer_for_dataset
from dsf_tpu_torch.models.weights import (load_generator_npz, load_into,
                                          load_reference_generator,
                                          random_generator_state_dict,
                                          random_reference_state_dict,
                                          state_dict_from_jax)
from dsf_tpu_torch.ops.offset_codec import offset2joint_softmax
from dsf_tpu_torch.parallel import distributed, fsdp
from dsf_tpu_torch.parallel.mesh import ONE, Mesh, make_mesh
from dsf_tpu_torch.render import renderer as rnd
from dsf_tpu_torch.training import phases

MAX_CONSECUTIVE_ERRORS = 8
TRANSFER_RANGE = "transfer_net"     # the profiler range around the generator
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
ADAMW_DECAY = 0.01                  # optax.adamw's weight_decay here
SGD_DECAY, SGD_MOMENTUM = 1e-4, 0.9


def lr_schedule(cfg: Config, steps_per_epoch: int
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The reference's three scheduler modes, as a function of the
    optimizer's int32 count of updates before this one (optax's
    convention) to a float32 learning rate on the count's device, with no
    host read:

    * ``step``       — StepLR(step_size epochs, gamma=0.1)
    * ``multi_step`` — MultiStepLR(milestones, 0.1); ``cfg.step_size`` is
                       one milestone epoch or a sequence of them
    * ``auto``       — ReduceLROnPlateau is constructed but never stepped
                       in the reference: constant lr
    """
    milestones = cfg.step_size
    if not isinstance(milestones, (tuple, list)):
        milestones = (milestones,)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        # (fills on the device: a tensor from a host scalar would be a copy)
        tenth = torch.full((), 0.1, dtype=torch.float32, device=count.device)
        epoch = torch.div(count, max(steps_per_epoch, 1), rounding_mode="floor")
        if cfg.scheduler == "auto":
            return torch.full((), cfg.lr, dtype=torch.float32,
                              device=count.device)
        if cfg.scheduler == "multi_step":
            k = sum((epoch >= m).int() for m in milestones)
        else:
            k = torch.div(epoch, cfg.step_size, rounding_mode="floor")
        return cfg.lr * torch.pow(tenth, k.float())

    return schedule


class GuardedOptimizer:
    """optax's ``adamw`` (weight decay 0.01), ``adam`` or ``sgd``
    (``add_decayed_weights(1e-4)``, momentum 0.9) at the schedule's
    learning rate, behind the finite guard of the JAX package's
    ``_apply_if_finite_select``: an update is accepted when every gradient
    is finite, or when more than MAX_CONSECUTIVE_ERRORS non-finite ones
    came in a row; a rejected update changes no parameter, no moment and
    not the count of updates.  Everything runs on the parameters' device
    with selects, so a step never waits for it.

    The state lives in flat float32 buffers over the parameters in order
    (``mu`` and ``nu`` for Adam, ``trace`` for SGD) and int32 / bool 0-d
    tensors: ``count`` (accepted updates: the schedule's and the bias
    correction's count), ``notfinite_count`` (non-finite gradients in a
    row), ``last_finite``, ``total_notfinite``.  Each update takes optax's
    operations in optax's order, so on the CPU it is optax's, bitwise.

    Over a ``mesh`` of more than one rank the flat gradient is the ranks'
    mean, so every rank takes the same decision and update.  With
    ``mesh.n_fsdp`` 1 it is one all-reduce.  Above 1 the parameters are
    sharded (ZeRO-3): ``params`` is the net's ``parallel.fsdp.Sharded``,
    whose units reduce-scatter their gradients during the backward pass.
    The update reads this rank's gradient pieces and changes its
    parameter pieces in place; the moments live on the same pieces, the
    finite flag is all-reduced (a non-finite element in any piece rejects
    on every rank), and nothing is gathered: the next forward gathers.
    ``state_dict`` gathers whole buffers: a checkpoint is world 1's.
    """

    KINDS = ("adamw", "adam", "sgd")

    def __init__(self, params, kind: str, schedule, mesh: Mesh = ONE):
        if kind not in self.KINDS:
            raise ValueError(f"optimizer {kind!r}: one of {self.KINDS}")
        self.sharded = params if isinstance(params, fsdp.Sharded) else None
        if mesh.n_fsdp > 1 and self.sharded is None:
            raise ValueError(f"n_fsdp={mesh.n_fsdp} shards the parameters: "
                             "pass parallel.fsdp.shard(net, mesh, device)")
        self.params = (self.sharded.params if self.sharded is not None
                       else list(params))
        self.kind = kind
        self.schedule = schedule
        self.mesh = mesh
        if self.sharded is not None:
            dev, n = self.sharded.piece.device, self.sharded.piece.numel()
        else:
            dev = self.params[0].device
            n = sum(p.numel() for p in self.params)
        self.numel = sum(p.numel() for p in self.params)
        zeros = lambda: torch.zeros(n, dtype=torch.float32, device=dev)
        self.buffers = ({"trace": zeros()} if kind == "sgd"
                        else {"mu": zeros(), "nu": zeros()})
        i32 = dict(dtype=torch.int32, device=dev)
        self.count = torch.zeros((), **i32)
        self.notfinite_count = torch.zeros((), **i32)
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        self.total_notfinite = torch.zeros((), **i32)

    COUNTERS = ("count", "notfinite_count", "last_finite", "total_notfinite")

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One guarded update from the parameters' ``.grad`` (a parameter
        without one gets a zero gradient, as in the JAX step, so weight
        decay reaches it).  Returns whether it was accepted, a 0-d bool
        tensor on the device."""
        params, mesh = self.params, self.mesh
        if self.sharded is not None:
            g, w = self.sharded.finish()
        else:
            g = torch.cat([(p.grad if p.grad is not None
                            else torch.zeros_like(p)).reshape(-1)
                           for p in params])
            w = torch.cat([p.reshape(-1) for p in params])
            if mesh.active:
                dist.all_reduce(g, group=mesh.group)
                g = g / mesh.world
        finite = torch.isfinite(g).all()
        if mesh.n_fsdp > 1:
            flag = finite.to(torch.int32)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
            finite = flag.bool()
        one = torch.ones((), dtype=torch.int32, device=g.device)
        notfinite = torch.where(finite, 0 * one, self.notfinite_count + one)
        accept = finite | (notfinite > MAX_CONSECUTIVE_ERRORS)
        lr = self.schedule(self.count)
        count_inc = self.count + one
        if self.kind == "sgd":
            u = g + SGD_DECAY * w
            trace = u + SGD_MOMENTUM * self.buffers["trace"]
            new = {"trace": trace}
            u = trace
        else:
            b1, b2 = ADAM_BETAS
            mu = (1 - b1) * g + b1 * self.buffers["mu"]
            nu = (1 - b2) * (g * g) + b2 * self.buffers["nu"]
            c = count_inc.float()
            f32 = dict(dtype=torch.float32, device=g.device)
            bc1 = 1 - torch.pow(torch.full((), b1, **f32), c)
            bc2 = 1 - torch.pow(torch.full((), b2, **f32), c)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            if self.kind == "adamw":
                u = u + ADAMW_DECAY * w
            new = {"mu": mu, "nu": nu}
        u = torch.where(accept, (-lr) * u, torch.zeros_like(u))
        if self.sharded is not None:
            w.add_(u)
        else:
            torch._foreach_add_(params, [x.view_as(p) for x, p in zip(
                u.split([p.numel() for p in params]), params)])
        for k, v in new.items():
            self.buffers[k] = torch.where(accept, v, self.buffers[k])
        self.count = torch.where(accept, count_inc, self.count)
        self.total_notfinite = torch.where(finite, self.total_notfinite,
                                           self.total_notfinite + one)
        self.notfinite_count = notfinite
        self.last_finite = finite
        return accept

    @property
    def param_groups(self):
        """torch.optim's view of the parameters: one group."""
        return [{"params": self.params}]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        if self.sharded is not None:
            self.sharded.zero_grad()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole state (collective under ``n_fsdp`` above 1: every fsdp
        rank must call it)."""
        whole = (self.sharded.whole_flat if self.sharded is not None
                 else lambda t: t)
        return {"kind": self.kind,
                **{k: whole(v) for k, v in self.buffers.items()},
                **{k: getattr(self, k) for k in self.COUNTERS}}

    def check_state_dict(self, sd: Mapping) -> None:
        """Raise ValueError unless ``sd`` is a state of this optimizer's
        kind and size; nothing is loaded."""
        if sd["kind"] != self.kind:
            raise ValueError(f"a {sd['kind']} state for a {self.kind} "
                             "optimizer")
        for k in self.buffers:
            if sd[k].shape != (self.numel,):
                raise ValueError(f"{k}: {tuple(sd[k].shape)} for "
                                 f"({self.numel},)")

    def load_state_dict(self, sd: Mapping) -> None:
        self.check_state_dict(sd)
        dev = self.count.device
        for k in self.buffers:
            v = sd[k].to(dev, torch.float32)
            self.buffers[k] = (self.sharded.shard_flat(v)
                               if self.sharded is not None else v.clone())
        for k in self.COUNTERS:
            setattr(self, k, sd[k].to(dev).clone())


def make_optimizer(cfg: Config, params, steps_per_epoch: int = 1000,
                   mesh: Mesh = ONE) -> GuardedOptimizer:
    """``cfg.opt`` (adamw, adam or sgd) at ``lr_schedule``'s rate behind
    the finite guard (ref: train_render.py:102-109, 148-153), over the
    ranks of ``mesh``."""
    return GuardedOptimizer(params, cfg.opt,
                            lr_schedule(cfg, steps_per_epoch), mesh)


@dataclasses.dataclass
class TrainState:
    """The net (train mode), its guarded optimizer, and the host's count
    of steps taken.  The guard's counters are the optimizer's device
    tensors: ``updates`` counts accepted updates (the schedule's count),
    ``notfinite_count`` consecutive non-finite gradients,
    ``total_notfinite`` all of them."""
    net: ManoOCRStage
    optimizer: GuardedOptimizer
    step: int = 0

    @property
    def updates(self) -> torch.Tensor:
        return self.optimizer.count

    @property
    def notfinite_count(self) -> torch.Tensor:
        return self.optimizer.notfinite_count

    @property
    def last_finite(self) -> torch.Tensor:
        return self.optimizer.last_finite

    @property
    def total_notfinite(self) -> torch.Tensor:
        return self.optimizer.total_notfinite


def guarded_update(state: TrainState) -> torch.Tensor:
    """Apply ``state.optimizer`` behind the finite guard
    (``GuardedOptimizer.step``), on the device, with no host read.
    Returns whether the update was accepted, a 0-d bool tensor."""
    return state.optimizer.step()


def load_transfer_net(path: str, device,
                      dtype: torch.dtype = torch.float32
                      ) -> Optional[ResnetGenerator]:
    """The frozen CycleGAN generator of ``cfg.transferNet_pth`` on
    ``device``, computing in ``dtype``, in eval mode with no parameter
    requiring a gradient; None for an empty path.  As the JAX trainer
    (trainer.py:196-218): a path ending in ``.npz`` is a CycleGAN
    pipeline's export (the port's or the JAX package's), another existing path
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
    gen = ResnetGenerator.from_state_dict(sd, dtype)
    return gen.to(device).eval().requires_grad_(False)


def _tensor(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x, np.float32))
    return t.to(device, torch.float32)


class Trainer:
    """The port's trainer.

    Args:
      cfg: a ``Config``; ``cfg.net`` must be a ResNet of depth 18, 50,
        101 or 152 (``config.net_depth``) and
        ``cfg.compute_dtype`` "float32" or "bfloat16" (the net's and the
        generator's; ``device.compute_dtype``).  ``cfg.batch_size`` is the
        global batch and ``cfg.n_fsdp`` the ranks sharing one copy of the
        parameters and the optimizer state (ZeRO-3); both must divide
        over the process group's ranks
        (``config.check_world``).  ``cfg.transferNet_pth`` names the frozen
        CycleGAN generator (``load_transfer_net``), or is empty.
      mano_npz: the converted MANO asset.
      steps_per_epoch: for the epoch-based learning-rate schedule.
      device: ``cuda`` (this rank's card) when None; raises if CUDA is
        missing.  ``"cpu"`` runs the plain versions of the kernels.
      mesh: the ranks' layout (``parallel.mesh``); by default that of the
        current process group (``parallel.distributed.initialize``) with
        ``cfg.n_fsdp``, world 1 outside one.

    In a world of more than one rank every rank builds a trainer and runs
    the same steps on its stripe of each global batch: ``draw`` takes the
    global batch and returns this rank's rows of its draws, the net's
    BatchNorm statistics, the M2P term's joint count, the gradient and the
    finite guard are the global batch's (``GuardedOptimizer``), and a
    step's metrics are this rank's (``global_metrics`` averages them).
    """

    def __init__(self, cfg: Config, mano_npz: str, steps_per_epoch: int = 1000,
                 device=None, mesh: Optional[Mesh] = None):
        net_depth(cfg)
        check_world(cfg, mesh.world if mesh is not None
                    else distributed.world())
        self.dtype = compute_dtype(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.n_fsdp)
        paras, img_size = CAMERA[cfg.dataset]
        self.renderer = rnd.Renderer.create(
            mano_model.load_model(mano_npz, device=self.device), cfg.dataset,
            paras, img_size, (cfg.input_size, cfg.input_size))
        self.steps_per_epoch = steps_per_epoch
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.transfer_net = load_transfer_net(cfg.transferNet_pth,
                                              self.device, self.dtype)

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
        at zero.  Under ``cfg.n_fsdp`` > 1 the net is built on the host and
        sharded onto the device (``parallel.fsdp.shard``): only this rank's
        pieces of its parameters reach the device."""
        cfg = self.cfg
        depth = net_depth(cfg)
        net = ManoOCRStage(joint_num=21, depth=depth,
                           refine=cfg.stage_num == 2, dtype=self.dtype)
        if variables is None:
            sd = random_reference_state_dict(np.random.RandomState(cfg.seed),
                                             refine=cfg.stage_num == 2,
                                             depth=depth)
        else:
            sd = state_dict_from_jax(variables)
        load_into(net, sd)
        if self.mesh.n_fsdp > 1:
            params = fsdp.shard(net, self.mesh, self.device)
        else:
            params = net.to(self.device).parameters()
        net.train()
        if self.mesh.active:
            net.sync = self.mesh
        return TrainState(net=net,
                          optimizer=make_optimizer(cfg, params,
                                                   self.steps_per_epoch,
                                                   self.mesh))

    @property
    def sync(self) -> Optional[Mesh]:
        """The mesh the losses reduce over, None at world 1."""
        return self.mesh if self.mesh.active else None

    def draw(self, batch_size: int, phase_name: str = "Pretrain"):
        """The next step's random draws for a phase, from the trainer's
        generator (seeded with ``cfg.seed``); the sphere occlusion's with
        ``cfg.mask``.  Finetune takes FinetuneStage's draws (the JAX
        phases split their keys alike).  ``batch_size`` is the global
        batch: every rank draws all of it from the same stream and keeps
        its stripe, so a world of N ranks draws world 1's numbers."""
        if phase_name in ("Finetune", "FinetuneStage"):
            draws = phases.draw_finetune_stage(
                self.generator, batch_size, self.renderer.depth_range,
                self.cfg.input_size, mask=self.cfg.mask)
        else:
            draws = phases.draw_pretrain(self.generator, batch_size,
                                         self.renderer.depth_range,
                                         mask=self.cfg.mask)
        return draws if self.mesh.world == 1 else draws.stripe(self.mesh)

    def global_metrics(self, metrics: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """A step's metrics averaged over the ranks (one all-reduce; the
        step's own at world 1): every term is a mean over equal stripes,
        so this is the global batch's value."""
        if not self.mesh.active:
            return dict(metrics)
        keys = sorted(metrics)
        v = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(v, group=self.mesh.group)
        return dict(zip(keys, v / self.mesh.world))

    def train_step_fn(self, phase_name: str):
        """The train step of a phase: ``step(state, draws, batch) ->
        (state, metrics)``, with ``draws`` from ``draw(B, phase_name)`` (or
        the caller's own) and ``batch`` of arrays or tensors:
        {"model_para" (B, 62), "cube_synth" (B, 3)} for Pretrain, and for
        Finetune and FinetuneStage also the real batch {"img" (B, 1, S, S),
        "center" (B, 3), "cube" (B, 3) (one cube a frame), "M" (B, 3, 3),
        "xyz_gt" (B, J, 3) in the dataset's joint order}; their
        ``cfg.stage_num`` must be 1 and 2.  Another phase raises
        ValueError (as the JAX trainer).  The state is updated in place and
        returned; metrics are 0-d tensors on the device, ``loss``
        included."""
        if phase_name == "Pretrain":
            return self._pretrain_step
        stages = {"Finetune": 1, "FinetuneStage": 2}.get(phase_name)
        if stages is None:
            raise ValueError(phase_name)
        if self.cfg.stage_num != stages:
            raise ValueError(
                f"{phase_name} is the {stages}-stage step; the config has "
                f"stage_num {self.cfg.stage_num}")
        return functools.partial(self._self_supervised_step,
                                 phases.finetune_loss if stages == 1
                                 else phases.finetune_stage_loss)

    def ccssl_step_fn(self):
        """The CCSSL step on pseudo labels (the JAX package's
        ``ccssl_step_fn``): ``step(state, batch) -> (state, metrics)``,
        ``batch`` {"img" (B, 1, S, S), "center" (B, 3), "cube" (B, 3),
        "uvd_gt" (B, J, 3), "weight" (B, J), optional} of arrays or tensors
        (``datasets.NYUCCSSLDataset``'s).  The net runs in train mode (one
        BatchNorm group) in the trainer's compute dtype,
        ``ccssl_trainer.ccssl_loss`` is backpropagated and the guarded
        optimizer takes the update.  Metrics are 0-d tensors on the device,
        ``loss`` and each stage's term."""
        return self._ccssl_step

    def _ccssl_step(self, state: TrainState, batch: Mapping) -> tuple:
        from dsf_tpu_torch.training.ccssl_trainer import ccssl_loss
        dev = self.device
        b = {k: _tensor(batch[k], dev) for k in ("img", "center", "cube",
                                                 "uvd_gt", "weight")
             if k in batch}
        state.net.train()
        state.optimizer.zero_grad()
        with exact_float32():
            loss, metrics = ccssl_loss(state.net, self.renderer, b, self.cfg)
            self._update(state, loss)
        return state, dict(metrics, loss=loss.detach())

    def _update(self, state: TrainState, loss) -> None:
        loss.backward()
        guarded_update(state)
        state.step += 1

    def _pretrain_step(self, state: TrainState, draws: phases.PretrainDraws,
                       batch: Mapping) -> tuple:
        cfg = self.cfg
        net, dev = state.net, self.device
        para, cube = [_tensor(batch[k], dev)
                      for k in ("model_para", "cube_synth")]
        draws = draws.to(dev)
        net.train()
        state.optimizer.zero_grad()
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
        state.optimizer.zero_grad()
        with exact_float32():
            sample = phases.finetune_stage_sample(self.renderer, draws, para,
                                                  cube)
            loss, metrics = loss_fn(
                net, self.renderer, sample, draws.scores, img_r, center_r,
                cube_r, M_r, xyz_gt, self.cfg, self.transfer, self.sync)
            self._update(state, loss)
        metrics: Dict[str, torch.Tensor] = dict(metrics, loss=loss.detach())
        return state, metrics

    # ------------------------------------------------------------- eval

    def eval_step_fn(self):
        """The per-batch test errors (ref: Trainer.test_iter,
        train_render.py:355-400): ``step(state, batch) -> (errors,
        results)``.  The net runs in eval mode in the trainer's compute
        dtype, without gradients.  ``errors`` (2 * stages, B) holds, per
        stage, the pixel branch's and the MANO branch's mm error per
        sample on the transfer-mapped joints but the last (MSRA's mean
        skips the wrist); ``results`` holds ``joint_xyz_i``,
        ``mano_joint_xyz_i`` and ``mano_mesh_i`` (normalized units) and
        ``mano_para_i``.  ``batch`` holds ``img``, ``xyz_gt``, ``center``,
        ``M``, ``cube`` (arrays or tensors)."""
        return self._eval_step

    def _eval_step(self, state: TrainState, batch: Mapping):
        cfg, r, dev = self.cfg, self.renderer, self.device
        img, xyz_gt, center, M, cube = [
            _tensor(batch[k], dev) for k in ("img", "xyz_gt", "center", "M",
                                             "cube")]
        tm = torch.as_tensor(transfer_for_dataset(cfg.dataset), device=dev)
        n_eval = len(tm) - 1
        net = state.net
        was_training = net.training
        net.eval()
        try:
            with torch.no_grad(), exact_float32():
                outputs = net(img, r, center, cube)
                errors, results = [], {}
                gt = xyz_gt[:, :n_eval]
                for idx, (pixel_pd, para_pd) in enumerate(outputs):
                    juvd = offset2joint_softmax(pixel_pd, img,
                                                cfg.feature_para[0])
                    jxyz = geo.uvd_nl_to_xyz_nl(juvd, center, M, cube,
                                                r.paras, cfg.input_size,
                                                r.flip)
                    mano_jxyz, mano_mesh = rnd.get_mesh_xyz(r, widen(para_pd))
                    for pd in (jxyz, mano_jxyz):
                        pd = pd[:, tm][:, :n_eval]
                        if cfg.dataset == "msra":
                            e = phases.xyz2error_mm(pd, gt, center, cube,
                                                    keep_joint=True,
                                                    dataset=cfg.dataset)
                            errors.append(e[:, 1:].mean(-1))
                        else:
                            errors.append(phases.xyz2error_mm(
                                pd, gt, center, cube, keep_batch=True,
                                dataset=cfg.dataset))
                    results[f"joint_xyz_{idx}"] = jxyz
                    results[f"mano_joint_xyz_{idx}"] = mano_jxyz
                    results[f"mano_mesh_{idx}"] = mano_mesh
                    results[f"mano_para_{idx}"] = para_pd
        finally:
            net.train(was_training)
        return torch.stack(errors), results

    def evaluate(self, state: TrainState, batches: Iterator[Mapping]):
        """The mean per-stage errors (2 * stages,) over ``batches``, a
        numpy array; in a world of ranks each rank's ``batches`` are its
        own rows, and the errors and counts are summed over the ranks
        (every rank must take as many batches)."""
        totals, n = None, 0
        for batch in batches:
            errors, _ = self._eval_step(state, batch)
            s = errors.sum(-1)
            totals = s if totals is None else totals + s
            n += errors.shape[-1]
        if self.mesh.active:
            both = torch.cat([totals, totals.new_full((1,), float(n))])
            dist.all_reduce(both, group=self.mesh.group)
            totals, n = both[:-1], int(both[-1])
        return (totals / max(n, 1)).cpu().numpy()

    # -------------------------------------------------------------- fit

    def phase(self) -> str:
        """The train step ``fit_epoch`` runs: ``cfg.train_stage`` when it
        is Pretrain, else Finetune (one stage) or FinetuneStage (two)."""
        cfg = self.cfg
        if cfg.train_stage == "Pretrain":
            return "Pretrain"
        return "Finetune" if cfg.stage_num == 1 else "FinetuneStage"

    def fit_epoch(self, state: TrainState, synth_iter, real_iter=None,
                  num_steps: Optional[int] = None, writer=None, epoch=0,
                  image_every=0):
        """One epoch of ``phase()``: each step takes (model_para,
        cube_synth) from ``synth_iter``, a real batch dict from
        ``real_iter`` (not for Pretrain) and its draws from ``draw``.
        Each step's metrics are read one step late (after the next step
        is queued), so the host does not stall the device.  With a
        TensorBoard ``writer`` every metric is logged per step (images
        are not ported: ``image_every`` > 0 logs one warning).  Returns
        (state, the epoch-mean metrics as floats).

        In a world of ranks ``synth_iter`` yields the global batch (each
        rank keeps its stripe) and ``real_iter`` this rank's stripe of it
        (``loop._real_iter``); the metrics are the ranks' means."""
        phase = self.phase()
        step = self.train_step_fn(phase)
        steps = num_steps or self.steps_per_epoch
        if (writer is not None and image_every and phase != "Pretrain"
                and not getattr(self, "_warned_images", False)):
            self._warned_images = True
            logging.warning("fit_epoch: pose and depth images are not ported "
                            "(utils/vis, ROADMAP Queue 1); scalars only")
        sums: Dict[str, float] = {}
        pending = None
        for i in range(steps):
            model_para, cube_synth = next(synth_iter)
            B = len(model_para)
            batch = {"model_para": self.mesh.stripe(model_para),
                     "cube_synth": self.mesh.stripe(cube_synth)}
            if phase != "Pretrain":
                batch.update(next(real_iter))
            state, metrics = step(state, self.draw(B, phase), batch)
            if pending is not None:
                self._log_step(writer, epoch, steps, *pending, sums)
            pending = (i, metrics)
        if pending is not None:
            self._log_step(writer, epoch, steps, *pending, sums)
        return state, {k: v / steps for k, v in sums.items()}

    def _log_step(self, writer, epoch, steps, i, metrics, sums) -> None:
        vals = {k: float(v) for k, v in self.global_metrics(metrics).items()}
        for k, v in vals.items():
            sums[k] = sums.get(k, 0.0) + v
            if writer is not None:
                writer.add_scalar(k, v, global_step=epoch * steps + i)
