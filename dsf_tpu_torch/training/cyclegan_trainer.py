"""Consis-CycleGAN training: the synth -> real depth transfer net
(counterpart of dsf_tpu/training/cyclegan_trainer.py).

The reference consumes a generator trained outside its repository
(``latest_net_G_A.pth``, train_render.py:95-100); the JAX package trains
it, and so does the port: two ``ResnetGenerator``s (G_A synth -> real,
G_B real -> synth) and two PatchGAN ``NLayerDiscriminator``s (D_A judges
the real domain, D_B the synth one) over (synth depth crop, real depth
crop) batches, with the lsgan adversarial, cycle and identity losses and
the "consis" term: the soft foreground masks ``clip(tanh((0.99 - x) *
20), 0, 1)`` of each input and its translation must agree.

One step (``train_step_fn``) computes the generators' loss and gradients
against the discriminators as they are, updates the generators (Adam,
lr 2e-4, betas (0.5, 0.999): optax's ``adam(lr, b1=0.5)``), then the
discriminators' loss on the same forward's fakes, detached, and updates
them.  Float32 without TF32; there is no finite guard, as in the JAX
step.  On a GPU the generators' heads are K9 (``TailConvTanh``), six
launches a step, their gradient through ``TailConvFn``'s backward.

Example::

    gan = CycleGANTrainer()                       # device defaults to cuda
    state = gan.init_state(torch.Generator().manual_seed(0))
    step = gan.train_step_fn()
    state, metrics = step(state, synth, real)     # (B, 1, 128, 128) each
    variables = gan.export_transfer_variables(state)   # G_A, JAX layout
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from dsf_tpu_torch.device import exact_float32, resolve_device
from dsf_tpu_torch.models.cyclegan import (NLayerDiscriminator,
                                           ResnetGenerator, gan_loss)
from dsf_tpu_torch.models.weights import (discriminator_state_dict_from_jax,
                                          generator_state_dict_from_jax,
                                          generator_state_dict_to_jax,
                                          load_into,
                                          random_discriminator_state_dict,
                                          random_generator_state_dict)

ADAM_BETAS, ADAM_EPS = (0.5, 0.999), 1e-8
FG_LEVEL, FG_SLOPE = 0.99, 20.0     # the consis term's soft foreground


@dataclasses.dataclass
class CycleGANState:
    """The four nets (train mode), the generators' and the
    discriminators' Adam, and the host's count of steps taken."""
    G_A: ResnetGenerator
    G_B: ResnetGenerator
    D_A: NLayerDiscriminator
    D_B: NLayerDiscriminator
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0

    def generators(self):
        return [*self.G_A.parameters(), *self.G_B.parameters()]

    def discriminators(self):
        return [*self.D_A.parameters(), *self.D_B.parameters()]


def foreground(x):
    """The consis term's soft foreground mask of a normalized depth
    image (the background is +1)."""
    return torch.tanh((FG_LEVEL - x) * FG_SLOPE).clamp(0, 1)


@dataclasses.dataclass
class CycleGANTrainer:
    """The JAX trainer's fields and defaults; ``device`` is ``cuda`` when
    None (raises without it), ``"cpu"`` runs the plain versions of the
    kernels.  ``compute_dtype`` None or float32: other types raise
    (ROADMAP Queue 1, item 1)."""
    lr: float = 2e-4
    lambda_cycle: float = 10.0
    lambda_identity: float = 5.0
    lambda_consis: float = 1.0
    ngf: int = 64
    n_blocks: int = 9
    compute_dtype: Any = None
    device: Any = None

    def __post_init__(self):
        if self.compute_dtype not in (None, "float32", torch.float32):
            raise NotImplementedError(
                f"compute_dtype {self.compute_dtype!r}: the port's CycleGAN "
                "trainer computes in float32 (a bfloat16 CycleGAN is "
                "ROADMAP Queue 1, item 1)")
        self.device = resolve_device(self.device)

    def init_state(self, gen: Optional[torch.Generator] = None,
                   img_shape=(1, 1, 128, 128),
                   variables: Optional[Mapping] = None) -> CycleGANState:
        """The four nets and both Adams.  The weights come from
        ``variables`` (the JAX state's ``{"g_params": {"G_A", "G_B"},
        "d_params": {"D_A", "D_B"}}``), else from the JAX nets' init
        distributions drawn with numpy, seeded from ``gen``
        (``random_generator_state_dict`` twice, then
        ``random_discriminator_state_dict`` twice).  ``img_shape``
        (B, 1, H, W) is the JAX signature's: the nets take one channel and
        H and W multiples of 4."""
        if img_shape[1] != 1 or img_shape[2] % 4 or img_shape[3] % 4:
            raise ValueError(f"img_shape {tuple(img_shape)}: one channel, "
                             "H and W multiples of 4")
        if variables is None:
            gen = gen if gen is not None else torch.Generator().manual_seed(0)
            rng = np.random.RandomState(
                int(torch.randint(2 ** 31 - 1, (1,), generator=gen)))
            g_sd = [random_generator_state_dict(rng, self.ngf, self.n_blocks)
                    for _ in range(2)]
            d_sd = [random_discriminator_state_dict(rng) for _ in range(2)]
        else:
            g_sd = [generator_state_dict_from_jax(
                {"params": variables["g_params"][k]}) for k in ("G_A", "G_B")]
            d_sd = [discriminator_state_dict_from_jax(
                {"params": variables["d_params"][k]}) for k in ("D_A", "D_B")]
        gens = [ResnetGenerator(ngf=self.ngf, n_blocks=self.n_blocks)
                for _ in range(2)]
        discs = [NLayerDiscriminator() for _ in range(2)]
        for net, sd in zip(gens + discs, g_sd + d_sd):
            load_into(net, sd)
            net.to(self.device).train()
        G_A, G_B = gens
        D_A, D_B = discs
        adam = lambda params: torch.optim.Adam(params, lr=self.lr,
                                               betas=ADAM_BETAS, eps=ADAM_EPS)
        return CycleGANState(
            G_A, G_B, D_A, D_B,
            adam([*G_A.parameters(), *G_B.parameters()]),
            adam([*D_A.parameters(), *D_B.parameters()]))

    # ------------------------------------------------------------------

    def _g_loss(self, state: CycleGANState, synth, real):
        """The generators' loss and its terms (JAX ``_g_loss``, op for
        op), with both fakes under ``fake_real`` / ``fake_synth``."""
        G_A, G_B = state.G_A, state.G_B
        fake_real = G_A(synth)
        fake_synth = G_B(real)
        rec_synth = G_B(fake_real)
        rec_real = G_A(fake_synth)
        idt_real = G_A(real)
        idt_synth = G_B(synth)

        adv_A = gan_loss(state.D_A(fake_real), True)
        adv_B = gan_loss(state.D_B(fake_synth), True)
        cyc = ((rec_synth - synth).abs().mean()
               + (rec_real - real).abs().mean()) * self.lambda_cycle
        idt = ((idt_real - real).abs().mean()
               + (idt_synth - synth).abs().mean()) * self.lambda_identity
        consis = ((foreground(synth) - foreground(fake_real)).abs().mean()
                  + (foreground(real) - foreground(fake_synth)).abs().mean()
                  ) * self.lambda_consis
        loss = adv_A + adv_B + cyc + idt + consis
        aux = {"adv_A": adv_A, "adv_B": adv_B, "cycle": cyc,
               "identity": idt, "consis": consis,
               "fake_real": fake_real, "fake_synth": fake_synth}
        return loss, aux

    def _d_loss(self, state: CycleGANState, synth, real, fake_real,
                fake_synth):
        """The discriminators' loss on detached fakes (JAX ``_d_loss``)."""
        D_A, D_B = state.D_A, state.D_B
        return 0.5 * (gan_loss(D_A(real), True)
                      + gan_loss(D_A(fake_real.detach()), False)
                      + gan_loss(D_B(synth), True)
                      + gan_loss(D_B(fake_synth.detach()), False))

    def train_step_fn(self):
        """``step(state, synth, real) -> (state, metrics)`` on (B, 1, H, W)
        batches (arrays or tensors, cast to the nets' type, float32): the
        state is updated in place
        and returned; the metrics ``adv_A adv_B cycle identity consis
        g_loss d_loss`` are 0-d tensors on the device."""
        return self._step

    def _step(self, state: CycleGANState, synth, real):
        dtype = state.G_A.model[1].weight.dtype     # float64: a test's witness
        synth, real = (torch.as_tensor(x).to(self.device, dtype)
                       for x in (synth, real))
        with exact_float32():
            g_loss, aux = self._g_loss(state, synth, real)
            g_params = state.generators()
            # the generators' gradients only: D's parameters keep none
            grads = torch.autograd.grad(g_loss, g_params)
            for p, g in zip(g_params, grads):
                p.grad = g
            state.g_opt.step()
            state.g_opt.zero_grad(set_to_none=True)

            d_loss = self._d_loss(state, synth, real, aux["fake_real"],
                                  aux["fake_synth"])
            state.d_opt.zero_grad(set_to_none=True)
            d_loss.backward()
            state.d_opt.step()
        state.step += 1
        metrics: Dict[str, torch.Tensor] = {
            k: v.detach() for k, v in aux.items() if not k.startswith("fake")}
        metrics.update(g_loss=g_loss.detach(), d_loss=d_loss.detach())
        return state, metrics

    def export_transfer_variables(self, state: CycleGANState) -> Dict:
        """G_A, the synth -> real generator, as the JAX tree ``{"params":
        ...}`` of numpy arrays: the layout ``pipelines.save_variables_npz``
        writes and ``Trainer``'s transfer net (``load_generator_npz``)
        reads."""
        return generator_state_dict_to_jax(state.G_A.state_dict())
