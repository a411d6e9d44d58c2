"""dsf_tpu_torch — the PyTorch/CUDA port of dsf_tpu for NVIDIA Hopper.

The JAX package ``dsf_tpu`` stays the reference; this package mirrors its
layout module for module and imports nothing of it (nor JAX).  Plain tensor
code is PyTorch; every Pallas kernel that ``dsf_tpu`` runs on the ported
path is a hand-written CUDA kernel under ``csrc/``, built at first use by
``kernels.build``.  Each kernel keeps a plain PyTorch version beside it,
which runs for tensors on the CPU (the tests) and is what the kernel is
held against on the card.

Ported so far: the serving path — ``serving.InferenceEngine.predict`` over
the two-stage ``ManoOCRStage`` (stage-2 re-render through the skip-raster
kernel, offset-codec encode/decode kernels, MANO LBS) — and the two-stage
Pretrain training step, ``training.trainer.Trainer.train_step_fn`` (synth
factory, train-mode BatchNorm, the raster's moment backward and the
codec's VJPs as kernels, AdamW behind a finite guard).

Layer map:
  config, geometry — configuration, camera/crop math
  mano             — MANO LBS, static tables, synthetic asset, the
                     MANO_RIGHT.pkl converter
  ops              — rasterizer + K1 skip-raster + K2 moments (backward),
                     offset codec + K4/K5 (forward and backward)
  render           — crop-frame renderer (render_params, synth_sample)
  models           — ManoOCRStage (reference state-dict names), weights
  losses, training — SmoothL1; the Pretrain phase and its trainer
  data             — depth readers, the NYU, ICVL, MSRA, SHREC and DHG
                     loaders, MANO-parameter sources (numpy, host library)
  tools            — offline pre-render, SHREC skeleton export, MANO
                     fitting, self-intersection and hand-object volumes,
                     the loader benchmark, the Kinect preview
  serving          — bucketed InferenceEngine and its export
  exported         — load_exported: an exported bucket, with the op
                     registry and no model code
  kernels, csrc    — CUDA sources, their build and the custom ops
                     (torch.library, namespace dsf) of the serving path
"""

__version__ = "0.1.0"
