#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dsf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printed on its own line(s); any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), and the build of
   every CUDA kernel from csrc/ (one nvcc per source, in parallel), timed,
   with ptxas's register and shared-memory report;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving and training paths give it (K1 skip-raster and
   K2 raster moments at B=32 with 64x64 and 128x128 pixels, K2 also at the
   FinetuneStage step's 2B crops, each run twice (bitwise), K1's face
   set-up kernel bitwise against rasterize.skip_tables, K1 and K6 also on
   a crop without a hand, a hand shrunk until one tile meets more faces
   than a 256-face chunk holds, and a ragged 60x58 layout; K5 encode,
   K4 decode and their VJPs at B=32, J=21, S=64, the VJPs also twice
   (bitwise), against float64, on a cotangent or field with a NaN and an
   inf, and at B = 1, 32 and 64; K3 point->mesh argmin at
   the FinetuneStage step's 128 clouds x 2048 points x 1554 faces under the
   ICP's 16-column part table, its set-up kernel (face rows word for word,
   part lists, point order and tiles bitwise against
   point_mesh.argmin_tables_plain); K9, the CycleGAN generator's tail conv, on
   the generator's own head input at the training steps' B=32, 64 x 134^2,
   from the seeded stand-in generator on rendered hands, and on the same
   input scaled so that no output saturates (also against float64); K7,
   the ICP argmin with its admissibility skip words, at K3's shape, its
   set-up bitwise against point_mesh.v2_tables_plain, and without a part
   table; K8, the culled ICP argmin, at K3's shape, its set-up (keys and
   need words held to the cull's rule in float64, no winner culled); K6,
   the dense raster, at the pre-render's B=32 NYU frames of 640x480, its
   set-up bitwise, and on the frames' samples in a random
   order; K10, the binned raster, on B=32 crops of 64x64, the serving
   path's stage-2 render, and of 128x128, its set-up (rows bitwise, tile
   boxes, counts and overflow flag) against its plain version, its raster
   and route against raster_binned_plain, and with its overflow flag set,
   so that every tile takes the dense branch, against raster_scan); K9's
   bfloat16 variant on the bfloat16 stand-in generator's own head input
   at B=32, against its plain version on the card (within a whole
   bfloat16 step at each of its three roundings, carried through tanh:
   near a sum that cancels the bias a step of the sum is many steps of
   the output; and different on at most 1% of the outputs) and against
   tanh of the float64 sum of the same bfloat16 values (within half a
   step at each rounding), also on the input scaled so nothing
   saturates: error,
   kernel and plain device time (CUDA events, warm L2, the host's enqueue
   hidden behind a sleep kernel; for K1, K6, K10, K3, K7 and K8 the
   set-up, the kernel and the whole route apart; for K3, K7 and K8 the
   pair slots their body evaluates),
   the time of one PyTorch library call computing the same
   function where there is one, and the bound (the larger of bytes over
   3.35 TB/s and float operations over the H100 SXM's published dense
   rate for the operands' type: 67 TFLOP/s for float32 outside the
   tensor cores, 989 TFLOP/s for bfloat16);
3. slice: the two-stage ManoOCRStage InferenceEngine at full width
   (ResNet-18 trunks, 128x128 crops, 21 joints, buckets (1, 8, 32), f32)
   with a synthetic MANO asset and seeded random weights, answering
   requests of 1, 5, 32 and 40 crops.  The launch counters, zeroed just
   before, must show every kernel of the path; outputs must be finite,
   the stage-2 render must cover > 2% of its pixels, and the outputs must
   agree with the same engine on the CPU (the kernels' plain versions);
   then the same requests with the skip raster switched off
   (``rasterize.USE_PALLAS_SKIP``): K10 in K1's place, outputs as the skip
   route's, and each K10 route call's output held against its plain
   version on the call's own inputs; then ``predict_from_depth`` on one
   raw 640x480 frame (the host crop), against the CPU engine; then the
   median latency per bucket.
   Then the same requests through the bfloat16 engine
   (``Config(compute_dtype="bfloat16")``): the same launches, outputs
   finite, the stage-2 render covering > 2%, its outputs against the
   CPU's bfloat16 engine and the card's float32 engine within 3x the
   distance from the CPU's bfloat16 engine to its float32 one (+ the
   float32 tolerances), and away from the card's float32 engine by at
   least a third of that distance (it does round as bfloat16; the MANO
   head takes and returns bfloat16); the stage-1 MANO head's
   bfloat16 GEMM with and without cuBLAS's reduced-precision reduction
   against the CPU; the bfloat16 latency per bucket;
4. training: the two-stage Pretrain step, the two-stage FinetuneStage step
   and the one-stage Finetune step (Trainer.train_step_fn) at full width
   (ResNet-18 trunks, 128x128 crops, B=32, f32 without TF32) from seeded
   weights, 5 steps each, each with the frozen CycleGAN generator
   (ngf 64, 9 blocks) on its synth batch: ``transferNet_pth`` names a
   missing file, so the trainer builds the seeded stand-in, as the JAX
   package's bench does; the self-supervised steps' real half is
   demo.real_batch (rendered hands).  The launch counters, zeroed just
   before each path, must show every kernel of the path launched the
   expected number of times on every step; every loss must be finite;
   then the median step time and the peak memory.  FinetuneStage runs
   twice more, with ``point_mesh.USE_V2_KERNEL`` (K7 in K3's place) and
   with ``USE_CULLED_KERNEL`` (K8).  Then the offline pre-render
   (tools/prerender.py) of 64 seeded parameter sets at NYU's 640x480 in
   batches of 32: K6 once a batch, the PNGs read back, the hands'
   foreground median in 400-800 mm, and two frames against the CPU's.
   Then Pretrain, FinetuneStage and Finetune in the bfloat16 compute
   dtype, 5 steps each (K9's bfloat16 variant once a step, the float32 K9
   never, every other kernel as in float32; losses finite; step time and
   peak memory);
5. GPU = CPU: first the bfloat16 compute dtype's layers at the trunks'
   and the generator's shapes (BatchNorm with one group in train and eval
   mode and with two groups, the instance norm, convolutions, transposed
   convolutions and the dense layer), card against CPU, each output
   bfloat16 and different on at most 1% of its elements, each within one
   bfloat16 step + 2^-14 of the output's largest magnitude (where a sum
   cancels, float32 rounding at the terms' scale is many steps of the
   output), the running statistics within 1e-5 of their largest
   magnitude.  Then
   one Pretrain loss and one FinetuneStage loss (without the
   generator) and their gradients at B=4, on the card (twice) and on the
   CPU (the kernels' plain versions), from the same weights and the same
   synth (and real) batch; silhouette flips, part labels and nearest
   faces that differ between the devices are counted.  The same loss on
   the CPU in float64 is the witness: each float32 run's gradients and
   metrics are printed against it, and the GPU's second run against its
   first.  The Pretrain and FinetuneStage losses also run in the bfloat16
   compute dtype on the card and on the CPU, from the same weights and
   batches, each held against the same float64 witness (``BF16_RATIO``;
   per parameter also a positive cosine and the CPU's norm within 2x).
   The FinetuneStage loss runs again on ICVL's camera (``demo.real_batch``
   on the ICVL renderer, synth hands 150-600 mm away, ICVL's joint order
   and error rule), held by the same loss, metric and gradient rules.
   Then the stand-in generator's image of a B=4 synth batch on the
   card against the CPU's and float64's, and one Finetune loss with the
   generator and its gradients, held as the FinetuneStage loss is.  Last,
   a Finetune loss whose real half is rendered from the net's own MANO
   prediction (its MANO head's weight zeroed, so the prediction is the
   head's bias whatever the image), so that the M2P gate passes: the M2P
   term and its gradient on the card against the CPU and float64;
6. loop: the trainer's own entry point.  A fake NYU set (256 train and
   70 test frames, the test ones in 3 views) built on the card
   (data.fake.make_fake_nyu: K6 once per batch of 32), timed; the
   loader alone (augmented batches of 32 at 128^2, decoding the PNGs,
   then from its depth cache); ``training.loop.run`` at full width
   (the default FinetuneStage config, two stages, B=32, 128^2, the
   stand-in generator, one epoch of 8 steps, test_during_train,
   result and mesh exports), each step's launch deltas as phase 4's and
   each eval batch's K1 x1, K4 x2, K5 x1, every loss and eval error
   finite, latest, best, train.log (Epoch#0, test:) and 70 rows in each
   view's result_0/1; the epoch's steps/s and its median step against
   phase 4's, the 3-view evaluation's frames/s; a second run resumed
   from the run directory (epoch 1; the net and the AdamW moments on
   the card and bitwise the saved ones); view 0's first batch evaluated
   on the card and on the CPU from the seeded weights the loop starts
   from, saved as a checkpoint (stage 1 within 1e-2 mm, stage 2 within
   0.5 mm), and from the loop's best checkpoint (printed: after 8 steps
   its eval-mode errors reach far beyond the engine's range, where
   float32 cannot resolve those tolerances); InferenceEngine.from_run_dir and
   predict_from_depth on a test frame; the finite guard
   (``guarded_update``, a finite and a NaN gradient) under
   ``torch.cuda.set_sync_debug_mode("error")``, and the host syncs left
   in one FinetuneStage step, listed with mode "warn";
7. datasets: the other datasets.  ICVL (128 train, 40 test frames and
   the two test lines its loader drops), MSRA (subjects 3 and 7, cubes
   180 and 160, to train; subject 2 to test) and SHREC (40 frames of
   640x480) stand-ins built on the card from rendered MANO hands
   (tests/torch_fake_sets.py, imported from the tests directory: K6 once
   per batch of 32), timed; K6 on 32
   ICVL frames (320x240) against its plain version, timed; the ICVL and
   MSRA loaders' augmented batches/s; ``loop.run`` at full width on ICVL
   (FinetuneStage) and MSRA (Finetune, one stage), one epoch of 4 steps
   each with test_during_train and the exports: each step's launch
   deltas as phase 4's, each eval batch's (K1, K4 x2, K5 for two stages;
   K4 for one), every loss finite, one result row per test frame, view 0
   only; the trained weights' eval errors printed (after 4 steps their
   eval-mode outputs can overflow float32); the median step and the eval
   frames/s; one test batch of each from the seeded weights on the card
   against the CPU, finite (stage 1 within 1e-2 mm, stage 2 within
   0.5 mm); ``export_skeletons``
   over the SHREC set on the card: (40, 63) finite rows within 0.5 mm of
   the CPU's;
8. cyclegan: the CycleGAN trainer's pipeline (``python -m
   dsf_tpu_torch.training cyclegan``'s ``pipelines.run_cyclegan``) at full
   width (two ResnetGenerators, ngf 64, 9 blocks, two PatchGAN
   discriminators, 128^2, B=32, float32 without TF32) for 6 steps on
   phase 6's fake NYU set, synth crops rendered from random MANO
   parameters: each step's launch deltas (K1 x1 for the synth batch, K9
   x6, the six generator passes' heads, trained through the plain
   version's backward), finite metrics, the median step time of the last
   5 (host clock to a synchronized g_loss) and images/s (B synth + B real
   a step), the peak memory; the exported ``transfer_G_A.npz`` read by
   ``load_transfer_net`` (bitwise G_A) and one FinetuneStage step of the
   trainer with it as the transfer net (phase 4's launches); then one
   CycleGAN step at full width, B=2, card against CPU and the CPU in
   float64 from the same seeded weights and inputs: g_loss and d_loss
   within 1e-4 relative, both fakes within 1e-3 max abs, each net's
   gradients within CYCLEGAN_GRAD_TOL of float64 and the card's median
   within 6x the CPU's, the biases before an instance norm (zero
   gradients) within 1e-4 of their weight's gradient.

9. parallel: the multi-GPU path (``parallel/``, the synchronized
   BatchNorm, the guarded optimizer's exchange, the engine's replicas).
   Each comparison prints ``par_distances``' readings (loss, heads,
   trunks' median, largest and least cosine, statistics in stage 1 and
   2) beside its limits (``PAR_*``, each with its readings).
   (a) World 1 over NCCL, this process a group of one: two FinetuneStage
   and two Pretrain steps at full width (B=32, 128^2, the stand-in
   generator) in float32 and bfloat16 with ``Mesh(collectives=True)``
   (every all-reduce runs) against the one-device steps from the same
   weights and draws: the launches per step phase 4's, the first step
   within PAR_SAME_SPLIT (float32; phase 5's tolerances) or PAR_BF16;
   the step ms of both paths.  (b) Two ranks of this script
   (``--phase9-rank``) on this card over gloo, 16 rows each of the global
   32: two steps of each phase against world 1's at B=32 (the second
   from rank 0's state after the first, carried into world 1, so that
   Adam's sign steps do not part the runs), each within PAR_SPLIT and,
   against world 1 rendering its synth batch in the ranks' stripes,
   within PAR_STRIPED; each rank's launches per step phase 4's, both
   ranks' parameters equal; the witnesses of the trunks' gap: world 1
   rendering in stripes against world 1 rendering whole, each rank's
   synth render against its rows of both (PAR_RENDER: the striped one),
   one step of each phase with cuDNN off on both sides (PAR_SPLIT
   still); the control, one step of each phase with BatchNorm on each
   rank's own rows, which must break PAR_SPLIT by each reading of
   PAR_CAUGHT; a conv+BN stack against
   world 1 within 1e-5; each rank's step ms and the flat gradient's
   all-reduce ms (gloo, staged through the host: not NCCL's time).
   (c) The same ranks with ``n_fsdp=2`` (ZeRO-3: the parameters sharded
   too, each unit gathered for its forward and backward): the guarded
   AdamW fed (b)'s gradients bitwise data parallelism's; two
   FinetuneStage steps from (b)'s seeded weights and inputs, under
   deterministic algorithms as (b)'s, bitwise (b)'s (losses, parameters,
   gathered moments, statistics), the mean gradient within
   PAR_SAME_SPLIT of (b)'s ranks' mean, phase 4's launches, half the
   parameter and optimizer bytes at rest; then a world of its own
   (``par_memory``) at depth 152, n_fsdp 1 and 2: each rank's parameter
   and optimizer bytes at rest, peak memory and step ms.  (d) The engine with
   ``num_devices=2`` on devices (cuda:0, cuda:0), buckets 8 and 32,
   against the one-device engine by phase 3's tolerances.  (e) As (b)
   over NCCL on two cards where the machine has them, else one line.
   The steps whose records are compared run under deterministic
   algorithms (``deterministic_algorithms``): with the defaults the
   state a first step leaves differs from run to run, and a second
   step's comparison with it.  ``--phase9`` runs the build and this
   phase alone.

10. ccssl: the CCSSL pipeline (``python -m dsf_tpu_torch.training
   ccssl``'s ``pipelines.run_ccssl``) at full width (two stages, 128^2,
   B=32, float32) for one epoch on phase 6's fake NYU set: the labelling
   pass (5 test-time passes a frame, K1 and K5 each pass, K4 a batch)
   and each step's launch deltas (K1, K2, K5 x3 and its VJP, K4 x2 and
   their VJPs), finite losses, the labelling frames/s, the median step
   ms and the peak memory; the written labels inside the 640x480 frame
   and their batches' uvd_gt within +-1.5; one bfloat16 CCSSL step,
   finite.  Then at B=4 from the same seeded weights, card against CPU
   and the CPU in float64: ``prediction_check``'s five warps bitwise but
   at counted ties (at 128^2 and on a 96^2 crop, where 1 / size is
   inexact), its joints within the engine's 0.5 mm in the crop
   frame and its confidences within 1e-5 (or 3x the CPU's distance from
   float64); one CCSSL loss within 1e-4 relative and its gradients
   within phase 5's float32 tolerances and witness rule (the stage-1
   MANO head, reached only through the stage-2 render, as FinetuneStage's
   with all its share through the trunk).  Last, the
   hourglass PoseNet at full width (2 stacks, 21 joints, inp_dim 256,
   B=32, 128^2) card against CPU in train mode (outputs, running
   statistics) and eval mode within 1e-4 relative L2, and its forward
   ms.  ``--phase10`` runs the build, the fake set and this phase alone.

11. export and fits: phase 3's engine exported (``InferenceEngine.export``)
   at buckets 1, 8 and 32 in float32 and bfloat16, and at 32 with
   ``USE_PALLAS_SKIP`` off, one child process an artifact
   (``--phase11-export``), all at once; each loaded by a child process of
   its own (``--phase11-load``) that imports ``dsf_tpu_torch.exported``
   and no model code (checked), all at once but timed one at a time;
   each artifact's call launches what live
   ``predict`` launches (K1 or K10, K5, K4 x2: the kernels are inside the
   artifact) and its outputs lie within phase 3's tolerances of live
   ``predict`` on the same request; export s, load s, MB and the median
   of 25 calls against live ``predict``'s.  Then ``tools/fit_mano.
   fit_params`` at B=32, 128^2, 50 steps from the neutral init against
   targets rendered near it (with their joints): K1 and K2 once a step,
   ms a step, m2d at most half its start; one step at B=4 card against
   CPU (the loss within 1e-4 relative once the render pixels the devices
   decide otherwise are out; the gradient from float64 within twice the
   CPU's); ``fit_params_world`` at B=32, finite and falling.
   ``--phase11`` runs the build and this phase alone.

12. library: the rest of the library surface at full width (B=32, 128^2
   crops on the NYU camera, the 1554-face MANO, 2048-point clouds), each
   function once on the card with the launch counts read around it:
   ``normal_render``, ``m_render`` (with occlusion draws), ``mesh_to_img``
   (K1 each, and K10 once with ``USE_PALLAS_SKIP`` off), ``get_depth``
   with a view rotation, its image sum differentiated (K1, K2), the three
   ICP losses forward and backward (K3 each: no part table, the 15-column
   joint table, the 5-column finger table), ``joint2feature`` and
   ``feature2joint`` (K5, K4), and the kernel-free rest (the labelers,
   ``pcl_to_img``, ``splat_points_min``, ``img_to_pcl``'s fixed scores,
   ``surface_loss``, ``depth_loss_select``, ``synth2real``,
   ``patch_gaussian``, ``mass_center``, ``warp_perspective``,
   ``roi_align``, the sphere part labels and distances, ``pcl_utils``).
   Each held against the CPU on the same inputs (the first 2 rows where
   the CPU's raster or argmin would take long), at the tolerance printed
   beside it, and timed (ms a call, CUDA events); then, outside the
   counted run, the three ICP losses under ``USE_V2_KERNEL`` (K7) and
   ``USE_CULLED_KERNEL`` (K8) on one cloud, card against CPU.
   ``--phase12`` runs the build and this phase alone.

13. deep: the ResNet-50, -101 and -152 trunks (``--net
   ResNet_stage_{50,101,152}``) and ``DSF_REMAT``, at full width from
   the damped seeded weights.  The engine at depths 50, 101 and 152 in
   float32 and at 50 in bfloat16, buckets 1, 8 and 32: requests of 1 and
   5 crops launch depth 18's kernels once a call (K1, K5, K4 x2), card
   against the CPU engine at phase 3's tolerances (bfloat16 by its
   witness rule), the median latency per bucket and images/s at 32.  The
   depth-50 engine exported at bucket 32 by a child process while the
   card serves and trains, loaded by another that imports no model code:
   artifact against live at phase 11's tolerances, its MB, export s and
   load s.  Pretrain, FinetuneStage and Finetune at depth 50, B=32,
   float32 and bfloat16, 5 steps each: depth 18's launches a step, the
   median step ms and peak memory; then card against CPU at B=4 with
   phase 5's tolerances and float64 witness (``compare_*(net=...)``).
   FinetuneStage at depth 152 with ``DSF_REMAT`` 0 and 1: the batch from
   two measured peaks (B=32 where it fits), one step of each from one
   state bitwise under deterministic algorithms (with the defaults the
   control, a second run without remat, and remat printed), then 5 timed
   steps of each with peak memory.  The command line's main with ``--net
   ResNet_stage_50`` on phase 6's set: one epoch of four FinetuneStage
   steps of B=64 with its eval, a resume (restored bitwise on the card),
   and a depth-18 checkpoint refused before any step.  ``--phase13`` runs
   the build, phase 6's fake set and this phase alone.

The last two lines are the kernels' JSON record and the device JSON.
Without CUDA, or outside the repository, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
# H100 SXM dense peaks by operand type: float32 on the CUDA cores,
# bfloat16 (float32 sums) on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
SEED = 0
INPUT_SIZE = 128                # full width: the default config's crops
BUCKETS = (1, 8, 32)
REQUEST_SIZES = (1, 5, 32, 40)  # 40 > 32 exercises the chunking
KERNEL_BATCH = 32
LATENCY_CALLS = 25
TRAIN_BATCH = 32                # the default config's batch
TRAIN_STEPS = 5
COMPARE_BATCH = 4               # GPU step vs CPU step
DECODE_BATCHES = (1, 32, 64)    # K4 timed at serving's bucket 1, B, 2B
KERNELS = ("raster_skip", "raster_moments", "codec_encode",
           "codec_encode_bwd", "codec_decode", "codec_decode_bwd",
           "point_mesh_argmin", "tail_conv", "tail_conv_bf16",
           "icp_argmin_v2", "icp_argmin_culled", "raster_dense",
           "raster_binned")


def launches(**counts):
    """Every kernel's launch count: those named, 0 for the rest."""
    return {k: counts.get(k, 0) for k in KERNELS}


# launches of each kernel in one two-stage Pretrain step: K1 renders the
# synth batch and the stage-2 input; K5 encodes both stages' labels and
# the stage-2 remap, whose VJP is the only one needed; K4 decodes both
# stages; K2 is the stage-2 render's backward
STEP_LAUNCHES = launches(raster_skip=2, raster_moments=1, codec_encode=3,
                         codec_encode_bwd=1, codec_decode=2,
                         codec_decode_bwd=2, tail_conv=1)
# ... and in one FinetuneStage step: K1 renders the synth batch (B), the
# stage-2 input inside the stacked forward (2B) and both stages' loss
# render (2B), and K2 is the backward of the last two; K5 encodes the synth
# labels and the stage-2 remap (whose VJP is needed); K4 decodes the synth
# outputs of both stages, the teacher (no VJP) and the real outputs of both
# stages; K3 is the ICP's one nearest-face pass over 4B clouds (K7 or K8
# under their switches)
FS_STEP_LAUNCHES = launches(raster_skip=3, raster_moments=2, codec_encode=2,
                            codec_encode_bwd=1, codec_decode=3,
                            codec_decode_bwd=2, point_mesh_argmin=1,
                            tail_conv=1)
# ... and in one Finetune step: K1 renders the synth batch and the real
# outputs' loss render, K2 is the latter's backward; K5 encodes the synth
# labels (no VJP: the labels are data); K4 decodes the synth and the real
# outputs (both with VJPs); K3 is the ICP's pass over 2B clouds.  In every
# step K9 is the generator's head, once (no backward: the generator is
# frozen)
F_STEP_LAUNCHES = launches(raster_skip=2, raster_moments=1, codec_encode=1,
                           codec_decode=2, codec_decode_bwd=2,
                           point_mesh_argmin=1, tail_conv=1)


# one eval batch of the loop: the stage-2 re-render, its remap, a decode
# per stage
EVAL_LAUNCHES = launches(raster_skip=1, codec_encode=1, codec_decode=2)


def bf16_launches(counts):
    """A float32 path's launch counts as the bfloat16 compute dtype runs
    it: the generator's head is K9's bfloat16 variant, every other kernel
    is launched as in float32 (the renders, the codec and the ICP stay
    float32)."""
    out = dict(counts, tail_conv_bf16=counts["tail_conv"])
    out["tail_conv"] = 0
    return out


# a transferNet_pth that names no file: the trainer's seeded stand-in
# generator, as the JAX package's bench.py and __graft_entry__.py set it
STAND_IN = "__random_init__"
ICP_POINTS = 2048               # points per cloud of the FinetuneStage step
# K3's, K7's and K8's bound: 63 float adds and multiplies per admissible
# pair, the divide-free form's; the three compute one function, and K8's
# divide form costs more per pair than the function needs
ICP_PER_PAIR_FLOPS = 63
PRERENDER_N = 64                # parameter sets of the pre-render path
PRERENDER_BATCH = 32            # the pre-render tool's default batch
HOLD_CYCLES = 200_000_000       # ~0.1 s of the card's clock, see time_ms
FAKE_TRAIN, FAKE_TEST = 256, 70  # the loop's fake NYU set: 8 steps of 32,
                                 # and a 6-frame tail in each test view
STEP_MEDIAN_MS = {}             # phase 4's median step ms by path tag
L2_BYTES = 50 * 2 ** 20         # the H100's L2 cache
# the codec's foreground test on a normalized depth image; the background
# normalizes to 1.0, or just under it in float32 when the crop centre's
# depth is large
FG = 0.99


class SmokeFailure(RuntimeError):
    pass


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's and PyTorch's deterministic algorithms for the duration
    (``warn_only``: an op without one warns and runs), the caller's
    settings restored after.  With the defaults the card's training steps
    do not repeat bitwise: two runs of one step from one state differ
    (phase 13 prints the control)."""
    import torch
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.  A
    sleep kernel holds the stream while the host queues the calls, so the
    wrappers' host overhead (tens of microseconds a call, longer than a
    small kernel runs) stays out of the time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_past_l2(tensors):
    """``tensors`` and enough clones of them that cycling through the
    copies reads twice the L2 between two reads of one copy."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, -(-2 * L2_BYTES // nbytes) + 1)
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(n - 1)]


def time_cold_ms(fn, copies, iters):
    """``time_ms`` of ``fn(*copy)``, each call on the next copy of
    ``copies_past_l2``: its inputs come from device memory, not L2."""
    nxt = itertools.cycle(copies)
    return time_ms(lambda: fn(*next(nxt)), max(iters, len(copies)))


def bound_ms(nbytes, flops, dtype="float32"):
    """The least time for ``nbytes`` moved and ``flops`` done on operands
    of ``dtype``, and which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    need(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- phase 2

def raster_pair_count(proj, faces, rays):
    """(pixel, face) pairs whose pixel lies in the face's screen bbox: the
    edge/depth evaluations this run's data needs."""
    import torch
    tri = proj[:, faces][..., :2]                  # (B, F, 3, 2)
    fmin, fmax = tri.amin(2), tri.amax(2)
    total = 0
    for s in range(0, rays.shape[1], 4096):
        r = rays[:, s:s + 4096, None, :]           # (B, p, 1, 2)
        inside = ((r >= fmin[:, None]) & (r <= fmax[:, None])).all(-1)
        total += int(inside.sum())
    return total


def raster_scene(renderer, B, stride, rng):
    """Posed hands in their crops: projected vertices, the crop's sample
    rays at ``stride``, the faces and the pixel layout."""
    from dsf_tpu_torch import demo
    from dsf_tpu_torch import geometry as geo
    from dsf_tpu_torch.mano import model as mano
    from dsf_tpu_torch.ops import rasterize as ras

    para, center, cube = demo.posed_params(renderer, B, rng)
    verts, _ = mano.get_mano_vertices(renderer.mano, *mano.split_params(para),
                                      global_scale=1.0 / 125.0)
    verts = verts * cube[:, None] / 2.0 + center[:, None]
    com = geo.xyz_to_uvd(center[:, None], renderer.paras)[:, 0]
    M = geo.crop_matrix(com, cube, renderer.paras, renderer.crop_size)
    rays = ras.crop_pixel_rays(M, renderer.crop_size, stride).contiguous()
    proj = ras.project_verts(verts, renderer.paras)
    H = W = renderer.crop_size[0] // stride
    return proj, rays, renderer.mano.faces, H, W


def check_setup(proj, faces, lib):
    """The raster set-up kernel (csrc/raster_setup.cuh, ``lib``'s copy)
    against its plain version (``rasterize.skip_tables``): the face rows
    bit for bit (``rasterize.face_rows``), the face and chunk boxes equal.
    Returns the set-up's tables."""
    import torch
    from dsf_tpu_torch.ops import raster_kernel
    from dsf_tpu_torch.ops import rasterize as ras

    got = raster_kernel.face_setup_cuda(proj, faces.to(torch.int32), lib)
    ref = ras.skip_tables(proj, faces)
    torch.cuda.synchronize()
    rows_bad = int((got[0].view(torch.int32) != ref[0].view(torch.int32)).sum())
    box_bad = int((got[1] != ref[1]).sum())
    cbox_bad = int((got[2] != ref[2]).sum())
    need(rows_bad == 0 and box_bad == 0 and cbox_bad == 0,
         f"the {lib} set-up disagrees with rasterize.skip_tables: {rows_bad} "
         f"row words, {box_bad} face-box and {cbox_bad} chunk-box values")
    return got


def faces_per_block(boxes, rays, blocks):
    """The faces each block of samples stages after its cull: boxes (B, F,
    4) against the box of each block's samples, rays (B, P, 2) taken in
    ``blocks`` (nb, S) index order -> (B, nb) counts."""
    uv = rays[:, blocks]                            # (B, nb, S, 2)
    lo, hi = uv.amin(2), uv.amax(2)
    bx = boxes[:, None]                             # (B, 1, F, 4)
    meet = ((bx[..., 0] <= hi[..., None, 0]) & (bx[..., 1] >= lo[..., None, 0])
            & (bx[..., 2] <= hi[..., None, 1]) & (bx[..., 3] >= lo[..., None, 1]))
    return meet.sum(-1)


def tile_blocks(H, W, device):
    """K1's blocks of a row-major H x W layout whose sides are multiples of
    its tile (``raster_kernel.SKIP_TILE``): each tile's sample indices."""
    import torch
    from dsf_tpu_torch.ops import raster_kernel
    th, tw = raster_kernel.SKIP_TILE
    ids = torch.arange(H * W, device=device).reshape(H // th, th, W // tw, tw)
    return ids.permute(0, 2, 1, 3).reshape(-1, th * tw)


def check_raster(renderer, B, stride, rng, record):
    """K1 at B crops of posed hands at ``stride`` (2: 64x64, the serving
    path's and the steps' stage-2 render; 1: 128x128): the set-up against
    its plain version, then the raster on its tables and the whole route
    (``rasterize.skip_forward``) against ``raster_scan``, zbuf bitwise and
    ids equal.  Times the set-up, the raster and the route apart, with the
    same tables built in PyTorch (``skip_tables``) beside them."""
    import torch
    from dsf_tpu_torch.ops import raster_kernel
    from dsf_tpu_torch.ops import rasterize as ras

    proj, rays, faces, H, W = raster_scene(renderer, B, stride, rng)
    P = H * W
    F = faces.shape[0]
    f32 = faces.to(torch.int32)

    tables = check_setup(proj, faces, "raster_skip")
    zk, ik = raster_kernel.raster_skip_launch(*tables, rays, (H, W))
    zr, ir = ras.skip_forward(proj, rays, faces, (H, W))
    zp, ip = ras.raster_scan(proj, rays, faces)
    torch.cuda.synchronize()
    z_bad = int((zk != zp).sum()) + int((zr != zp).sum())
    i_bad = int((ik != ip).sum()) + int((ir != ip).sum())
    covered = int((zp > 0).sum())
    err = float((zk - zp).abs().max())
    per_block = faces_per_block(tables[1], rays, tile_blocks(H, W, rays.device))

    ms = time_ms(lambda: raster_kernel.raster_skip_launch(*tables, rays,
                                                         (H, W)), 50)
    setup_ms = time_ms(lambda: raster_kernel.face_setup_cuda(proj, f32), 50)
    route_ms = time_ms(lambda: ras.skip_forward(proj, rays, faces, (H, W)), 50)
    tables_ms = time_ms(lambda: ras.skip_tables(proj, faces), 20)
    plain_ms = time_ms(lambda: ras.raster_scan(proj, rays, faces), 5, 1)
    # of each face's 16-float row, the 12 coefficients and the valid flag
    # carry information; the other 3 pad the row for float4 reads
    nbytes = B * F * 13 * 4 + rays.numel() * 4 + B * P * 8
    pairs = raster_pair_count(proj, faces, rays)
    bms, by = bound_ms(nbytes, 16 * pairs)
    say(f"kernel K1 raster_skip B={B} {H}x{W} F={F}: set-up rows bitwise, "
        f"boxes equal; zbuf mismatches {z_bad}, id mismatches {i_bad} (raster"
        f" and route), covered pixels {covered}/{B * P}, faces staged per "
        f"tile mean {float(per_block.float().mean()):.1f} max "
        f"{int(per_block.max())}, max_abs_err {err}, kernel {ms:.4f} ms, "
        f"set-up {setup_ms:.4f} ms, route {route_ms:.4f} ms (the tables in "
        f"PyTorch {tables_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{bms:.6f} ms by {by} ({pairs} pixel-face pairs in bbox, {nbytes} "
        f"bytes)")
    need(z_bad == 0 and i_bad == 0,
         f"K1 disagrees with its plain version at stride {stride}")
    need(covered > 0.02 * B * P, "K1 scene covers too little of the crop")
    if record:
        return {"name": "raster_skip", "route": "cuda",
                "source": "dsf_tpu_torch/csrc/raster_skip.cu",
                "replaces": "dsf_tpu/ops/pallas_raster.py:322",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": None,
                "setup_ms": setup_ms, "route_ms": route_ms}
    return None


def check_raster_cases(renderer, B, rng):
    """K1 and K6 on the scenes a cull could get wrong, each against
    ``raster_scan`` (zbuf bitwise, ids equal): a batch whose first crop
    holds no hand (moved 5000 px off), a hand shrunk 5x about its centre
    (every face within a few tiles: tiles that stage more faces than one
    256-face chunk holds, faces under a pixel), and a 60x58 layout of
    64x64 crops' rays (K1's tiles ragged in both directions)."""
    import torch
    from dsf_tpu_torch.ops import raster_kernel
    from dsf_tpu_torch.ops import rasterize as ras

    proj, rays, faces, H, W = raster_scene(renderer, B, 2, rng)
    f32 = faces.to(torch.int32)
    away = proj.clone()
    away[0, :, 0] += 5000.0
    small = proj.clone()
    mid = small[..., :2].mean(1, keepdim=True)
    small[..., :2] = mid + (small[..., :2] - mid) * 0.2
    ragged = rays.reshape(B, H, W, 2)[:, :60, :58].reshape(B, 3480, 2)
    cases = (("no hand in crop 0", away, rays, (H, W)),
             ("hand shrunk 5x", small, rays, (H, W)),
             ("ragged 60x58 tiles", proj, ragged.contiguous(), (60, 58)))
    for name, pj, ry, hw in cases:
        zp, ip = ras.raster_scan(pj, ry, faces)
        zk, ik = raster_kernel.raster_skip_cuda(pj, f32, ry, hw)
        zd, i_d = raster_kernel.raster_dense_cuda(pj, f32, ry)
        torch.cuda.synchronize()
        bad = [int((zk != zp).sum()), int((ik != ip).sum()),
               int((zd != zp).sum()), int((i_d != ip).sum())]
        note = ""
        if hw[0] % 16 == 0 and hw[1] % 16 == 0:
            boxes = ras.skip_tables(pj, faces)[1]
            most = int(faces_per_block(boxes, ry, tile_blocks(*hw, ry.device))
                       .max())
            note = f", faces staged per tile max {most}"
        say(f"kernel K1/K6 case {name} B={B} {hw[0]}x{hw[1]}: K1 zbuf/id "
            f"mismatches {bad[0]}/{bad[1]}, K6 {bad[2]}/{bad[3]}, covered "
            f"{int((zp > 0).sum())}/{zp.numel()}{note}")
        need(sum(bad) == 0, f"K1 or K6 disagrees with raster_scan: {name}")
        if name.startswith("no hand"):
            need(int((ip[0] >= 0).sum()) == 0 and int((ip[1:] >= 0).sum()) > 0,
                 "the crop without a hand is not background")
        if name.startswith("hand shrunk"):
            need(most > raster_kernel.CHUNK, "no tile stages more faces "
                 "than one chunk holds")


def batch_of(t, B):
    """``t``'s first B rows, repeated as often as B needs."""
    import torch
    reps = -(-B // t.shape[0])
    return torch.cat([t] * reps)[:B].contiguous()


def time_batches(fn, args, check):
    """K4's wrapper ``fn(*args)`` at each of DECODE_BATCHES (``args``' rows
    cut or repeated): its first call held by ``check(B, xs, out)``, then
    mean ms with the inputs warm in L2 and cold."""
    out = {}
    for B in DECODE_BATCHES:
        xs = [batch_of(a, B) for a in args]
        check(B, xs, fn(*xs))
        out[B] = {"warm": time_ms(lambda: fn(*xs), 50),
                  "cold": time_cold_ms(fn, copies_past_l2(xs), 50)}
    return out


def say_batches(name, times):
    say(f"  {name} by batch: " + "; ".join(
        f"B={B} warm {t['warm']:.4f} ms, cold {t['cold']:.4f} ms"
        for B, t in times.items()))


def nan_case(offset, img):
    """``offset`` with a NaN in joint 4's y unit row at a background pixel
    of image 0 and a +inf in joint 7's heat at a foreground pixel of image
    1: the plain version's rows (0, 4) and (1, 7) are not finite."""
    J = offset.shape[1] // 4
    bad = offset.clone()
    bg = (img[0, 0] >= FG).nonzero()[0]
    fg = (img[1, 0] < FG).nonzero()[0]
    bad[0, 3 * 4 + 1, bg[0], bg[1]] = float("nan")
    bad[1, 3 * J + 7, fg[0], fg[1]] = float("inf")
    return bad


def same_nonfinite(a, b):
    import torch
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.isinf(), b.isinf())
            and torch.equal(a[a.isinf()], b[b.isinf()]))


def check_codec(renderer, B, rng):
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.ops import codec_kernel
    from dsf_tpu_torch.ops import offset_codec as oc
    from dsf_tpu_torch.render import renderer as rnd

    para, center, cube = demo.posed_params(renderer, B, rng)
    img, juvd, _, _ = rnd.render_params(renderer, para, center, cube,
                                        img_stride=2)
    img, juvd = img.contiguous(), juvd.contiguous()
    J, S = juvd.shape[1], img.shape[-1]
    P = S * S

    enc_k = codec_kernel.encode_cuda(juvd, img, 0.8)
    enc_p = oc.joint2offset_plain(juvd, img, 0.8)
    enc_err = float((enc_k - enc_p).abs().max())
    noise = torch.from_numpy(
        (rng.randn(B, 4 * J, S, S) * 0.05).astype(np.float32)).to(img.device)
    offset = (enc_p + noise).contiguous()
    dec_k, st_k = codec_kernel.decode_cuda(offset, img, 0.8, 30.0)
    dec_p, st_p = oc.decode_fwd_plain(offset, img, 0.8, 30.0)
    dec_err = float((dec_k - dec_p).abs().max())
    torch.cuda.synchronize()
    # K4 forward: its statistics (the max exactly: the same products),
    # float64, two runs, the NaN case
    need(torch.equal(st_k[..., 0], st_p[..., 0]),
         "K4 forward's softmax max differs from the plain version's")
    z_rel = float(((st_k[..., 1] - st_p[..., 1]) / st_p[..., 1]).abs().max())
    need(z_rel <= 1e-5, f"K4 forward's softmax mass is {z_rel} off")
    y64, _ = oc.decode_fwd_plain(offset.double(), img.double(), 0.8, 30.0)
    d_k = float((dec_k.double() - y64).abs().max())
    d_p = float((dec_p.double() - y64).abs().max())
    need(d_k <= 3 * d_p, f"K4 forward lies {d_k} from float64, the plain "
         f"version {d_p}")
    again, st_again = codec_kernel.decode_cuda(offset, img, 0.8, 30.0)
    need(torch.equal(again, dec_k) and torch.equal(st_again, st_k),
         "K4 forward differs between two runs")
    bad = nan_case(offset, img)
    nan_k, _ = codec_kernel.decode_cuda(bad, img, 0.8, 30.0)
    nan_p, _ = oc.decode_fwd_plain(bad, img, 0.8, 30.0)
    fin = nan_p.isfinite()
    need(same_nonfinite(nan_k, nan_p) and bool((~fin).any())
         and float((nan_k - nan_p)[fin].abs().max()) <= 1e-5,
         "K4 forward's non-finite entries differ from the plain version's")
    say(f"kernel codec_decode B={B}: softmax mass {z_rel:.3g} relative from "
        f"plain; from float64 {d_k:.3g} (plain {d_p:.3g}); two runs bitwise "
        f"equal; NaN case: {int((~fin).sum())} non-finite entries, as plain")

    def fwd_holds(B, xs, got):
        """y within 1e-5 of decode_fwd_plain's and the max exactly: at B=1
        and 2 the rows are split over a cluster"""
        y_p, st_p = oc.decode_fwd_plain(*xs, 0.8, 30.0)
        err = float((got[0] - y_p).abs().max())
        need(err <= 1e-5 and torch.equal(got[1][..., 0], st_p[..., 0]),
             f"K4 forward at B={B} disagrees with decode_fwd_plain: {err}")

    dec_times = time_batches(
        lambda o, d: codec_kernel.decode_cuda(o, d, 0.8, 30.0), (offset, img),
        fwd_holds)
    say_batches("codec_decode", dec_times)

    out = []
    for name, err, kfn, pfn, nbytes, flops, replaces in (
            ("codec_encode", enc_err,
             lambda: codec_kernel.encode_cuda(juvd, img, 0.8),
             lambda: oc.joint2offset_plain(juvd, img, 0.8),
             (B * J * 3 + B * P + B * 4 * J * P) * 4, 22 * B * J * P,
             "dsf_tpu/ops/pallas_codec.py:253"),
            ("codec_decode", dec_err,
             lambda: codec_kernel.decode_cuda(offset, img, 0.8, 30.0),
             lambda: oc.decode_fwd_plain(offset, img, 0.8, 30.0),
             (B * 4 * J * P + B * P + B * J * 5) * 4, 25 * B * J * P,
             "dsf_tpu/ops/pallas_codec.py:125")):
        ms = time_ms(kfn, 50)
        plain_ms = time_ms(pfn, 20)
        bms, by = bound_ms(nbytes, flops)
        say(f"kernel {name} B={B} J={J} S={S}: max_abs_err {err}, kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.6f} ms by {by}")
        need(err <= 1e-5, f"{name} disagrees with its plain version: {err}")
        out.append({"name": name, "route": "cuda",
                    "source": "dsf_tpu_torch/csrc/codec.cu",
                    "replaces": replaces, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "library_ms": None})
    out[1]["ms_by_batch"] = dec_times
    return out


def check_moments(renderer, B, stride, rng):
    """K2 on the face ids of a real raster and the rows the raster backward
    builds from them (random cotangent): against float64, two runs
    bitwise; its time beside its plain version's and index_add_'s."""
    import torch
    from dsf_tpu_torch.ops import moments_kernel, raster_kernel

    proj, rays, faces, H, W = raster_scene(renderer, B, stride, rng)
    T = faces.shape[0]
    _, idx = raster_kernel.raster_skip_cuda(proj, faces.to(torch.int32), rays,
                                            (H, W))
    g = torch.from_numpy(rng.randn(B, H * W).astype(np.float32)).cuda()
    gm = g * (idx >= 0).float()
    upd = torch.stack([gm, gm * rays[..., 0], gm * rays[..., 1]], -1).contiguous()
    got = moments_kernel.face_moments_cuda(idx, upd, T)
    again = moments_kernel.face_moments_cuda(idx, upd, T)
    ref = moments_kernel.face_moments_plain(idx, upd.double(), T)
    absum = moments_kernel.face_moments_plain(idx, upd.abs().double(), T)
    torch.cuda.synchronize()
    need(torch.equal(got, again), "K2 differs between two runs")
    err = float((got.double() - ref).abs().max())
    # a float32 sum of n rows in any order rounds within n 2^-24 of the sum
    # of |rows|; a face covers at most ~300 pixels here: 2e-5
    worst = float(((got.double() - ref).abs() / (absum + 1e-30)).max())

    flat = (idx.long().clamp_min(0)
            + torch.arange(B, device=idx.device)[:, None] * T).reshape(-1)
    flat_rows = upd.reshape(-1, 3)
    ms = time_ms(lambda: moments_kernel.face_moments_cuda(idx, upd, T), 50)
    plain_ms = time_ms(lambda: moments_kernel.face_moments_plain(idx, upd, T), 20)
    lib_ms = time_ms(lambda: torch.zeros((B * T, 3), device=idx.device)
                     .index_add_(0, flat, flat_rows), 20)
    hits = int((idx >= 0).sum())
    # every id is read; only a covered pixel's row adds anything, so only
    # those rows are read; each face's 3 sums are written once
    nbytes = idx.numel() * 4 + hits * 3 * 4 + B * T * 3 * 4
    bms, by = bound_ms(nbytes, 3 * hits)
    say(f"kernel K2 raster_moments B={B} {H}x{W} T={T}: max_abs_err {err:.3g} "
        f"(vs float64; worst / sum|rows| {worst:.3g}), two runs bitwise "
        f"equal, {hits} covered pixels, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound {bms:.6f} ms "
        f"by {by}")
    need(worst <= 2e-5, f"K2 disagrees with its plain version: {worst}")
    return {"name": "raster_moments", "route": "cuda",
            "source": "dsf_tpu_torch/csrc/moments.cu",
            "replaces": "dsf_tpu/ops/pallas_raster.py:169",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def check_moments_shapes(renderer, rng):
    """K2 at chip_smoke's B=32 crops of 64x64 and 128x128 (the first is
    the record's) and at the FinetuneStage step's two launches, 2B crops
    of 64x64 and 128x128; returns the record with ``ms_by_shape``."""
    recs = {f"B={B} {INPUT_SIZE // stride}^2":
            check_moments(renderer, B, stride, rng)
            for B, stride in ((KERNEL_BATCH, 2), (KERNEL_BATCH, 1),
                              (2 * TRAIN_BATCH, 2), (2 * TRAIN_BATCH, 1))}
    first = next(iter(recs.values()))
    first["ms_by_shape"] = {
        shape: {k: r[k] for k in ("ms", "library_ms", "bound_ms", "max_abs_err")}
        for shape, r in recs.items()}
    return first


def check_codec_bwd(renderer, B, rng):
    """K5 bwd and K4 bwd against autograd of the plain versions on rendered
    hands, with random cotangents; K4 bwd also against its closed-form
    plain version and float64, twice, and on the NaN case."""
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.ops import codec_kernel
    from dsf_tpu_torch.ops import offset_codec as oc
    from dsf_tpu_torch.render import renderer as rnd

    para, center, cube = demo.posed_params(renderer, B, rng)
    img, juvd, _, _ = rnd.render_params(renderer, para, center, cube,
                                        img_stride=2)
    img, juvd = img.contiguous(), juvd.contiguous()
    J, S = juvd.shape[1], img.shape[-1]
    P = S * S
    g_enc = torch.from_numpy(rng.randn(B, 4 * J, S, S).astype(np.float32)).cuda()
    g_dec = torch.from_numpy(rng.randn(B, J, 3).astype(np.float32)).cuda()
    offset = (oc.joint2offset_plain(juvd, img, 0.8) + 0.05 * g_enc).contiguous()
    with torch.no_grad():
        y, st = codec_kernel.decode_cuda(offset, img, 0.8, 30.0)
    # the work this data needs: the encode VJP reads g only where a joint's
    # cone meets the foreground (elsewhere the field is 0 whatever the
    # joint); the decode VJP reads the field only at foreground pixels (the
    # mask zeroes the rest), but every pixel keeps its softmax mass, so its
    # weight, its share of the sums and its depth gradient (~10 operations
    # per joint) remain.  The images, the joints and every output are read
    # or written whole.  (The decode VJP's kernel reads the background's
    # field too, which a NaN there needs: its floor is printed beside.)
    fg = img < FG
    coords = oc._coords(img, S)
    dist = ((juvd[..., None, None] - coords[:, None]) ** 2).sum(2).sqrt()
    cone = int(((dist <= 0.8) & fg).sum())
    n_fg = int(fg.sum())

    def vjp(f, xs, g):
        xs = [x.detach().requires_grad_(True) for x in xs]
        with torch.enable_grad():
            return torch.autograd.grad(f(*xs), xs, g)

    def rel_err(got, ref):
        return max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(got, ref))

    enc_plain = lambda: vjp(lambda j, d: oc.joint2offset_plain(j, d, 0.8),
                            (juvd, img), g_enc)
    dec_auto = lambda: vjp(lambda o, d: oc.offset2joint_plain(o, d, 0.8, 30.0),
                           (offset, img), g_dec)
    dec_plain = lambda: oc.decode_bwd_plain(offset, img, g_dec, y, st, 0.8,
                                            30.0)
    enc_k = lambda: codec_kernel.encode_bwd_cuda(juvd, img, g_enc, 0.8)
    dec_k = lambda: codec_kernel.decode_bwd_cuda(offset, img, g_dec, y, st,
                                                 0.8, 30.0)

    # K4 bwd: its closed-form plain version, float64 (autograd), two runs,
    # the NaN case, and its time at each batch
    got = dec_k()
    again = dec_k()
    plain = dec_plain()
    torch.cuda.synchronize()
    need(all(torch.equal(a, b) for a, b in zip(got, again)),
         "K4 VJP differs between two runs")
    rel_plain = rel_err(got, plain)
    need(rel_plain <= 1e-4, f"K4 VJP disagrees with decode_bwd_plain: "
         f"{rel_plain}")
    ref64 = vjp(lambda o, d: oc.offset2joint_plain(o, d, 0.8, 30.0),
                (offset.double(), img.double()), g_dec.double())
    d_k, d_p = rel_err(got, ref64), rel_err(plain, ref64)
    need(d_k <= 3 * d_p, f"K4 VJP lies {d_k} from float64, the plain version "
         f"{d_p}")
    bad = nan_case(offset, img)
    with torch.no_grad():
        yb, stb = codec_kernel.decode_cuda(bad, img, 0.8, 30.0)
    dxb, ddb = codec_kernel.decode_bwd_cuda(bad, img, g_dec, yb, stb, 0.8,
                                            30.0)
    ax, ad = vjp(lambda o, d: oc.offset2joint_plain(o, d, 0.8, 30.0),
                 (bad, img), g_dec)

    def bad_rows(dx, dd):
        """(image, joint) rows of dx and images of dd with a non-finite
        entry"""
        nf = ~dx.reshape(B, 4 * J, P).isfinite().all(-1)
        rows = nf[:, :3 * J].reshape(B, J, 3).any(-1) | nf[:, 3 * J:]
        return rows, ~dd.reshape(B, P).isfinite().all(-1)

    kr, ki = bad_rows(dxb, ddb)
    ar, ai = bad_rows(ax, ad)
    need(torch.equal(kr, ar) and torch.equal(ki, ai) and bool(ar.any()),
         "K4 VJP's non-finite rows differ from autograd's")
    say(f"kernel codec_decode_bwd B={B}: {rel_plain:.3g} of the largest entry "
        f"from decode_bwd_plain; from float64 {d_k:.3g} (decode_bwd_plain "
        f"{d_p:.3g}); two runs bitwise equal; NaN case: non-finite rows "
        f"{kr.nonzero().tolist()} and images {ki.nonzero().flatten().tolist()}"
        f", as autograd's (elementwise the same: "
        f"{torch.equal(dxb.isfinite(), ax.isfinite())})")

    def bwd_holds(B, xs, got):
        rel = rel_err(got, oc.decode_bwd_plain(*xs, 0.8, 30.0))
        need(rel <= 1e-4, f"K4 VJP at B={B} disagrees with decode_bwd_plain: "
             f"{rel}")

    bwd_times = time_batches(
        lambda o, d, g, yy, ss: codec_kernel.decode_bwd_cuda(
            o, d, g, yy, ss, 0.8, 30.0), (offset, img, g_dec, y, st),
        bwd_holds)
    say_batches("codec_decode_bwd", bwd_times)
    enc_times = check_encode_bwd(juvd, img, g_enc, enc_plain, vjp, rel_err)
    auto_ms = time_ms(dec_auto, 20)
    field = B * 4 * J * P * 4
    floor_ms = (2 * field + 2 * B * P * 4) / PEAK_BYTES_PER_S * 1e3
    say(f"  codec_decode_bwd: the whole field's floor {floor_ms:.6f} ms (read "
        f"and written once, depth and d depth once); autograd of "
        f"offset2joint_plain {auto_ms:.4f} ms")

    out = []
    for name, kfn, pfn, nbytes, flops, replaces in (
            ("codec_encode_bwd", enc_k, enc_plain,
             (2 * B * J * 3 + 2 * B * P + 4 * cone) * 4, 40 * cone,
             "dsf_tpu/ops/pallas_codec.py:280"),
            ("codec_decode_bwd", dec_k, dec_plain,
             (4 * J * n_fg + B * 4 * J * P + 2 * B * P + B * J * 3) * 4,
             55 * J * n_fg + 10 * J * (B * P - n_fg),
             "dsf_tpu/ops/pallas_codec.py:154")):
        got = kfn()
        ref = enc_plain() if name == "codec_encode_bwd" else dec_auto()
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        rel = rel_err(got, ref)
        ms = time_ms(kfn, 50)
        plain_ms = time_ms(pfn, 20)
        bms, by = bound_ms(nbytes, flops)
        say(f"kernel {name} B={B} J={J} S={S}: max_abs_err {err:.3g} "
            f"({rel:.3g} of the gradient's largest entry, against autograd), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.6f} ms "
            f"by {by} ({n_fg} foreground pixels of {B * P}, {cone} "
            "joint-pixel pairs in a cone)")
        # sums over pixels and joints in other orders; near a joint the
        # encode's 1/dist^2 amplifies rounding
        need(rel <= 1e-4, f"{name} disagrees with its plain version: {rel}")
        out.append({"name": name, "route": "cuda",
                    "source": "dsf_tpu_torch/csrc/codec.cu",
                    "replaces": replaces, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "library_ms": None})
    out[0]["ms_by_batch"] = enc_times
    out[1]["ms_by_batch"] = bwd_times
    return out


def encode_nan_case(juvd, img, g):
    """``g`` with a NaN in image 0's joint-4 x unit row at a pixel outside
    joint 4's cone and a +inf in image 1's joint-7 heat row at a foreground
    pixel inside joint 7's cone: autograd's d joint rows (0, 4) and (1, 7)
    and the d depth of those two pixels are not finite."""
    import torch
    from dsf_tpu_torch.ops import offset_codec as oc
    J, S = juvd.shape[1], img.shape[-1]
    coords = oc._coords(img, S)
    dist = ((juvd[:, :, :, None, None] - coords[:, None]) ** 2).sum(2).sqrt()
    out = (dist[0, 4] > 0.8).nonzero()[0]
    inside = ((dist[1, 7] < 0.8) & (img[1, 0] < FG)).nonzero()[0]
    bad = g.clone()
    bad[0, 3 * 4, out[0], out[1]] = float("nan")
    bad[1, 3 * J + 7, inside[0], inside[1]] = float("inf")
    return bad


def check_encode_bwd(juvd, img, g, enc_plain, vjp, rel_err):
    """K5 bwd (one launch a call) on rendered hands: against float64 (no
    further than 3x autograd's float32), two runs bitwise, the NaN case
    against autograd, and its time at each of DECODE_BATCHES; prints the
    whole-field floor beside."""
    import torch
    from dsf_tpu_torch import kernels
    from dsf_tpu_torch.ops import codec_kernel
    from dsf_tpu_torch.ops import offset_codec as oc

    B, J, _ = juvd.shape
    S = img.shape[-1]
    enc = lambda j, d, gg: codec_kernel.encode_bwd_cuda(j, d, gg, 0.8)
    before = kernels.LAUNCHES["codec_encode_bwd"]
    got = enc(juvd, img, g)
    again = enc(juvd, img, g)
    torch.cuda.synchronize()
    need(kernels.LAUNCHES["codec_encode_bwd"] == before + 2,
         "K5 bwd did not count one launch a call")
    need(all(torch.equal(a, b) for a, b in zip(got, again)),
         "K5 bwd differs between two runs")
    plain = enc_plain()
    ref64 = vjp(lambda j, d: oc.joint2offset_plain(j, d, 0.8),
                (juvd.double(), img.double()), g.double())
    d_k, d_p = rel_err(got, ref64), rel_err(plain, ref64)
    need(d_k <= 3 * d_p, f"K5 bwd lies {d_k} from float64, autograd's "
         f"float32 {d_p}")
    bad = encode_nan_case(juvd, img, g)
    kj, kd = enc(juvd, img, bad)
    aj, ad = vjp(lambda j, d: oc.joint2offset_plain(j, d, 0.8), (juvd, img),
                 bad)
    need(torch.equal(kj.isfinite(), aj.isfinite())
         and torch.equal(kd.isfinite(), ad.isfinite())
         and bool((~aj.isfinite()).any()),
         "K5 bwd's non-finite entries differ from autograd's")
    rows = (~kj.isfinite()).any(-1).nonzero().tolist()
    pix = (~kd.reshape(B, -1).isfinite()).nonzero().tolist()
    say(f"kernel codec_encode_bwd B={B}: from float64 {d_k:.3g} (autograd "
        f"{d_p:.3g}); two runs bitwise equal, one launch a call; NaN case: "
        f"non-finite (image, joint) rows {rows} and (image, pixel) {pix}, "
        "elementwise as autograd's")

    def holds(B, xs, out):
        rel = rel_err(out, vjp(lambda j, d: oc.joint2offset_plain(j, d, 0.8),
                               xs[:2], xs[2]))
        need(rel <= 1e-4, f"K5 bwd at B={B} disagrees with autograd: {rel}")

    times = time_batches(enc, (juvd, img, g), holds)
    say_batches("codec_encode_bwd", times)
    field = B * 4 * J * S * S * 4
    floor_ms = (field + 2 * B * S * S * 4 + 2 * B * J * 3 * 4) \
        / PEAK_BYTES_PER_S * 1e3
    gsum = time_ms(lambda: g.sum(), 50)
    say(f"  codec_encode_bwd: the whole field's floor {floor_ms:.6f} ms (g "
        f"read once, depth read and d depth written, joints and d joints); "
        f"g.sum() over the same field {gsum:.4f} ms")
    return times


def icp_scene(renderer, B, rng):
    """The FinetuneStage step's ICP shape: 4B clouds of 2048 points near
    the 2B stage meshes (each mesh twice: its full cloud admits every face,
    part 15; its joint cloud's points take a bone part 0..14 or -1, none),
    1554 faces, the 16-column part table; and the admissible pairs and the
    bytes that any of the argmin kernels must read and write."""
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.render import renderer as rnd

    para, _, _ = demo.posed_params(renderer, B, rng)
    _, mesh = rnd.get_mesh_xyz(renderer, para)
    mesh = torch.cat([mesh, mesh])                     # (2B, V, 3)
    N, P = 2 * B, ICP_POINTS
    dev = mesh.device
    idx = torch.from_numpy(rng.randint(0, 778, (N, P))).to(dev)
    noise = torch.from_numpy((rng.randn(N, P, 3) * 0.03).astype(np.float32))
    pts = (torch.gather(mesh, 1, idx[..., None].expand(N, P, 3))
           + noise.to(dev)).contiguous()
    part = torch.cat([torch.full((B, P), 15, device=dev),
                      torch.from_numpy(rng.randint(-1, 15, (B, P))).to(dev)])
    faces = renderer.mano.faces
    T = faces.shape[0]
    table = torch.cat([renderer.mano.joint_face_mask,
                       torch.ones(T, 1, dtype=torch.bool, device=dev)], dim=1)
    # the pairs this data needs: each point against the faces its part
    # admits (none for part -1); bytes: points, triangles, the table and
    # the parts read once, dmin and imin written once
    per_part = torch.cat([table.sum(0), torch.zeros(1, device=dev,
                                                    dtype=torch.long)])
    pairs = int(per_part[torch.where(part >= 0, part,
                                     torch.full_like(part, 16))].sum())
    nbytes = (pts.numel() * 4 + N * T * 9 * 4 + table.numel()
              + part.numel() * 8 + N * P * 8)
    return dict(mesh=mesh, pts=pts, part=part, faces=faces, table=table,
                tris=mesh[:, faces].contiguous(), N=N, P=P, T=T, pairs=pairs,
                nbytes=nbytes)


def hold_winners(name, sc, tris, ik, dp):
    """A kernel's winners by their exact distance against the plain minimum
    dp: within 1e-5 relative + 1e-6 (the kernels' distance forms subtract
    p.p + v.v ~ 1 in these unit-sized coordinates, so their rounding, ~1e-7,
    may pick a face that much further).  Returns (max_abs_err, points that
    admit no face)."""
    import torch
    from dsf_tpu_torch.ops import point_mesh as pm
    N, P = sc["N"], sc["P"]
    none = dp >= 1e10
    win = torch.gather(tris, 1, ik.long()[..., None, None].expand(N, P, 3, 3))
    d_win = pm.point_tri_sqdist(sc["pts"], win)
    err = float((d_win - dp)[~none].abs().max())
    worst = float(((d_win - dp).abs() - 1e-5 * dp.abs())[~none].max())
    need(worst <= 1e-6, f"{name}'s winners lie {worst} beyond 1e-5 relative "
         "+ 1e-6 from the plain minimum")
    return err, none


def argmin_slots(tables, R):
    """The pair slots K3's or K8's body evaluates on ``tables``: each tile's
    points rounded up to whole warps of 32 x R points (a warp of padding
    only skips), times its part's list length (K8: the stretches in chunks
    its run word keeps); and the pairs of its real points.  Returns (slots,
    real)."""
    import torch
    tiles = tables.tiles.long()
    valid = (torch.arange(tiles.shape[1], device=tiles.device)[None]
             < tables.tcount[:, :1].long())
    t = tiles[valid]
    part, count, run = t[:, 0], t[:, 2], t[:, 3]
    if tables.fperm is None:
        length = tables.lens.long()[part]
    else:
        seg = (tables.choff[:, 1:] - tables.choff[:, :-1]).long()  # (Kp, G)
        bits = (run[:, None] >> torch.arange(seg.shape[1],
                                             device=run.device)) & 1
        length = (seg[part] * bits).sum(-1)
    warp = 32 * R
    slots = int((((count + warp - 1) // warp) * warp * length).sum())
    return slots, int((count * length).sum())


def tables_against_plain(got, ref, names):
    """Entries of the set-up kernel's integer tables that differ from the
    plain version's, per name, and the rows' differing int32 words."""
    import torch
    bad = {n: int((getattr(got, n) != getattr(ref, n)).sum()) for n in names}
    bad["rows"] = int((got.rows.view(torch.int32)
                       != ref.rows.view(torch.int32)).sum())
    return bad


def check_point_mesh(sc):
    """K3 at the FinetuneStage step's shape (``icp_scene``): its set-up
    kernel against ``point_mesh.argmin_tables_plain`` (the rows word for
    word, the lists, keys, point order and tiles bitwise), the argmin on
    its tables and the route (set-up + argmin), held by the exact distance
    of the kernel's winning face against the plain minimum; index
    disagreements are counted.  Times the set-up, the argmin and the route
    apart, prints the pair slots evaluated."""
    import torch
    from dsf_tpu_torch.ops import point_mesh as pm
    from dsf_tpu_torch.ops import point_mesh_kernel as pk

    pts, tris, table, part = sc["pts"], sc["tris"], sc["table"], sc["part"]
    N, P, T = sc["N"], sc["P"], sc["T"]
    tables = pk.argmin_setup_cuda(pts, tris, table, part)
    ref = pm.argmin_tables_plain(pts, tris, table, part)
    dk, ik = pk.argmin_faces_launch(pts, tables)
    dr, ir = pk.argmin_faces_cuda(pts, tris, table, part)
    dp, ip = pm.argmin_faces_plain(pts, tris, table, part)
    torch.cuda.synchronize()
    bad = tables_against_plain(tables, ref, ("lists", "lens", "choff", "key",
                                             "perm", "tiles", "tcount"))
    route_same = torch.equal(dk, dr) and torch.equal(ik, ir)
    err, none = hold_winners("K3", sc, tris, ik, dp)
    idx_diff = int((ik != ip).sum())
    none_ok = bool((ik[none] == 0).all()) and bool((dk[none] >= 1e10).all())
    admissible = bool(table[ik[~none].long(), part[~none]].all())
    slots, real = argmin_slots(tables, pk.POINTS_PER_THREAD)

    ms = time_ms(lambda: pk.argmin_faces_launch(pts, tables), 20)
    setup_ms = time_ms(lambda: pk.argmin_setup_cuda(pts, tris, table, part),
                       20)
    route_ms = time_ms(lambda: pk.argmin_faces_cuda(pts, tris, table, part),
                       20)
    tables_ms = time_ms(lambda: pm.argmin_tables_plain(pts, tris, table,
                                                       part), 3, 1)
    plain_ms = time_ms(lambda: pm.argmin_faces_plain(pts, tris, table, part),
                       3, 1)
    bms, by = bound_ms(sc["nbytes"], ICP_PER_PAIR_FLOPS * sc["pairs"])
    say(f"kernel K3 point_mesh_argmin {N} clouds x {P} points x {T} faces, "
        f"K=16: set-up against its plain version {bad} (entries differing); "
        f"route = set-up + argmin bitwise: {route_same}; winning-face "
        f"distance max_abs_err {err:.3g} against the plain minimum, index "
        f"disagreements {idx_diff} of {N * P}, points that admit no face "
        f"{int(none.sum())} (imin 0 there: {none_ok}), winners admissible: "
        f"{admissible}; pair slots evaluated {slots} ({sc['pairs']} "
        f"admissible pairs of {N * P * T}; padding {1 - real / slots:.4f}), "
        f"{int(tables.tcount[:, 0].sum())} tiles of {pk.TILE_POINTS} points; "
        f"argmin {ms:.4f} ms, set-up {setup_ms:.4f} ms, route "
        f"{route_ms:.4f} ms (the set-up in PyTorch {tables_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound {bms:.6f} ms by {by} "
        f"({sc['nbytes']} bytes)")
    need(not any(bad.values()), f"K3's set-up disagrees with its plain "
         f"version: {bad}")
    need(route_same, "K3's route disagrees with its set-up + argmin")
    # the index may differ where faces tie: a point nearest to a vertex is
    # as near to every face around it, and the two distance forms round
    # those equal distances differently
    need(none_ok and admissible, "K3 returned an inadmissible face or a "
         "nonzero index where no face is admissible")
    return {"name": "point_mesh_argmin", "route": "cuda",
            "source": "dsf_tpu_torch/csrc/point_mesh.cu",
            "replaces": "dsf_tpu/ops/pallas_point_mesh.py:316",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "setup_ms": setup_ms, "route_ms": route_ms, "pair_slots": slots,
            "padding": 1 - real / slots, "admissible_pairs": sc["pairs"]}


def v2_slots(tables, R):
    """The pair slots K7's body evaluates on ``tables``: in each (128-point
    tile, run chunk) block, every warp of 32 x R points (the caller's
    order) evaluates each face of the chunk that some point of the warp
    admits (a warp skips the others: the warp-uniform skip), 32 x R slots a
    face.  Returns (slots, the run blocks' real pairs: tile points x chunk
    faces)."""
    import torch
    N, P = tables.parts.shape
    T = tables.words.shape[0]
    G, NT = -(-T // 128), tables.skip.shape[1]
    dev = tables.parts.device
    wp = 32 * R
    onehot = torch.zeros((N, NT * 128, 32), dtype=torch.bool, device=dev)
    onehot[:, :P].scatter_(2, tables.parts.long()[..., None], True)
    wor = onehot.reshape(N, NT * 128 // wp, wp, 32).any(2)       # (N, NW, 32)
    fbits = ((tables.words.long()[:, None] >> torch.arange(32, device=dev))
             & 1).bool()                                          # (T, 32)
    admits = (wor.float() @ fbits.float().T) > 0                  # (N, NW, T)
    run = ((tables.skip.long()[..., None] >> torch.arange(G, device=dev))
           & 1).bool()                                            # (N, NT, G)
    run_w = run.repeat_interleave(128 // wp, 1)[..., torch.arange(
        T, device=dev) // 128]                                    # (N, NW, T)
    slots = int((admits & run_w).sum()) * wp
    faces = torch.bincount(torch.arange(T, device=dev) // 128, minlength=G)
    pts = torch.clamp(P - torch.arange(NT, device=dev) * 128, max=128)
    real = int((run.long() * pts[None, :, None] * faces[None, None]).sum())
    return slots, real


def check_icp_v2(sc):
    """K7 on K3's scene (faces in the caller's order): its set-up kernel
    against ``point_mesh.v2_tables_plain`` (the face order, words, chunk
    ORs, point parts and skip words bitwise, the rows word for word), the
    argmin on its tables and the route (set-up + argmin), held as K3 by the
    winning face's exact distance against its plain version's minimum (on
    the same part-sorted faces and skip words), every winner admissible,
    (1e10, the first face in the part order) where none is.  Then the same
    on the scene without a table, whose caller-order tiles admit every
    face, so that the warp skip has nothing to skip.  Times the set-up, the
    argmin and the route apart, prints the pair slots evaluated."""
    import torch
    from dsf_tpu_torch.ops import point_mesh as pm
    from dsf_tpu_torch.ops import point_mesh_kernel as pk

    pts, tris, table, part = sc["pts"], sc["tris"], sc["table"], sc["part"]
    N, P, T = sc["N"], sc["P"], sc["T"]
    tables = pk.v2_setup_cuda(pts, tris, table, part)
    ref = pm.v2_tables_plain(pts, tris, table, part)
    dk, ik = pk.argmin_faces_v2_launch(pts, tables)
    dr, ir = pk.argmin_faces_v2_cuda(pts, tris, table, part)
    fperm = ref.fperm.long()
    dp, ip = pm.argmin_faces_v2_plain(pts, tris[:, fperm], table[fperm], part,
                                      ref.skip)
    torch.cuda.synchronize()
    names = ("fperm", "words", "chunk_or", "parts", "skip")
    bad = tables_against_plain(tables, ref, names)
    route_same = torch.equal(dk, dr) and torch.equal(ik, ir)
    err, none = hold_winners("K7", sc, tris, ik, dp)
    none_ok = bool((ik[none] == fperm[0]).all()) and bool(
        (dk[none] >= 1e10).all())
    admissible = bool(table[ik[~none].long(), part[~none]].all())
    G = -(-T // pm.CHUNK)
    bits = (tables.skip[..., None] >> torch.arange(G, device=pts.device)) & 1
    share = float(bits.float().mean())
    share_joint = float(bits[N // 2:].float().mean())
    slots, real = v2_slots(tables, pk.V2_POINTS_PER_THREAD)

    # caller-order tiles that admit every face: no table
    tables_all = pk.v2_setup_cuda(pts, tris)
    bad_all = tables_against_plain(tables_all, pm.v2_tables_plain(pts, tris),
                                   names)
    da, ia = pk.argmin_faces_v2_launch(pts, tables_all)
    dpa, _ = pm.argmin_faces_plain(pts, tris)
    torch.cuda.synchronize()
    err_all, none_all = hold_winners("K7 without a table", sc, tris, ia, dpa)
    slots_all, _ = v2_slots(tables_all, pk.V2_POINTS_PER_THREAD)

    ms = time_ms(lambda: pk.argmin_faces_v2_launch(pts, tables), 20)
    setup_ms = time_ms(lambda: pk.v2_setup_cuda(pts, tris, table, part), 20)
    route_ms = time_ms(lambda: pk.argmin_faces_v2_cuda(pts, tris, table,
                                                       part), 20)
    ms_all = time_ms(lambda: pk.argmin_faces_v2_launch(pts, tables_all), 20)
    tables_ms = time_ms(lambda: pm.v2_tables_plain(pts, tris, table, part),
                        3, 1)
    plain_ms = time_ms(lambda: pm.argmin_faces_v2_plain(
        pts, tris[:, fperm], table[fperm], part, ref.skip), 3, 1)
    bms, by = bound_ms(sc["nbytes"], ICP_PER_PAIR_FLOPS * sc["pairs"])
    bms_all, _ = bound_ms(sc["nbytes"], ICP_PER_PAIR_FLOPS * N * P * T)
    say(f"kernel K7 icp_argmin_v2 {N} clouds x {P} points x {T} faces, "
        f"K=16: set-up against its plain version {bad} (entries differing); "
        f"route = set-up + argmin bitwise: {route_same}; winning-face "
        f"distance max_abs_err {err:.3g} against its plain version's "
        f"minimum, index disagreements {int((ik != fperm[ip.long()]).sum())} "
        f"of {N * P}, points that admit no face {int(none.sum())} (the first "
        f"part-order face there: {none_ok}), winners admissible: "
        f"{admissible}; blocks run {share:.4f} of "
        f"{N * tables.skip.shape[1] * G} "
        f"(joint clouds {share_joint:.4f}); pair slots evaluated {slots} "
        f"(the run blocks' pairs {real}, {sc['pairs']} admissible); argmin "
        f"{ms:.4f} ms, set-up {setup_ms:.4f} ms, route {route_ms:.4f} ms (the "
        f"set-up in PyTorch {tables_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"bound {bms:.6f} ms by {by}; without a table: set-up against its "
        f"plain version {bad_all}, winning-face max_abs_err {err_all:.3g}, "
        f"pair slots {slots_all} ({N * P * T} pairs), argmin {ms_all:.4f} ms, "
        f"bound {bms_all:.6f} ms")
    need(not any(bad.values()) and not any(bad_all.values()),
         f"K7's set-up disagrees with its plain version: {bad}, {bad_all}")
    need(route_same, "K7's route disagrees with its set-up + argmin")
    need(none_ok and admissible and not bool(none_all.any()),
         "K7 returned an inadmissible face or another id than the first "
         "part-order face's where no face is admissible")
    return {"name": "icp_argmin_v2", "route": "cuda",
            "source": "dsf_tpu_torch/csrc/point_mesh_v2.cu",
            "replaces": "dsf_tpu/ops/pallas_point_mesh.py:479",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "setup_ms": setup_ms, "route_ms": route_ms, "pair_slots": slots,
            "blocks_run": share, "admissible_pairs": sc["pairs"],
            "no_table_ms": ms_all, "no_table_pair_slots": slots_all}


def tile_of_points(tables):
    """(N, P) each point's tile in ``tables``, -1 for a point of no tile."""
    import torch
    tiles = tables.tiles.long()
    N, P = tables.perm.shape
    pos = torch.arange(P, device=tiles.device)
    inside = ((pos[None, None] >= tiles[..., 1:2])
              & (pos[None, None] < tiles[..., 1:2] + tiles[..., 2:3]))
    t_pos = torch.where(inside.any(1), inside.long().argmax(1),
                        torch.full_like(pos[None].expand(N, P), -1))
    return torch.empty_like(t_pos).scatter_(1, tables.perm.long(), t_pos)


def check_icp_culled(sc):
    """K8 on K3's scene: its set-up kernel against
    ``point_mesh.argmin_tables_plain(..., culled=True)`` (the rows word for
    word; the face order and part lists bitwise; the keys and need words,
    which come from float sphere math, held to the rule in float64 within
    rounding and their differences from the float32 plain ones counted;
    every point's winner in a chunk its tile runs), the argmin on its
    tables against its plain version on the same tables (dmin within 1e-5
    relative + 1e-6) and through ``argmin_faces_culled`` (the route, the
    caller's face ids) against the plain dense argmin by the winning face's
    exact distance, as K3.  Times the set-up, the argmin and the route
    apart, prints the pair slots evaluated."""
    import torch
    from dsf_tpu_torch.ops import point_mesh as pm
    from dsf_tpu_torch.ops import point_mesh_kernel as pk

    pts, tris, table, part = sc["pts"], sc["tris"], sc["table"], sc["part"]
    N, P, T = sc["N"], sc["P"], sc["T"]
    tables = pk.argmin_setup_cuda(pts, tris, table, part, culled=True)
    ref = pm.argmin_tables_plain(pts, tris, table, part, culled=True)
    dks, iks = pk.argmin_faces_culled_launch(pts, tables)
    dps, ips = pm.argmin_faces_culled_plain(pts, tables)
    dk, ik = pm.argmin_faces_culled(pts, tris, table, part)
    dp, ip = pm.argmin_faces_plain(pts, tris, table, part)
    torch.cuda.synchronize()
    bad = tables_against_plain(tables, ref, ("fperm", "lists", "lens",
                                             "choff"))
    fperm = tables.fperm.long()
    out_need, out_key = pm.cull_within_rounding(
        pts, tris[:, fperm], table[fperm], part, tables.key, tables.need)
    key_diff = int((tables.key != ref.key).sum())
    need_diff = int((tables.need != ref.need).sum())
    run_diff = (int((tables.tiles[..., 3] != ref.tiles[..., 3]).sum())
                if torch.equal(tables.perm, ref.perm) else "n/a (orders differ)")
    # the plain dense winner's chunk, in the part order, is run by its tile
    inv = torch.empty_like(fperm).scatter_(0, fperm, torch.arange(
        T, device=fperm.device))
    tile_of = tile_of_points(tables)
    live = (tile_of >= 0) & (dp < 1e10)
    run = torch.gather(tables.tiles[..., 3].long(), 1, tile_of.clamp(min=0))
    lost = int((live & (((run >> (inv[ip.long()] // 128)) & 1) == 0)).sum())
    live_s = dps < 1e10
    sorted_err = float((dks - dps)[live_s].abs().max())
    need(bool((dks >= 1e10)[~live_s].all()) and bool(
        ((dks - dps).abs() <= 1e-5 * dps.abs() + 1e-6)[live_s].all()),
         f"K8 disagrees with its plain version on its tables: {sorted_err}")
    err, none = hold_winners("K8", sc, tris, ik, dp)
    need(bool((ik[none] == int(fperm[0])).all())
         and bool(table[ik[~none].long(), part[~none]].all()),
         "K8 returned an inadmissible face, or another id than the first "
         "part-sorted face's where no face is admissible")
    slots, real = argmin_slots(tables, pk.POINTS_PER_THREAD)
    ms = time_ms(lambda: pk.argmin_faces_culled_launch(pts, tables), 20)
    setup_ms = time_ms(lambda: pk.argmin_setup_cuda(pts, tris, table, part,
                                                    culled=True), 20)
    route_ms = time_ms(lambda: pk.argmin_faces_culled_cuda(pts, tris, table,
                                                           part), 20)
    tables_ms = time_ms(lambda: pm.argmin_tables_plain(
        pts, tris, table, part, culled=True), 3, 1)
    plain_ms = time_ms(lambda: pm.argmin_faces_culled_plain(pts, tables), 3,
                       1)
    bms, by = bound_ms(sc["nbytes"], ICP_PER_PAIR_FLOPS * sc["pairs"])
    say(f"kernel K8 icp_argmin_culled {N} clouds x {P} points x {T} faces, "
        f"K=16: set-up against its plain version {bad} (entries differing), "
        f"keys differing {key_diff}, need words differing {need_diff}, run "
        f"words differing {run_diff}, need bits / keys outside float64 "
        f"rounding {out_need} / {out_key}, winners in a culled chunk {lost}; "
        f"against its plain version on its tables max_abs_err "
        f"{sorted_err:.3g} (index disagreements {int((iks != tables.fperm[ips.long()]).sum())}); "
        f"winning-face distance max_abs_err {err:.3g} against the plain "
        f"dense minimum; pair slots evaluated {slots} (padding "
        f"{1 - real / slots:.4f}; {sc['pairs']} admissible pairs, the "
        f"bound's count); argmin {ms:.4f} ms, set-up {setup_ms:.4f} ms, "
        f"route {route_ms:.4f} ms (the set-up in PyTorch {tables_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound {bms:.6f} ms by {by}")
    need(not any(bad.values()), f"K8's set-up disagrees with its plain "
         f"version: {bad}")
    need(out_need == 0 and out_key == 0, "K8's set-up keys or need words "
         "differ from the rule beyond float rounding")
    need(lost == 0, f"K8's cull drops the winning face of {lost} points")
    return {"name": "icp_argmin_culled", "route": "cuda",
            "source": "dsf_tpu_torch/csrc/point_mesh_culled.cu",
            "replaces": "dsf_tpu/ops/pallas_point_mesh.py:633",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "setup_ms": setup_ms, "route_ms": route_ms, "pair_slots": slots,
            "padding": 1 - real / slots, "admissible_pairs": sc["pairs"]}


def prerender_params(n, rng, depth=(550, 700)):
    """n seeded MANO parameter sets for the pre-render: random poses and
    global rotations, scale 1, the hand ``depth`` mm (550-700: NYU's
    camera) in front of the camera and up to 60 mm off its axis."""
    params = np.zeros((n, 62), np.float32)
    params[:, :3] = rng.randn(n, 3) * 0.2
    params[:, 3:48] = rng.randn(n, 45) * 0.3
    params[:, 58] = 1.0
    params[:, 59:61] = rng.uniform(-60, 60, (n, 2))
    params[:, 61] = rng.uniform(depth[0], depth[1], n)
    return params


def frame_pair_count(proj, faces, W, H):
    """(pixel, face) pairs of a W x H integer pixel grid whose pixel lies in
    the face's screen bbox, by counting the grid points in each bbox."""
    import torch
    tri = proj[:, faces][..., :2]
    lo, hi = tri.amin(2), tri.amax(2)
    lo = torch.clamp(torch.ceil(lo), min=0)
    hi = torch.minimum(torch.floor(hi),
                       torch.tensor([W - 1.0, H - 1.0], device=proj.device))
    n = torch.clamp(hi - lo + 1, min=0)
    return int((n[..., 0] * n[..., 1]).sum())


def check_raster_dense(renderer, B, rng, depth=(550, 700)):
    """K6 at the pre-render's shape: B full frames of the renderer's
    camera (NYU's 640x480 by default) of seeded hands ``depth`` mm away
    (``prerender_params``): the set-up against its plain version,
    then the raster on its tables and the whole route
    (``rasterize.dense_forward``) against ``raster_scan``, zbuf bitwise and
    ids equal, and the raster on the frames' samples in a random order
    (the same answers, permuted).  Times the set-up, the raster and the
    route apart, with the face rows built in PyTorch beside them."""
    import torch
    from dsf_tpu_torch.mano import model as mano
    from dsf_tpu_torch.ops import raster_kernel
    from dsf_tpu_torch.ops import rasterize as ras

    W, H = renderer.img_size
    params = torch.from_numpy(prerender_params(B, rng, depth)).cuda()
    verts, _ = mano.get_mano_vertices(renderer.mano, *mano.split_params(params))
    proj = ras.project_verts(verts, renderer.paras)
    rays = ras.full_frame_pixel_rays((W, H), "cuda").expand(B, -1, -1)
    rays = rays.contiguous()
    faces = renderer.mano.faces
    f32 = faces.to(torch.int32)
    F, P = faces.shape[0], W * H
    tables = check_setup(proj, faces, "raster_dense")
    zk, ik = raster_kernel.raster_dense_launch(*tables, rays)
    zr, ir = ras.dense_forward(proj, rays, faces)
    zp, ip = ras.raster_scan(proj, rays, faces)
    perm = torch.from_numpy(rng.permutation(P)).cuda()
    zq, iq = raster_kernel.raster_dense_launch(*tables,
                                               rays[:, perm].contiguous())
    torch.cuda.synchronize()
    z_bad = int((zk != zp).sum()) + int((zr != zp).sum())
    i_bad = int((ik != ip).sum()) + int((ir != ip).sum())
    q_bad = int((zq != zp[:, perm]).sum()) + int((iq != ip[:, perm]).sum())
    covered = int((zp > 0).sum())
    err = float((zk - zp).abs().max())
    ms = time_ms(lambda: raster_kernel.raster_dense_launch(*tables, rays), 20)
    setup_ms = time_ms(lambda: raster_kernel.face_setup_cuda(
        proj, f32, "raster_dense"), 50)
    route_ms = time_ms(lambda: ras.dense_forward(proj, rays, faces), 20)
    rows_ms = time_ms(lambda: ras.face_rows(proj, faces), 20)
    plain_ms = time_ms(lambda: ras.raster_scan(proj, rays, faces), 3, 1)
    nbytes = B * F * 13 * 4 + rays.numel() * 4 + B * P * 8
    pairs = frame_pair_count(proj, faces, W, H)
    bms, by = bound_ms(nbytes, 16 * pairs)
    say(f"kernel K6 raster_dense B={B} {W}x{H} F={F}: set-up rows bitwise, "
        f"boxes equal; zbuf and id mismatches {z_bad} and {i_bad} (raster and"
        f" route), {q_bad} on the samples permuted; covered pixels "
        f"{covered}/{B * P}, max_abs_err {err}, kernel {ms:.4f} ms, set-up "
        f"{setup_ms:.4f} ms, route {route_ms:.4f} ms (face_rows in PyTorch "
        f"{rows_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bms:.6f} ms by "
        f"{by} ({pairs} pixel-face pairs in bbox of {B * P * F}, {nbytes} "
        f"bytes)")
    need(z_bad == 0 and i_bad == 0, "K6 disagrees with its plain version")
    need(q_bad == 0, "K6 on permuted samples disagrees with its plain version")
    need(covered > 0.01 * B * P, "K6 scene covers too little of the frame")
    return {"name": "raster_dense", "route": "cuda",
            "source": "dsf_tpu_torch/csrc/raster_dense.cu",
            "replaces": "dsf_tpu/ops/pallas_raster.py:484",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "setup_ms": setup_ms, "route_ms": route_ms}


def check_binned_setup(proj, faces, rays, hw):
    """K10's set-up kernels (``raster_kernel.binned_setup_cuda``) against
    their plain version (``rasterize.binned_setup_plain``: ``skip_tables``
    and ``binned_tables``): rows bit for bit, cover, chunk, screen and tile
    boxes, counts and the overflow flag equal.  Returns the set-up's
    tables."""
    import torch
    from dsf_tpu_torch.ops import raster_kernel
    from dsf_tpu_torch.ops import rasterize as ras

    got = raster_kernel.binned_setup_cuda(proj, faces, rays, hw)
    ref = ras.binned_setup_plain(proj, faces, rays, hw)
    torch.cuda.synchronize()
    bad = {"row words": int((got.rows.view(torch.int32)
                             != ref.rows.view(torch.int32)).sum())}
    for name in ("boxes", "cbox", "vbox", "tbox", "counts", "overflow"):
        bad[name] = int((getattr(got, name) != getattr(ref, name)).sum())
    need(sum(bad.values()) == 0, f"K10's set-up disagrees with "
         f"rasterize.binned_setup_plain: {bad}")
    return got


def binned_plain(proj, faces, rays, hw):
    """K10's plain version on the route's inputs: ``raster_binned_plain``
    over ``face_rows`` and ``binned_tables`` (the CPU path's), and the
    tables' overflow flag."""
    from dsf_tpu_torch.ops import rasterize as ras
    rows = ras.face_rows(proj, faces)
    tables = ras.binned_tables(proj, rays, faces, hw, rows)
    return ras.raster_binned_plain(rows, rays, hw, *tables), tables


def binned_times(proj, faces, rays, hw, tables, iters):
    """K10's device times on one call's inputs: the raster on the set-up's
    tables, the set-up, the route (set-up + raster) and, beside them, the
    PyTorch tables that the route replaced (``face_rows`` and
    ``binned_tables``) and the plain version."""
    from dsf_tpu_torch.ops import raster_kernel
    from dsf_tpu_torch.ops import rasterize as ras
    t = tables
    return {
        "ms": time_ms(lambda: raster_kernel.raster_binned_launch(
            t.rows, t.boxes, t.cbox, t.vbox, t.tbox, rays, t.overflow, hw),
            iters),
        "setup_ms": time_ms(lambda: raster_kernel.binned_setup_cuda(
            proj, faces, rays, hw), iters),
        "route_ms": time_ms(lambda: ras.binned_forward(proj, rays, faces, hw),
                            iters),
        "tables_ms": time_ms(lambda: ras.binned_tables(
            proj, rays, faces, hw, ras.face_rows(proj, faces)), 20),
        "plain_ms": time_ms(lambda: binned_plain(proj, faces, rays, hw), 3, 1)}


def check_raster_binned(renderer, B, stride, rng):
    """K10 on B crops of posed hands at ``stride`` (2: 64x64, the serving
    path's stage-2 render, which takes K10 when the skip route is off; 1:
    128x128): its set-up against its plain version (``check_binned_setup``),
    then its raster on the set-up's tables and its whole route
    (``rasterize.binned_forward``) against ``raster_binned_plain`` over
    ``binned_tables``, zbuf bitwise and ids equal; then the raster with the
    overflow flag set, so that every tile takes the dense branch, against
    ``raster_scan`` the same way.  K10's record is taken on the serving
    path's own inputs (``binned_serving_record``)."""
    import torch
    from dsf_tpu_torch.ops import raster_kernel
    from dsf_tpu_torch.ops import rasterize as ras

    proj, rays, faces, H, W = raster_scene(renderer, B, stride, rng)
    P, F, hw = H * W, faces.shape[0], (H, W)
    t = check_binned_setup(proj, faces, rays, hw)
    (zp, ip), (_, counts, overflow) = binned_plain(proj, faces, rays, hw)
    zs, i_s = ras.raster_scan(proj, rays, faces)
    forced = torch.ones_like(t.overflow)
    runs = {"raster": raster_kernel.raster_binned_launch(
                t.rows, t.boxes, t.cbox, t.vbox, t.tbox, rays, t.overflow,
                hw),
            "route": ras.binned_forward(proj, rays, faces, hw)}
    dense = raster_kernel.raster_binned_launch(t.rows, t.boxes, t.cbox,
                                               t.vbox, t.tbox, rays, forced,
                                               hw)
    torch.cuda.synchronize()
    bad = {k: (int((z != zp).sum()), int((i != ip).sum()))
           for k, (z, i) in runs.items()}
    bad["dense"] = (int((dense[0] != zs).sum()), int((dense[1] != i_s).sum()))
    err = float((runs["raster"][0] - zp).abs().max())
    covered = int((zp > 0).sum())
    times = binned_times(proj, faces, rays, hw, t, 50)
    dense_ms = time_ms(lambda: raster_kernel.raster_binned_launch(
        t.rows, t.boxes, t.cbox, t.vbox, t.tbox, rays, forced, hw), 50)
    # the function's inputs (face rows, positions) read once, its outputs
    # written once; 16 operations per pixel in a face's bbox
    nbytes = B * F * 13 * 4 + rays.numel() * 4 + B * P * 8
    pairs = raster_pair_count(proj, faces, rays)
    bms, by = bound_ms(nbytes, 16 * pairs)
    say(f"kernel K10 raster_binned B={B} {H}x{W} F={F}: set-up rows bitwise,"
        f" cover, screen and tile boxes, counts and flag equal; zbuf/id "
        f"mismatches {json.dumps(bad)} (raster, route, dense branch), "
        f"covered pixels "
        f"{covered}/{B * P}, overflow {int(overflow)}, faces per tile mean "
        f"{float(counts.float().mean()):.1f} max {int(counts.max())} (cap "
        f"{ras.BIN_CAP}), max_abs_err {err}, kernel {times['ms']:.4f} ms, "
        f"set-up {times['setup_ms']:.4f} ms, route {times['route_ms']:.4f} "
        f"ms (the tables in PyTorch {times['tables_ms']:.4f} ms), plain "
        f"{times['plain_ms']:.4f} ms, bound {bms:.6f} ms by {by} ({pairs} "
        f"pixel-face pairs in bbox, {nbytes} bytes); with the overflow flag "
        f"set (every face, K1's body) {dense_ms:.4f} ms")
    need(sum(sum(v) for v in bad.values()) == 0,
         f"K10 disagrees with its plain version at stride {stride}: {bad}")
    need(covered > 0.02 * B * P, "K10 scene covers too little of the crop")


def check_tail_conv(renderer, B, rng):
    """K9 on the generator's own head input at the training steps' shape:
    the stand-in generator run up to its head on B rendered hands, (B, 64,
    S+6, S+6).  Held within 1e-5 absolute on the tanh output against the
    plain version; the library call is one cuDNN convolution with its bias
    and a tanh, TF32 off, as the plain version computes it.  Most of that
    output saturates, where a wrong sum would not show, so K9 is also held
    on the same input scaled until |pre-tanh| < 0.9: within 1e-5 of the
    plain version, and no further from the float64 convolution than 3x the
    plain version's distance + 1e-7 (K9 sums in another order than cuDNN,
    so it is not bitwise)."""
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.ops import tapsum, tapsum_kernel
    from dsf_tpu_torch.training.trainer import load_transfer_net

    gen = load_transfer_net(STAND_IN, "cuda")
    img = demo.real_batch(renderer, B, rng)["img"]
    head = gen.model[-1]
    x = gen.model[:-1](img).contiguous()
    w, b = head.weight.contiguous(), head.bias.contiguous()
    got = tapsum_kernel.tail_conv_cuda(x, w, b)
    ref = tapsum.tail_conv_tanh_plain(x, w, b)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())

    def f64(xs):
        return torch.tanh(torch.nn.functional.conv2d(xs.double(), w.double())
                          + b.double())

    # the unsaturated input: pre-tanh = s * conv + b within (-0.9, 0.9)
    conv = torch.nn.functional.conv2d(x.double(), w.double())
    scale = (0.9 - float(b.abs())) / float(conv.abs().max())
    need(scale > 0, f"K9's bias {float(b)} leaves no unsaturated input")
    x2 = (x * scale).contiguous()
    got2 = tapsum_kernel.tail_conv_cuda(x2, w, b)
    ref2 = tapsum.tail_conv_tanh_plain(x2, w, b)
    exact2 = f64(x2)
    torch.cuda.synchronize()
    err2 = float((got2 - ref2).abs().max())
    d_kernel = float((got2.double() - exact2).abs().max())
    d_plain = float((ref2.double() - exact2).abs().max())
    pre2 = float((conv * scale + b.double()).abs().max())

    ms = time_ms(lambda: tapsum_kernel.tail_conv_cuda(x, w, b), 50)
    plain_ms = time_ms(lambda: tapsum.tail_conv_tanh_plain(x, w, b), 50)
    lib_ms = time_ms(lambda: torch.tanh(torch.nn.functional.conv2d(x, w, b)),
                     50)
    gen_ms = time_ms(lambda: gen(img), 5, 1)
    _, C, Hp, Wp = x.shape
    H, W = Hp - 6, Wp - 6
    # x, w and b read once, the output written once; a multiply-add per
    # tap and channel, the bias add (tanh not counted)
    nbytes = (x.numel() + w.numel() + 1 + B * H * W) * 4
    bms, by = bound_ms(nbytes, B * H * W * (2 * C * 49 + 1))
    sat = float((ref.abs() > 0.99).float().mean())
    say(f"kernel K9 tail_conv x {tuple(x.shape)} -> {tuple(got.shape)}: "
        f"max_abs_err {err:.3g} (tanh output; {sat:.3f} of it beyond 0.99); "
        f"on the input scaled by {scale:.4g} (|pre-tanh| <= {pre2:.4f}): "
        f"max_abs_err {err2:.3g}, from float64 {d_kernel:.3g} (the plain "
        f"version's {d_plain:.3g}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, cuDNN conv2d + tanh {lib_ms:.4f} ms, bound "
        f"{bms:.6f} ms by {by}; the whole stand-in generator on "
        f"{tuple(img.shape)} {gen_ms:.3f} ms")
    need(err <= 1e-5, f"K9 disagrees with its plain version: {err}")
    need(err2 <= 1e-5, f"K9 disagrees with its plain version on the "
         f"unsaturated input: {err2}")
    need(d_kernel <= 3 * d_plain + 1e-7, f"K9 lies {d_kernel} from float64 "
         f"on the unsaturated input, the plain version {d_plain}")
    return {"name": "tail_conv", "route": "cuda",
            "source": "dsf_tpu_torch/csrc/tail_conv.cu",
            "replaces": "dsf_tpu/ops/pallas_tapsum.py:122",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "unsaturated_max_abs_err": err2, "unsaturated_from_f64": d_kernel,
            "unsaturated_plain_from_f64": d_plain}


def bf16_step(m):
    """The bfloat16 step at magnitude ``m`` (8 significant bits: a step is
    2^(e - 7) for a value in [2^e, 2^(e+1))); 2^-7 at 0."""
    import torch
    e = torch.floor(torch.log2(torch.where(m > 0, m, torch.ones_like(m))))
    return torch.exp2(e - 7)


def bf16_steps(a, b):
    """|a - b| in bfloat16 steps at the larger magnitude."""
    import torch
    a, b = a.double(), b.double()
    return (a - b).abs() / bf16_step(torch.maximum(a.abs(), b.abs()))


def tail_bf16_bound(pre, y64, b, absum, per_rounding=2.0 ** -8):
    """How far K9's bfloat16 output may lie from tanh of the float64 sum of
    the same bfloat16 x, w and b: the float32 sum within 1e-6 of the sum
    of its products' magnitudes ``absum`` (as K9's float32 check), then
    half a step (at most 2^-8 of the value) at each rounding, the sum's
    (at most |pre| + |b|) and the pre-tanh value's, through tanh' = 1 -
    y^2, then the output's; 1e-6 for tanhf.  From another bfloat16 result
    of the same function (``per_rounding`` 2^-7, and 2e-6 of ``absum``): a
    whole step at each rounding, where the two float32 sums round apart.
    Near a sum that cancels, a step of the sum is many steps of the
    output: the bound is in the sum's units there."""
    r = per_rounding
    return ((1 - y64 ** 2) * (r * (2 * pre.abs() + abs(b)) * 1.01
                              + r * 2 ** 8 * 1e-6 * absum)
            + r * y64.abs() * 1.001 + 1e-6)


def check_tail_conv_bf16(renderer, B, rng):
    """K9's bfloat16 variant on the bfloat16 stand-in generator's own head
    input at the training steps' B, (B, 64, S+6, S+6): against its plain
    version on the card (cuDNN's bfloat16 convolution, float32 sums
    rounded once, the bias added in bfloat16, tanh), where each float32
    sum runs in its own order, so a sum may round one bfloat16 step apart:
    held within a step at each rounding (``tail_bf16_bound`` at 2^-7) and
    different on at most 1% of the outputs; and against tanh of the
    float64 sum of the same bfloat16 values, within half a step at each
    rounding (``tail_bf16_bound``), on the generator's input and on it
    scaled until |pre-tanh| < 0.9.  The
    library call is one cuDNN bfloat16 convolution with its bias and a
    tanh."""
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.ops import tapsum, tapsum_kernel
    from dsf_tpu_torch.training.trainer import load_transfer_net

    gen = load_transfer_net(STAND_IN, "cuda", torch.bfloat16)
    img = demo.real_batch(renderer, B, rng)["img"]
    head = gen.model[-1]
    x = gen.model[:-1](img).contiguous()
    w = head.weight.bfloat16().contiguous()
    b = head.bias.bfloat16().contiguous()
    need(x.dtype == torch.bfloat16, f"the bfloat16 generator's head input "
         f"is {x.dtype}")
    def f64(xs):
        return torch.nn.functional.conv2d(xs.double(), w.double()) + b.double()

    conv = torch.nn.functional.conv2d(x.double(), w.double())
    scale = (0.9 - float(b.float().abs())) / float(conv.abs().max())
    need(scale > 0, f"K9's bias {float(b)} leaves no unsaturated input")
    x2 = (x.float() * scale).bfloat16().contiguous()
    rows = {}
    for tag, xs in (("generator", x), ("unsaturated", x2)):
        got = tapsum_kernel.tail_conv_cuda(xs, w, b)
        again = tapsum_kernel.tail_conv_cuda(xs, w, b)
        ref = tapsum.tail_conv_tanh_plain(xs, w, b)
        pre = f64(xs)
        y64 = torch.tanh(pre)
        absum = torch.nn.functional.conv2d(xs.double().abs(),
                                           w.double().abs())
        torch.cuda.synchronize()
        need(got.dtype == torch.bfloat16
             and got.shape == (B, 1, x.shape[2] - 6, x.shape[3] - 6),
             f"K9 bf16 returned {got.dtype} {tuple(got.shape)}")
        st = bf16_steps(got, ref)
        over = (got.double() - y64).abs() - tail_bf16_bound(
            pre, y64, float(b), absum)
        over_plain = (got.double() - ref.double()).abs() - tail_bf16_bound(
            pre, y64, float(b), absum, 2.0 ** -7)
        rows[tag] = dict(
            max_abs_err=float((got.float() - ref.float()).abs().max()),
            steps_max=float(st.max()), steps_share=float((st > 0).float()
                                                         .mean()),
            from_f64=float((got.double() - y64).abs().max()),
            plain_from_f64=float((ref.double() - y64).abs().max()),
            over_bound=float(over.max()),
            over_plain_bound=float(over_plain.max()), bitwise_twice=bool(
                torch.equal(got, again)),
            pre_max=float(pre.abs().max()))
    ms = time_ms(lambda: tapsum_kernel.tail_conv_cuda(x, w, b), 50)
    plain_ms = time_ms(lambda: tapsum.tail_conv_tanh_plain(x, w, b), 50)
    lib_ms = time_ms(lambda: torch.tanh(torch.nn.functional.conv2d(x, w, b)),
                     50)
    xf, wf, bf = x.float(), w.float(), b.float()
    f32_ms = time_ms(lambda: tapsum_kernel.tail_conv_cuda(xf, wf, bf), 50)
    gen_ms = time_ms(lambda: gen(img), 5, 1)
    _, C, Hp, Wp = x.shape
    H, W = Hp - 6, Wp - 6
    # x, w and b read once (2 bytes each), the output written once; a
    # multiply-add per tap and channel on bfloat16 operands, at the card's
    # bfloat16 rate (the tensor cores'), and the bias add (tanh not counted)
    nbytes = (x.numel() + w.numel() + 1 + B * H * W) * 2
    bms, by = bound_ms(nbytes, B * H * W * (2 * C * 49 + 1), "bfloat16")
    r = rows["generator"]
    say(f"kernel K9 tail_conv_bf16 x {tuple(x.shape)} bfloat16: "
        + json.dumps({k: {n: float(f"{v:.4g}") if isinstance(v, float) else v
                          for n, v in row.items()}
                      for k, row in rows.items()})
        + f"; kernel {ms:.4f} ms (the float32 K9 on the same values "
        f"{f32_ms:.4f} ms), plain {plain_ms:.4f} ms, cuDNN bfloat16 conv2d + "
        f"tanh {lib_ms:.4f} ms, bound {bms:.6f} ms by {by}; the whole "
        f"bfloat16 stand-in generator on {tuple(img.shape)} {gen_ms:.3f} ms")
    for tag, row in rows.items():
        need(row["over_plain_bound"] <= 0 and row["steps_share"] <= 0.01,
             f"K9 bf16 disagrees with its plain version on the {tag} input: "
             f"{row}")
        need(row["over_bound"] <= 0, f"K9 bf16 lies beyond the rounding "
             f"bound from float64 on the {tag} input: {row}")
        need(row["bitwise_twice"], f"K9 bf16 differs between two runs on the "
             f"{tag} input")
    return {"name": "tail_conv_bf16", "route": "cuda",
            "source": "dsf_tpu_torch/csrc/tail_conv.cu",
            "replaces": "dsf_tpu/ops/pallas_tapsum.py:122",
            "max_abs_err": r["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "float32_kernel_ms": f32_ms,
            "steps_share_vs_plain": r["steps_share"],
            "from_f64": r["from_f64"], "plain_from_f64": r["plain_from_f64"],
            "unsaturated_max_abs_err": rows["unsaturated"]["max_abs_err"],
            "unsaturated_from_f64": rows["unsaturated"]["from_f64"]}


# ----------------------------------------------------------------- phase 3

def atol_for(key):
    """Stage 1 differs by convolution summation order only: 1e-2 mm, 1e-4
    for unitless keys.  Stage 2 re-renders the stage-1 MANO, and the
    raster is discontinuous at the silhouette: a 1e-6 relative change of
    the stage-1 parameters flips one or two silhouette pixels and moves
    the stage-2 joints by ~0.06 mm (measured on the CPU at this width), and
    cuDNN's and the CPU's float32 convolutions differ by a few times that.
    So stage 2 is held to 0.5 mm and 5e-3 for unitless keys, and the
    silhouette flips are counted and printed."""
    stage1 = key.endswith("_0")
    if "mm" in key:
        return 1e-2 if stage1 else 0.5
    return 1e-4 if stage1 else 5e-3


def binned_serving_record(kept):
    """K10 on each binned serving call's own inputs, as the path gave them
    (``kept``: proj, positions, faces, layout and the route's zbuf and
    ids): the route's output against ``raster_binned_plain`` over
    ``binned_tables`` on the same inputs (zbuf bitwise, ids equal) and the
    set-up against its plain version (after the path's counts are read:
    these launches are checks, not the path's); its record timed and
    bounded on the largest call's."""
    import torch

    err, flags = 0.0, 0
    for proj, pix_uv, faces, hw, (zk, ik) in kept:
        with torch.inference_mode():
            check_binned_setup(proj, faces, pix_uv, hw)
            (zp, ip), (_, cnt, flag) = binned_plain(proj, faces, pix_uv, hw)
        z_bad, i_bad = int((zk != zp).sum()), int((ik != ip).sum())
        err = max(err, float((zk - zp).abs().max()))
        flags += int(flag)
        say(f"slice binned call B={proj.shape[0]} {hw[0]}x{hw[1]}: the K10 "
            f"route's output against its plain version on the call's "
            f"inputs: zbuf mismatches {z_bad}, id mismatches {i_bad}, "
            f"overflow {int(flag)}, faces per tile max {int(cnt.max())}; "
            f"set-up equal")
        need(z_bad == 0 and i_bad == 0, "K10 disagrees with its plain "
             "version on a serving call's inputs")
    proj, pix_uv, faces, hw, _ = max(kept, key=lambda k: k[0].shape[0])
    B, F = proj.shape[0], faces.shape[0]
    P = hw[0] * hw[1]
    with torch.inference_mode():
        from dsf_tpu_torch.ops import raster_kernel
        tables = raster_kernel.binned_setup_cuda(proj, faces, pix_uv, hw)
        times = binned_times(proj, faces, pix_uv, hw, tables, 50)
        pairs = raster_pair_count(proj, faces, pix_uv)
    # the function's inputs (face rows, positions) read once, its outputs
    # written once; 16 operations per pixel in a face's bbox
    nbytes = B * F * 13 * 4 + B * P * 2 * 4 + B * P * 8
    bms, by = bound_ms(nbytes, 16 * pairs)
    say(f"kernel K10 raster_binned on the serving path's B={B} {hw[0]}x"
        f"{hw[1]} stage-2 render (overflow {int(tables.overflow)}; calls "
        f"that overflowed {flags} of {len(kept)}): kernel {times['ms']:.4f} "
        f"ms, set-up {times['setup_ms']:.4f} ms, route "
        f"{times['route_ms']:.4f} ms (the tables in PyTorch "
        f"{times['tables_ms']:.4f} ms), plain {times['plain_ms']:.4f} ms, "
        f"bound {bms:.6f} ms by {by} ({pairs} pixel-face pairs in bbox, "
        f"{nbytes} bytes)")
    return {"name": "raster_binned", "route": "cuda",
            "source": "dsf_tpu_torch/csrc/raster_binned.cu",
            "replaces": "dsf_tpu/ops/pallas_raster.py:85",
            "max_abs_err": err, "ms": times["ms"],
            "plain_ms": times["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": None, "setup_ms": times["setup_ms"],
            "route_ms": times["route_ms"]}


def run_slice(mano_path):
    """Serving through the skip raster (K1), then through the binned one
    (K10); returns both paths' launch counts, K10's record, from its
    inputs on the binned path (``binned_serving_record``), and the requests
    with the card's and the CPU's float32 outputs (for the bfloat16
    engine's comparison)."""
    import torch
    from dsf_tpu_torch import demo, kernels
    from dsf_tpu_torch.ops import rasterize as ras
    from dsf_tpu_torch.render import renderer as rnd

    eng = demo.engine(mano_path, "cuda", INPUT_SIZE, BUCKETS, SEED)
    cpu = demo.engine(mano_path, "cpu", INPUT_SIZE, BUCKETS, SEED)
    rng = np.random.RandomState(SEED + 1)
    sizes = REQUEST_SIZES
    reqs = [demo.requests(eng.renderer, n, rng) for n in sizes]
    eng.warmup()
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    outs = [eng.predict(*r) for r in reqs]
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    bucket_calls = sum(-(-n // BUCKETS[-1]) for n in sizes)
    say(f"slice launches over requests {sizes} ({bucket_calls} bucket "
        f"calls): {json.dumps(counts)}")
    # inference: no backward, so the training path's kernels stay at 0
    need(counts == launches(raster_skip=bucket_calls,
                            codec_encode=bucket_calls,
                            codec_decode=2 * bucket_calls),
         f"predict did not go through every kernel once per call: {counts}")

    for n, out in zip(sizes, outs):
        for k, v in out.items():
            need(v.shape[0] == n and np.isfinite(v).all(),
                 f"request {n}: {k} not finite or wrong shape {v.shape}")
    # the stage-2 input render of the largest request
    r = reqs[-1]
    with torch.inference_mode():
        img2, _, _, _ = rnd.render_params(
            eng.renderer, torch.from_numpy(outs[-1]["mano_para_0"]).cuda(),
            torch.from_numpy(r[1]).cuda(), torch.from_numpy(r[3]).cuda(),
            img_stride=2)
    cover = float((img2 < FG).float().mean())
    say(f"slice stage-2 render coverage {cover:.4f} of {tuple(img2.shape)}")
    need(cover > 0.02, f"stage-2 render covers {cover} <= 2% of its pixels")

    worst, refs = {}, []
    for n, r, out in zip(sizes, reqs, outs):
        ref = cpu.predict(*r)
        refs.append(ref)
        img2_cpu, _, _, _ = rnd.render_params(
            cpu.renderer, torch.from_numpy(ref["mano_para_0"]),
            torch.from_numpy(r[1]), torch.from_numpy(r[3]), img_stride=2)
        img2_gpu, _, _, _ = rnd.render_params(
            eng.renderer, torch.from_numpy(out["mano_para_0"]).cuda(),
            torch.from_numpy(r[1]).cuda(), torch.from_numpy(r[3]).cuda(),
            img_stride=2)
        flips = int(((img2_gpu.cpu() < FG) != (img2_cpu < FG)).sum())
        say(f"slice request {n}: stage-2 render silhouette pixels that differ "
            f"between the GPU and CPU engines: {flips} of {img2_cpu.numel()}")
        for k in out:
            d = float(np.abs(out[k] - ref[k]).max())
            worst[k] = max(worst.get(k, 0.0), d)
            need(d <= atol_for(k), f"request {n}: {k} differs from the CPU "
                 f"engine by {d} > {atol_for(k)}")
    say("slice GPU vs CPU engine max abs diff: "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))

    # the binned route: the same requests with the skip raster off; each
    # route call's inputs and output are kept (proj, positions, faces,
    # layout, (zbuf, idx))
    skip, route = ras.USE_PALLAS_SKIP, ras.binned_forward
    kept = []

    def kept_route(proj, pix_uv, faces, tile_hw):
        out = route(proj, pix_uv, faces, tile_hw)
        kept.append((proj, pix_uv, faces, tile_hw, out))
        return out

    ras.USE_PALLAS_SKIP, ras.binned_forward = False, kept_route
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        outs_b = [eng.predict(*r) for r in reqs]
        torch.cuda.synchronize()
        binned = dict(kernels.LAUNCHES)
    finally:
        ras.USE_PALLAS_SKIP, ras.binned_forward = skip, route
    say(f"slice launches with rasterize.USE_PALLAS_SKIP off: "
        f"{json.dumps(binned)}; binned route calls {len(kept)}")
    k10 = binned_serving_record(kept)
    need(binned == launches(raster_binned=bucket_calls,
                            codec_encode=bucket_calls,
                            codec_decode=2 * bucket_calls),
         f"predict without the skip raster did not launch K10 in K1's "
         f"place once per call: {binned}")
    diff = {}
    for n, out, out_b in zip(sizes, outs, outs_b):
        for k in out:
            d = float(np.abs(out_b[k] - out[k]).max())
            diff[k] = max(diff.get(k, 0.0), d)
            need(d <= atol_for(k), f"request {n}: {k} of the binned route "
                 f"differs from the skip route's by {d} > {atol_for(k)}")
    say("slice binned vs skip route max abs diff: "
        + json.dumps({k: float(f"{v:.3g}") for k, v in diff.items()}))

    check_raw_frame(eng, cpu, rng)
    lat = predict_latency(eng, rng)
    top = BUCKETS[-1]
    say(f"slice median predict latency ms per bucket ({LATENCY_CALLS} calls, "
        "host clock, to numpy): " + json.dumps(lat)
        + f"; bucket {top} throughput {top * 1e3 / lat[top]:.1f} images/s")
    say(f"slice peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return counts, binned, k10, {"reqs": reqs, "gpu": outs, "cpu": refs}


def check_raw_frame(eng, cpu, rng):
    """``predict_from_depth`` on one raw 640x480 frame (a seeded hand
    rendered on the card, K6 outside any counted path): the centre of mass
    and the host crop, then the engine; outputs finite and within
    ``atol_for`` of the CPU engine's on the same frame."""
    import torch
    from dsf_tpu_torch.mano import model as mano
    from dsf_tpu_torch.ops import rasterize as ras
    r = eng.renderer
    with torch.inference_mode():
        p = torch.from_numpy(prerender_params(1, rng)).cuda()
        verts, _ = mano.get_mano_vertices(r.mano, *mano.split_params(p))
        frame = ras.rasterize_depth(
            verts, r.mano.faces, ras.full_frame_pixel_rays((640, 480), "cuda"),
            r.paras).reshape(480, 640).cpu().numpy().astype(np.uint16)
    out, ref = eng.predict_from_depth(frame), cpu.predict_from_depth(frame)
    worst = {}
    for k, v in out.items():
        d = float(np.abs(v - ref[k]).max())
        worst[k] = d
        need(np.isfinite(v).all() and d <= atol_for(k), f"predict_from_depth: "
             f"{k} not finite or {d} > {atol_for(k)} from the CPU engine")
    say(f"slice predict_from_depth on a {frame.shape} frame "
        f"({int((frame > 0).sum())} hand pixels): joint_xyz_mm "
        f"{np.round(out['joint_xyz_mm'][0, 0], 2).tolist()} ...; GPU vs CPU "
        "max abs diff " + json.dumps({k: float(f"{v:.3g}")
                                      for k, v in worst.items()}))


def predict_latency(eng, rng, calls=LATENCY_CALLS):
    """The median host-clock latency of ``eng.predict`` per bucket, to
    numpy, over ``calls`` calls after 3 warm ones."""
    from dsf_tpu_torch import demo
    lat = {}
    for b in BUCKETS:
        r = demo.requests(eng.renderer, b, rng)
        for _ in range(3):
            eng.predict(*r)
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            eng.predict(*r)
            times.append((time.perf_counter() - t0) * 1e3)
        lat[b] = float(np.median(times))
    return lat


# the bfloat16 engine's outputs may lie from the float32 ones this many
# times further than the CPU's bfloat16 engine lies from the CPU's float32
# one (the witness of what bfloat16 rounding alone moves), plus atol_for
BF16_SERVE_RATIO = 3.0


def run_slice_bf16(mano_path, f32):
    """The bfloat16 engine (``Config(compute_dtype="bfloat16")``) on the
    card at full width, on phase 3's requests: every kernel of the path
    once a bucket call (the same as float32: the net is bfloat16, the
    stage-2 render, the codec and LBS float32), outputs finite, the
    stage-2 render of its bfloat16 MANO parameters covering > 2% of its
    pixels.  Its outputs against the CPU's bfloat16 engine and the card's
    float32 engine, each within BF16_SERVE_RATIO times the distance from
    the CPU's bfloat16 engine to the CPU's float32 one on the same
    requests, plus atol_for.  The cuBLAS question:
    the stage-1 MANO head (a bfloat16 GEMM, 512 -> 62) on its own input
    with cuBLAS's reduced-precision bfloat16 reduction allowed and not,
    against the CPU, in bfloat16 steps.  Then the median latency per
    bucket.  Returns the launch counts."""
    import copy
    import torch
    from dsf_tpu_torch import demo, kernels
    from dsf_tpu_torch.render import renderer as rnd

    eng = demo.engine(mano_path, "cuda", INPUT_SIZE, BUCKETS, SEED,
                      compute_dtype="bfloat16")
    cpu = demo.engine(mano_path, "cpu", INPUT_SIZE, BUCKETS, SEED,
                      compute_dtype="bfloat16")
    reqs, sizes = f32["reqs"], REQUEST_SIZES
    eng.warmup()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = [eng.predict(*r) for r in reqs]
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    bucket_calls = sum(-(-n // BUCKETS[-1]) for n in sizes)
    say(f"slice_bf16 launches over requests {sizes} ({bucket_calls} bucket "
        f"calls): {json.dumps(counts)}")
    need(counts == launches(raster_skip=bucket_calls,
                            codec_encode=bucket_calls,
                            codec_decode=2 * bucket_calls),
         f"the bfloat16 predict did not go through every kernel once per "
         f"call: {counts}")
    for n, out in zip(sizes, outs):
        for k, v in out.items():
            need(v.shape[0] == n and v.dtype == np.float32
                 and np.isfinite(v).all(), f"bf16 request {n}: {k} not "
                 f"finite float32 or wrong shape {v.shape} {v.dtype}")
    r = reqs[-1]
    with torch.inference_mode():
        img2, _, _, _ = rnd.render_params(
            eng.renderer, torch.from_numpy(outs[-1]["mano_para_0"]).cuda(),
            torch.from_numpy(r[1]).cuda(), torch.from_numpy(r[3]).cuda(),
            img_stride=2)
    cover = float((img2 < FG).float().mean())
    say(f"slice_bf16 stage-2 render coverage {cover:.4f} of "
        f"{tuple(img2.shape)}")
    need(cover > 0.02, f"bf16 stage-2 render covers {cover} <= 2%")

    # the witness: the CPU's bfloat16 engine against the CPU's float32 one
    witness, gpu_cpu, gpu_f32 = {}, {}, {}
    for i, (r, out) in enumerate(zip(reqs, outs)):
        ref = cpu.predict(*r)
        for k in out:
            for into, a, b in ((witness, ref, f32["cpu"][i]),
                               (gpu_cpu, out, ref), (gpu_f32, out,
                                                      f32["gpu"][i])):
                into[k] = max(into.get(k, 0.0),
                              float(np.abs(a[k] - b[k]).max()))
    def fmt(d):
        return json.dumps({k: float(f"{v:.4g}") for k, v in d.items()})

    say(f"slice_bf16 max abs diff, CPU bf16 vs CPU f32 (the witness): "
        f"{fmt(witness)}")
    say(f"slice_bf16 max abs diff, GPU bf16 vs CPU bf16: {fmt(gpu_cpu)}")
    say(f"slice_bf16 max abs diff, GPU bf16 vs GPU f32: {fmt(gpu_f32)}")
    for k in witness:
        tol = BF16_SERVE_RATIO * witness[k] + atol_for(k)
        need(gpu_cpu[k] <= tol, f"bf16 {k}: the card's engine differs from "
             f"the CPU's by {gpu_cpu[k]} > {tol}")
        need(gpu_f32[k] <= tol, f"bf16 {k}: the card's bf16 engine differs "
             f"from its f32 one by {gpu_f32[k]} > {tol}")
        # ... and it does compute in bfloat16: it moves away from the
        # float32 engine as the CPU's bfloat16 engine does (0.82x to 1.2x
        # the witness measured), not by float32 rounding alone
        need(gpu_f32[k] >= witness[k] / BF16_SERVE_RATIO, f"bf16 {k}: the "
             f"card's bf16 engine lies only {gpu_f32[k]} from its f32 one, "
             f"against the CPU's {witness[k]}: it does not round as bf16")

    # the stage-1 MANO head's GEMM with and without cuBLAS's reduced-
    # precision bfloat16 reduction, against the CPU
    head = eng.net.mano_regress
    feats = []
    hook = head[2].register_forward_hook(
        lambda m, inputs, o: feats.append((inputs[0], o)))
    eng.predict(*reqs[-1])
    hook.remove()
    x, o = feats[0]
    need(x.dtype == o.dtype == torch.bfloat16, f"the bf16 engine's MANO head "
         f"takes {x.dtype} and returns {o.dtype}")
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    outs_flag = {}
    with torch.inference_mode():
        for allowed in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
                allowed)
            outs_flag[allowed] = head[2](x).cpu()
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
        ref = copy.deepcopy(head[2]).cpu()(x.cpu())
    for allowed, o in outs_flag.items():
        st = bf16_steps(o, ref)
        say(f"slice_bf16 mano_regress GEMM {tuple(x.shape)} x (512, 62) with "
            f"allow_bf16_reduced_precision_reduction={allowed}: against the "
            f"CPU, {float((st > 0).float().mean()):.4f} of the outputs differ, "
            f"by at most {float(st.max()):.3g} bfloat16 steps")

    lat = predict_latency(eng, np.random.RandomState(SEED + 30))
    top = BUCKETS[-1]
    say(f"slice_bf16 median predict latency ms per bucket ({LATENCY_CALLS} "
        "calls, host clock, to numpy): " + json.dumps(lat)
        + f"; bucket {top} throughput {top * 1e3 / lat[top]:.1f} images/s")
    return counts


# ----------------------------------------------------------------- phase 4

def train_config(mano_path, stage_num, seed, dtype="float32",
                 net="ResNet_stage_18"):
    """The training phases' full-width config, with the stand-in
    generator, in the compute dtype ``dtype``, with the trunks of
    ``net``."""
    from dsf_tpu_torch.config import Config
    return Config(dataset="nyu", batch_size=TRAIN_BATCH, stage_num=stage_num,
                  input_size=INPUT_SIZE, seed=seed, mano_model_path=mano_path,
                  transferNet_pth=STAND_IN, compute_dtype=dtype, net=net)


def net_tag(net):
    """"" for ResNet-18 (the earlier phases' tags), else "_r<depth>"."""
    depth = net.split("_")[-1]
    return "" if depth == "18" else f"_r{depth}"


def run_training(mano_path, dtype="float32", net="ResNet_stage_18"):
    """TRAIN_STEPS Pretrain steps at full width in the compute dtype
    ``dtype`` with the trunks of ``net``; returns the launch counts."""
    import torch
    from dsf_tpu_torch import kernels
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.training.trainer import Trainer

    tag = ("train" if dtype == "float32" else "train_bf16") + net_tag(net)
    expected = (STEP_LAUNCHES if dtype == "float32"
                else bf16_launches(STEP_LAUNCHES))
    tr = Trainer(train_config(mano_path, 2, SEED, dtype, net), mano_path,
                 device="cuda")
    need(tr.transfer_net is not None, "no transfer net")
    say(f"{tag}: transferNet_pth {STAND_IN!r} names no file: the trainer "
        "runs its seeded stand-in generator (ngf 64, 9 blocks) on every "
        f"synth batch; compute dtype {dtype}")
    state = tr.init_state()
    src = random_param_source(TRAIN_BATCH, seed=SEED)
    batches = [dict(zip(("model_para", "cube_synth"), next(src)))
               for _ in range(TRAIN_STEPS)]
    draws = [tr.draw(TRAIN_BATCH) for _ in range(TRAIN_STEPS)]
    step = tr.train_step_fn("Pretrain")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        state, metrics = step(state, draws[i], batches[i])
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        delta = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        need(delta == expected,
             f"{tag} step {i} did not launch every kernel of the path as "
             f"expected: {delta} != {expected}")
        need(np.isfinite(losses[-1]), f"{tag} step {i}: loss {losses[-1]}")
    counts = dict(kernels.LAUNCHES)
    say(f"{tag} launches over {TRAIN_STEPS} Pretrain steps (B={TRAIN_BATCH}, "
        f"{INPUT_SIZE}^2): {json.dumps(counts)}")
    say(f"{tag} losses: " + json.dumps([float(f"{x:.6g}") for x in losses])
        + f"; updates applied {int(state.updates)}/{TRAIN_STEPS}")
    say(f"{tag} step ms (host clock, to a synchronized loss): "
        + json.dumps([round(t, 3) for t in times])
        + f"; median {float(np.median(times)):.3f} ms, "
        f"{TRAIN_BATCH * 1e3 / float(np.median(times)):.1f} images/s")
    STEP_MEDIAN_MS[tag] = float(np.median(times))
    say(f"{tag} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return counts


ICP_SWITCHES = {None: ("point_mesh_argmin", {}),
                "v2": ("icp_argmin_v2", {"USE_V2_KERNEL": True}),
                "culled": ("icp_argmin_culled", {"USE_CULLED_KERNEL": True})}


@contextlib.contextmanager
def icp_switch(icp):
    """``point_mesh``'s switches set for the ICP variant ``icp`` (None: K3,
    "v2": K7, "culled": K8), restored after."""
    from dsf_tpu_torch.ops import point_mesh as pm
    saved = {k: getattr(pm, k) for k in ("USE_V2_KERNEL", "USE_CULLED_KERNEL")}
    for k in saved:
        setattr(pm, k, ICP_SWITCHES[icp][1].get(k, False))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(pm, k, v)


def run_self_supervised(mano_path, phase, icp=None, dtype="float32",
                        net="ResNet_stage_18"):
    """TRAIN_STEPS Finetune (one stage) or FinetuneStage (two stages) steps
    at full width in the compute dtype ``dtype`` with the trunks of
    ``net``, the ICP's argmin by ``icp`` (``icp_switch``); returns the
    launch counts."""
    with icp_switch(icp):
        return _run_self_supervised(mano_path, phase, icp, dtype, net)


def _run_self_supervised(mano_path, phase, icp, dtype, net):
    import torch
    from dsf_tpu_torch import demo, kernels
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.training.trainer import Trainer

    stages = 1 if phase == "Finetune" else 2
    expected = dict(F_STEP_LAUNCHES if stages == 1 else FS_STEP_LAUNCHES)
    expected[ICP_SWITCHES[icp][0]] = expected.pop("point_mesh_argmin")
    expected = launches(**expected)
    tag = phase.lower() if stages == 1 else "finetune_stage"
    if icp:
        tag += "_" + icp
    if dtype != "float32":
        expected = bf16_launches(expected)
        tag += "_bf16"
    tag += net_tag(net)
    tr = Trainer(train_config(mano_path, stages, SEED, dtype, net), mano_path,
                 device="cuda")
    state = tr.init_state()
    src = random_param_source(TRAIN_BATCH, seed=SEED + 5)
    rng = np.random.RandomState(SEED + 6)
    batches = [dict(zip(("model_para", "cube_synth"), next(src)),
                    **demo.real_batch(tr.renderer, TRAIN_BATCH, rng))
               for _ in range(TRAIN_STEPS)]
    draws = [tr.draw(TRAIN_BATCH, phase) for _ in range(TRAIN_STEPS)]
    step = tr.train_step_fn(phase)
    before_params = [p.detach().clone() for p in state.net.parameters()]
    gen_before = [p.detach().clone() for p in tr.transfer_net.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    times, losses, metrics = [], [], []
    for i in range(TRAIN_STEPS):
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        state, m = step(state, draws[i], batches[i])
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        delta = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        need(delta == expected,
             f"{phase} step {i} did not launch every kernel of the path "
             f"as expected: {delta} != {expected}")
        need(all(np.isfinite(v) for v in metrics[-1].values()),
             f"{phase} step {i}: non-finite metrics {metrics[-1]}")
    counts = dict(kernels.LAUNCHES)
    moved = sum(int(not torch.equal(a, b.detach()))
                for a, b in zip(before_params, state.net.parameters()))
    gen_moved = sum(int(not torch.equal(a, b))
                    for a, b in zip(gen_before, tr.transfer_net.parameters()))
    med = float(np.median(times))
    STEP_MEDIAN_MS[tag] = med
    say(f"{tag} launches over {TRAIN_STEPS} {phase} steps "
        f"(B={TRAIN_BATCH} synth + {TRAIN_BATCH} real, {INPUT_SIZE}^2, "
        f"stand-in generator, ICP argmin {ICP_SWITCHES[icp][0]}, compute "
        f"dtype {dtype}, {net}): "
        f"{json.dumps(counts)}")
    say(f"{tag} losses: "
        + json.dumps([float(f"{x:.6g}") for x in losses])
        + f"; updates applied {int(state.updates)}/{TRAIN_STEPS}; parameter "
        f"tensors moved {moved} of {len(before_params)}; generator tensors "
        f"moved {gen_moved}")
    say(f"{tag} first step metrics: "
        + json.dumps({k: float(f"{v:.5g}") for k, v in metrics[0].items()}))
    say(f"{tag} step ms (host clock, to a synchronized loss): "
        + json.dumps([round(t, 3) for t in times])
        + f"; median {med:.3f} ms, {2 * TRAIN_BATCH * 1e3 / med:.1f} images/s "
        f"(B synth + B real images a step)")
    PEAK_BYTES[tag] = torch.cuda.max_memory_allocated()
    say(f"{tag} peak device memory {PEAK_BYTES[tag] / 2**20:.1f} MiB")
    need(state.updates == TRAIN_STEPS and moved >= 0.95 * len(before_params),
         f"{phase} updates were not applied")
    need(gen_moved == 0, f"{phase} moved the frozen generator")
    return counts


def run_prerender(mano_path):
    """The offline pre-render of PRERENDER_N seeded parameter sets at NYU's
    640x480 in batches of PRERENDER_BATCH: K6 once a batch and no other
    kernel; every PNG read back (tools.prerender.read_png16) with its hand
    at 400-800 mm (the foreground median, as tests/test_prerender.py
    checks the JAX tool); the first two frames against the same tool on
    the CPU (the plain raster): at most 1e-3 of their pixels differ, 1e-4
    by more than 1 mm (truncation of float32 depths that the two devices
    round apart, and silhouette flips).  Returns the launch counts."""
    import torch
    from dsf_tpu_torch import kernels
    from dsf_tpu_torch.tools import prerender as pre

    params = prerender_params(PRERENDER_N, np.random.RandomState(SEED + 20))
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        n = pre.prerender_dataset(mano_path, params, os.path.join(out, "gpu"),
                                  batch_size=PRERENDER_BATCH)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        batches = -(-PRERENDER_N // PRERENDER_BATCH)
        say(f"prerender launches over {n} frames of 640x480 in batches of "
            f"{PRERENDER_BATCH}: {json.dumps(counts)}; {secs:.3f} s "
            f"({n / secs:.1f} frames/s, PNG writing included)")
        need(n == PRERENDER_N and counts == launches(raster_dense=batches),
             f"the pre-render did not launch K6 once a batch: {counts}")
        names = sorted(os.listdir(os.path.join(out, "gpu")))
        need(names == [f"render_{i:07d}.png" for i in range(1, n + 1)],
             f"the pre-render wrote {names[:3]}...")
        imgs = [pre.read_png16(os.path.join(out, "gpu", f)) for f in names]
        med = [float(np.median(im[im > 0])) if (im > 0).sum() > 500 else 0.0
               for im in imgs]
        say(f"prerender foreground median mm: min {min(med):.1f} max "
            f"{max(med):.1f}; foreground pixels per frame min "
            f"{min(int((im > 0).sum()) for im in imgs)}")
        need(all(400 < m < 800 for m in med), f"a pre-rendered hand lies "
             f"outside 400-800 mm or covers under 500 pixels: {med}")
        pre.prerender_dataset(mano_path, params[:2], os.path.join(out, "cpu"),
                              batch_size=2, device="cpu")
        for i, f in enumerate(names[:2]):
            a = imgs[i].astype(np.int64)
            b = pre.read_png16(os.path.join(out, "cpu", f)).astype(np.int64)
            differ, far = float((a != b).mean()), float((np.abs(a - b) > 1).mean())
            say(f"prerender frame {i + 1} GPU vs CPU: {int((a != b).sum())} "
                f"pixels differ, {int((np.abs(a - b) > 1).sum())} by more "
                f"than 1 mm, of {a.size}")
            need(differ <= 1e-3 and far <= 1e-4, f"pre-rendered frame {i + 1} "
                 f"differs from the CPU's: {differ}, {far}")
    return counts


# ----------------------------------------------------------------- phase 5

def grad_tol(name):
    """The MANO heads and the stage-2 offset head feed the losses only, so
    their gradients are well-conditioned: 1e-2 relative L2.  Every other
    layer's gradient passes through BatchNorm trunks, where at random
    weights it is ill-conditioned.  This phase's float64 witness shows it
    (H100 80GB HBM3 at 700 W, B=4, 128^2): the CPU's float32 gradients lie
    up to 0.101 (median 0.060) from the float64 ones, the GPU's up to
    0.152 (median 0.111), and the two float32 runs up to 0.125 from each
    other.  So 0.2, against the CPU's float32 and against float64."""
    return 1e-2 if name.startswith(("mano_regress", "finals_s2")) else 0.2


# the GPU's float32 gradients may lie at most this many times further from
# float64, in the median over parameters, than the CPU's (1.86 measured,
# as in grad_tol): a fault on the card would move them all
MEDIAN_RATIO = 3.0


def float64_renderer(r):
    """``r`` with its MANO constants in float64 (the faces stay int64)."""
    import torch
    m = r.mano
    f64 = {f.name: getattr(m, f.name).double() for f in dataclasses.fields(m)
           if torch.is_tensor(getattr(m, f.name))
           and getattr(m, f.name).is_floating_point()}
    return dataclasses.replace(r, mano=dataclasses.replace(m, **f64))


def rel_l2(a, b):
    return {n: float((a[n].double() - b[n]).norm() / (b[n].norm() + 1e-30))
            for n in b}


def spread(errs):
    v = np.array(list(errs.values()))
    top = max(errs, key=errs.get)
    return f"median {float(np.median(v)):.3g}, max {v.max():.3g} ({top})"


def bf16_copy(net):
    """A copy of ``net`` computing in bfloat16 (its parameters and
    statistics as they are, float32)."""
    import copy
    import torch
    from dsf_tpu_torch.models.layers import set_compute_dtype
    out = copy.deepcopy(net)
    set_compute_dtype(out, torch.bfloat16)
    return out


def cosines(a, b):
    return {n: float((a[n].double().flatten() @ b[n].flatten())
                     / (a[n].double().norm() * b[n].norm() + 1e-300))
            for n in b}


# the bfloat16 runs of phase 5, against phase 5's float64 witness: the
# card's gradient may lie BF16_RATIO times further from float64 than the
# CPU's bfloat16 gradient, + 0.05, per parameter, and 1.5x + 0.01 in the
# median over the heads and over the trunks; its median cosine with
# float64 at least half the CPU's.  Behind the BatchNorm trunks bfloat16
# rounding dominates the gradient at random weights (tests/
# test_torch_bf16_pretrain.py: a relative L2 near 1 from float64 on both
# the port and the JAX package, cosines near 0.5), so the cosine holds the
# signal there.  The loss within 3x the CPU's bfloat16 distance from
# float64 + 5e-3 of it (0.4% measured on the CPU test's step).  Per
# parameter, too, the card's gradient keeps float64's direction (a
# positive cosine) and a norm within BF16_NORM_RATIO either way of the
# CPU's bfloat16 gradient's: a relative L2 near 1 cannot tell a zeroed
# or halved gradient from bfloat16 noise, these can (the CPU's bfloat16
# Pretrain gradients at B=4, 128^2: cosines with float64 0.27 to 1,
# norms 0.80 to 1.33 of float64's)
BF16_RATIO = 2.0
BF16_NORM_RATIO = 2.0


def check_bf16_runs(label, loss, grads):
    """Phase 5's bfloat16 runs ("gpu_bf16", "cpu_bf16") against the float64
    witness ("cpu64"), as BF16_RATIO says."""
    heads = ("mano_regress", "finals")
    gpu_64 = rel_l2(grads["gpu_bf16"], grads["cpu64"])
    cpu_64 = rel_l2(grads["cpu_bf16"], grads["cpu64"])
    gpu_cos = cosines(grads["gpu_bf16"], grads["cpu64"])
    cpu_cos = cosines(grads["cpu_bf16"], grads["cpu64"])
    say(f"compare {label} bfloat16: loss GPU {loss['gpu_bf16']:.7g} CPU "
        f"{loss['cpu_bf16']:.7g} (float64 {loss['cpu64']:.10g}); gradient "
        f"relative L2 from float64: GPU {spread(gpu_64)}; CPU "
        f"{spread(cpu_64)}; GPU vs CPU "
        f"{spread(rel_l2(grads['gpu_bf16'], grads['cpu_bf16']))}")
    l64 = loss["cpu64"]
    tol = 3 * abs(loss["cpu_bf16"] - l64) + 5e-3 * abs(l64)
    need(abs(loss["gpu_bf16"] - l64) <= tol, f"{label} bf16 GPU loss "
         f"{loss['gpu_bf16']} lies beyond {tol:.3g} of float64's {l64}")
    bad = {k: (v, cpu_64[k]) for k, v in gpu_64.items()
           if not v <= BF16_RATIO * cpu_64[k] + 0.05}
    need(not bad, f"{label} bf16 GPU gradients lie further from float64 "
         f"than the CPU's allow: {bad}")
    norm = {k: float(grads["gpu_bf16"][k].double().norm()
                     / grads["cpu_bf16"][k].double().norm())
            for k in gpu_64}
    say(f"compare {label} bfloat16 per parameter: cosine with float64 GPU "
        f"min {min(gpu_cos.values()):.4g} CPU min {min(cpu_cos.values()):.4g}; "
        f"GPU norm over CPU norm {min(norm.values()):.4g} to "
        f"{max(norm.values()):.4g}")
    bad = {k: (gpu_cos[k], v) for k, v in norm.items()
           if not (gpu_cos[k] > 0 and 1 / BF16_NORM_RATIO <= v
                   <= BF16_NORM_RATIO)}
    need(not bad, f"{label} bf16 GPU gradients lose float64's direction or "
         f"the CPU's norm (cosine, norm over the CPU's): {bad}")
    for part in ("heads", "trunks"):
        names = [n for n in gpu_64 if n.startswith(heads) == (part == "heads")]
        mg, mc, cg, cc = (float(np.median([d[n] for n in names]))
                          for d in (gpu_64, cpu_64, gpu_cos, cpu_cos))
        say(f"compare {label} bfloat16 {part}: median relative L2 from "
            f"float64 GPU {mg:.4g} CPU {mc:.4g}; median cosine GPU {cg:.4g} "
            f"CPU {cc:.4g}")
        need(mg <= 1.5 * mc + 0.01 and cg >= 0.5 * cc, f"{label} bf16 "
             f"{part}: the GPU's gradients lie further from float64 than "
             f"the CPU's allow")


# the bfloat16 layers on the card against the same layers on the CPU: at
# most this share of an output's elements may differ, each by at most a
# bfloat16 step at each of the layer's roundings, at the magnitude of the
# output plus its bias (where the bias cancels a sum, one step of the sum
# is many steps of the output), plus BF16_LAYER_ATOL of the output's
# largest magnitude (where a sum cancels, two float32 sums in other orders
# differ by many steps of the output).  A layer that rounds elsewhere on
# the card differs on far more: the two-group BatchNorm rounded once
# differs from the JAX package's on 43% of its outputs, the instance norm
# in float32 on 53% (tests/test_torch_bf16_layers.py); one computing in
# float32 returns float32
BF16_LAYER_SHARE = 0.01
BF16_LAYER_ATOL = 2.0 ** -14
# the batch statistics the BatchNorm cases leave, card against CPU, each
# within this share of its tensor's largest magnitude: both sum in
# float32, in other orders (a running mean near 0 has no relative scale)
BF16_STATS_RTOL = 1e-5


def compare_bf16_layers(rng):
    """The bfloat16 compute dtype's layers at the trunks' and the
    generator's shapes, each on the card and on the CPU from the same
    float32 parameters and bfloat16 input: BatchNorm (one group in train
    and eval mode, two groups in train mode, with the running statistics
    they leave), the generator's instance norm, the convolutions (a 3x3
    trunk conv, a 1x1 head conv with its bias), the transposed
    convolutions (the heads' k4 s2 and the generator's k3 s2) and the
    MANO head's dense layer.  Each output is bfloat16 and differs from the
    CPU's on at most BF16_LAYER_SHARE of its elements, each within the
    bound above (the roundings: the sum or the normalization, and the
    bias add after a rounded sum; the two-group BatchNorm's and the
    instance norm's three bfloat16 operations)."""
    import copy
    import torch
    from dsf_tpu_torch.models import layers
    from dsf_tpu_torch.models.cyclegan import InstanceNorm

    gen = torch.Generator().manual_seed(int(rng.randint(2 ** 31)))

    def bn(groups, train):
        m = layers.batch_norm(64)
        with torch.no_grad():
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.normal_(0, 0.3, generator=gen)
            m.running_mean.normal_(0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 2, generator=gen)
        m.groups = groups
        return m.train(train)

    def param_layer(m):
        with torch.no_grad():
            for p in m.parameters():
                p.normal_(0, (2.0 / p[0].numel()) ** 0.5, generator=gen)
        layers.set_compute_dtype(m, torch.bfloat16)
        return m

    # (name, module, input shape, roundings)
    cases = (
        ("batch_norm 1 group train", bn(1, True), (32, 64, 32, 32), 1),
        ("batch_norm 1 group eval", bn(1, False), (32, 64, 32, 32), 1),
        ("batch_norm 2 groups train", bn(2, True), (64, 64, 32, 32), 3),
        ("instance_norm", InstanceNorm(256), (8, 256, 32, 32), 3),
        ("conv 3x3 64->64", param_layer(layers.conv(64, 64, 3, 1, 1)),
         (8, 64, 32, 32), 1),
        ("conv 1x1 256->84 + bias",
         param_layer(layers.conv(256, 84, 1, 1, 0, bias=True)),
         (8, 256, 32, 32), 2),
        ("conv_transpose k4 s2 256->256",
         param_layer(layers.conv_transpose(256, 256)), (8, 256, 8, 8), 1),
        ("conv_transpose k3 s2 256->128 + bias", param_layer(
            layers.ConvTranspose2d(256, 128, 3, stride=2, padding=1,
                                   output_padding=1)), (4, 256, 32, 32), 2),
        ("linear 512->62 + bias", param_layer(layers.Linear(512, 62)),
         (32, 512), 2))
    rows = {}
    with torch.no_grad():
        for name, m, shape, roundings in cases:
            x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 2
                                 + 0.5).bfloat16()
            mc, mg = m, copy.deepcopy(m).cuda()
            yc, yg = mc(x).double(), mg(x.cuda()).cpu()
            st = bf16_steps(yg, yc)
            b = getattr(m, "bias", None)
            b = 0.0 if b is None else b.double().abs().reshape(
                (-1,) + (1,) * (yc.dim() - 2))
            bound = (roundings * bf16_step(
                torch.maximum(yg.double().abs(), yc.abs()) + b)
                + BF16_LAYER_ATOL * float(yc.abs().max()))
            stats = {n: float((mg.get_buffer(n).cpu() - mc.get_buffer(n))
                              .abs().max() / mc.get_buffer(n).abs().max())
                     for n in ("running_mean", "running_var")
                     if isinstance(m, layers.BatchNorm2d) and m.training}
            rows[name] = dict(dtype=str(yg.dtype).replace("torch.", ""),
                              share=float((st > 0).float().mean()),
                              steps_max=float(st.max()),
                              over=float(((yg.double() - yc).abs()
                                          - bound).max()),
                              stats_rel=max(stats.values(), default=0.0))
    say("compare bfloat16 layers, card against CPU (share of elements "
        "that differ, largest difference in bfloat16 steps, largest "
        "excess over the bound, running statistics' largest difference "
        "over their largest magnitude): " + json.dumps(
            {k: {n: float(f"{v:.4g}") if isinstance(v, float) else v
                 for n, v in r.items()} for k, r in rows.items()}))
    for name, r in rows.items():
        need(r["dtype"] == "bfloat16", f"bf16 {name} returned {r['dtype']} "
             "on the card")
        need(r["over"] <= 0 and r["share"] <= BF16_LAYER_SHARE,
             f"bf16 {name} on the card rounds apart from the CPU: {r}")
        need(r["stats_rel"] <= BF16_STATS_RTOL, f"bf16 {name} on the card "
             f"leaves other running statistics than the CPU: {r}")


def compare_step(mano_path, net="ResNet_stage_18", bf16=True):
    """One Pretrain loss and its gradients on the card and on the CPU, from
    the same weights, on the card's synth batch; and the same loss on the
    CPU in float64, the witness that says how far float32 rounding alone
    moves each gradient.  ``net`` names the trunks; ``bf16`` adds the
    bfloat16 runs."""
    import copy
    import torch
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.render import renderer as rnd
    from dsf_tpu_torch.training import phases
    from dsf_tpu_torch.training.trainer import Trainer

    B = COMPARE_BATCH
    cfg = Config(dataset="nyu", batch_size=B, stage_num=2,
                 input_size=INPUT_SIZE, seed=SEED + 2,
                 mano_model_path=mano_path, net=net)
    gpu = Trainer(cfg, mano_path, device="cuda")
    cpu = Trainer(cfg, mano_path, device="cpu")
    sg, sc = gpu.init_state(), cpu.init_state()
    net64 = copy.deepcopy(sc.net).double()
    r64 = float64_renderer(cpu.renderer)
    para, cube = next(random_param_source(B, seed=SEED + 3))
    para, cube = torch.from_numpy(para), torch.from_numpy(cube)
    draws = gpu.draw(B)
    with exact_float32():
        sample_g = phases.pretrain_sample(gpu.renderer, draws.to("cuda"),
                                          para.cuda(), cube.cuda())
        sample_c = phases.pretrain_sample(cpu.renderer, draws, para, cube)
        img_g, img_c = sample_g[0].cpu(), sample_c[0]
        synth_flips = int(((img_g < FG) != (img_c < FG)).sum())
        synth_far = int(((img_g - img_c).abs() > 1e-3).sum())
        on_cpu = [x.cpu() for x in sample_g]
        # the GPU twice: cuDNN may pick algorithms whose sums run in another
        # order from call to call
        runs = {"gpu": (sg.net, gpu.renderer, sample_g),
                "gpu_again": (sg.net, gpu.renderer, sample_g),
                "cpu": (sc.net, cpu.renderer, on_cpu),
                "cpu64": (net64, r64, [x.double() for x in on_cpu])}

        # the stage-2 input render of each run's stage-1 MANO, from copies
        # of the nets (their BatchNorm statistics move in train mode)
        sil = {}
        for key, (net, r, smp) in runs.items():
            with torch.no_grad():
                img, _, _, _, _, center, cube_s, _ = smp
                para0 = copy.deepcopy(net)(img, r, center, cube_s)[0][1]
                img2, _, _, _ = rnd.render_params(r, para0, center, cube_s,
                                                  img_stride=2)
                sil[key] = (img2 < FG).cpu()

        # the bfloat16 compute dtype on both devices, the same weights
        if bf16:
            runs["gpu_bf16"] = (bf16_copy(sg.net), gpu.renderer, sample_g)
            runs["cpu_bf16"] = (bf16_copy(sc.net), cpu.renderer, on_cpu)
        loss, grads = {}, {}
        for key, (net, r, smp) in runs.items():
            net.zero_grad(set_to_none=True)
            value, _ = phases.pretrain_loss(net, r, smp, cfg, 2)
            value.backward()
            loss[key] = value.item()
            grads[key] = {n: p.grad.detach().cpu()
                          for n, p in net.named_parameters()}
    flips = {k: int((sil[k] != sil["cpu"]).sum()) for k in ("gpu", "cpu64")}
    gpu_gpu = rel_l2(grads["gpu_again"], grads["gpu"])
    say(f"compare {cfg.net} B={B} {INPUT_SIZE}^2: synth batch GPU vs CPU: {synth_flips} "
        f"silhouette flips and {synth_far} pixels beyond 1e-3 of {img_c.numel()}; "
        f"stage-2 render silhouette flips against the CPU's: GPU {flips['gpu']}, "
        f"CPU float64 {flips['cpu64']} of {sil['cpu'].numel()}")
    gpu_cpu = rel_l2(grads["gpu"], grads["cpu"])
    gpu_64 = rel_l2(grads["gpu"], grads["cpu64"])
    cpu_64 = rel_l2(grads["cpu"], grads["cpu64"])
    say(f"compare loss GPU {loss['gpu']:.7g} CPU {loss['cpu']:.7g} CPU float64 "
        f"{loss['cpu64']:.10g}; gradient relative L2 per parameter: GPU vs CPU "
        f"{spread(gpu_cpu)}; GPU vs float64 {spread(gpu_64)}; CPU vs float64 "
        f"{spread(cpu_64)}; GPU vs GPU again {spread(gpu_gpu)}")
    rel_loss = abs(loss["gpu"] - loss["cpu"]) / abs(loss["cpu"])
    # the loss sums ~10^5 float32 terms in other orders on the two devices
    need(rel_loss <= 1e-4, f"GPU loss {loss['gpu']} differs from the CPU's "
         f"{loss['cpu']}")
    bad = {k: v for k, v in gpu_cpu.items() if not v <= grad_tol(k)}
    need(not bad, f"GPU gradients differ from the CPU's: {bad}")
    bad = {k: v for k, v in gpu_64.items() if not v <= grad_tol(k)}
    need(not bad, f"GPU gradients differ from the float64 ones: {bad}")
    ratio = (float(np.median(list(gpu_64.values())))
             / float(np.median(list(cpu_64.values()))))
    need(ratio <= MEDIAN_RATIO, f"GPU gradients lie {ratio:.3g} times further "
         "from float64 than the CPU's, in the median over parameters")
    if bf16:
        check_bf16_runs("Pretrain", loss, grads)


@contextlib.contextmanager
def recording(module, name, into):
    """Record the last result of ``module.name`` in ``into[name]`` for the
    duration (the FinetuneStage loss calls it through the module)."""
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        into[name] = orig(*args, **kw)
        return into[name]

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


# the FinetuneStage metrics held in phase 5, each against a tolerance set
# from its witnesses: 3x the larger of the CPU's distance to float64 and the
# GPU's to its own second run, plus 1e-3 of the float64 value
FS_METRICS = ("d2m_0", "d2m_1", "pd2m_0", "pd2m_1", "m2d_0", "m2d_1",
              "coll_0", "coll_1", "P2M", "M2P")


def compare_finetune_stage(mano_path, dataset="nyu", net="ResNet_stage_18",
                           bf16=True):
    """One FinetuneStage loss and its gradients on the card and on the CPU,
    from the same weights, on the card's synth batch and one real batch
    (the same cloud-sampling scores) on ``dataset``'s camera (NYU's, and
    ICVL's: synth hands 150-600 mm away, its joint order and error rule;
    the bfloat16 runs on NYU's only); the same loss on the CPU in float64
    is the witness.  The stage-1 MANO head feeds the losses and, through
    the stage-2 remap render, the stage-2 trunk: the share of its gradient
    that comes that way (measured on the CPU run) is held at the trunks'
    tolerance, the rest at the heads'.  On the card (H100 80GB HBM3 at
    700 W) the GPU lay a median 0.0496 (max 0.0696) from the CPU in the
    trunks and 0.00398 in that head; the CPU lay a median 0.0908 from
    float64, and 0.0709 in that head.  ``net`` names the trunks; ``bf16``
    adds the bfloat16 runs."""
    import copy
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.ops import point_mesh as pm
    from dsf_tpu_torch.training import phases
    from dsf_tpu_torch.training.trainer import Trainer

    B = COMPARE_BATCH
    name = ("FinetuneStage" + ("" if dataset == "nyu" else f" on {dataset}")
            + ("" if net == "ResNet_stage_18" else f" {net}"))
    bf16 = bf16 and dataset == "nyu"
    cfg = Config(dataset=dataset, batch_size=B, stage_num=2,
                 input_size=INPUT_SIZE, seed=SEED + 7,
                 mano_model_path=mano_path, net=net)
    gpu = Trainer(cfg, mano_path, device="cuda")
    cpu = Trainer(cfg, mano_path, device="cpu")
    sg, sc = gpu.init_state(), cpu.init_state()
    net64 = copy.deepcopy(sc.net).double()
    r64 = float64_renderer(cpu.renderer)
    para, cube = next(random_param_source(B, seed=SEED + 8))
    para, cube = torch.from_numpy(para), torch.from_numpy(cube)
    draws = gpu.draw(B, "FinetuneStage")
    real = demo.real_batch(cpu.renderer, B, np.random.RandomState(SEED + 9),
                           dataset=dataset)
    keys = ("img", "center", "cube", "M", "xyz_gt")
    with exact_float32():
        sample_g = phases.finetune_stage_sample(
            gpu.renderer, draws.to("cuda"), para.cuda(), cube.cuda())
        on_cpu = [x.cpu() for x in sample_g]
        runs = {"gpu": (sg.net, gpu.renderer, sample_g,
                        [real[k].cuda() for k in keys], draws.scores.cuda()),
                "cpu": (sc.net, cpu.renderer, on_cpu,
                        [real[k] for k in keys], draws.scores),
                "cpu64": (net64, r64, [x.double() for x in on_cpu],
                          [real[k].double() for k in keys],
                          draws.scores.double())}
        runs["gpu_again"] = runs["gpu"]
        if bf16:
            runs["gpu_bf16"] = (bf16_copy(sg.net),) + runs["gpu"][1:]
            runs["cpu_bf16"] = (bf16_copy(sc.net),) + runs["cpu"][1:]
        loss, grads, mets, rec = {}, {}, {}, {}
        for key, (net, r, smp, rb, scores) in runs.items():
            net.zero_grad(set_to_none=True)
            rec[key] = {}
            outs, head_in = [], []

            def keep(module, inputs, out):
                out = [[t.clone() for t in o] for o in out]
                out[0][1].retain_grad()
                outs.append(out)
                return out

            hooks = [net.register_forward_hook(keep),
                     net.mano_regress[2].register_forward_hook(
                         lambda m, inputs, o: head_in.append(inputs[0]))]
            with recording(phases, "_prep_real", rec[key]), \
                    recording(pm, "argmin_faces", rec[key]):
                value, m = phases.finetune_stage_loss(net, r, smp, scores,
                                                      *rb, cfg)
            value.backward()
            for h in hooks:
                h.remove()
            loss[key] = value.item()
            mets[key] = {k: float(v) for k, v in m.items()}
            grads[key] = {n: p.grad.detach().cpu()
                          for n, p in net.named_parameters()}
            if key == "cpu":
                g_para = outs[0][0][1].grad
                tail_only = g_para.T @ head_in[0].detach()
    share = float((grads["cpu"]["mano_regress.2.weight"] - tail_only).norm()
                  / grads["cpu"]["mano_regress.2.weight"].norm())
    seg_diff = int((rec["gpu"]["_prep_real"][2].cpu()
                    != rec["cpu"]["_prep_real"][2]).sum())
    win_diff = int((rec["gpu"]["argmin_faces"][1].cpu()
                    != rec["cpu"]["argmin_faces"][1]).sum())
    n_pts = rec["cpu"]["_prep_real"][2].numel()
    say(f"compare {name} B={B} {INPUT_SIZE}^2: joint-cloud part labels "
        f"that differ between the GPU and CPU runs {seg_diff} of {n_pts}; "
        f"ICP nearest faces (K3 against the plain argmin) {win_diff} of "
        f"{4 * n_pts}")
    gpu_cpu = rel_l2(grads["gpu"], grads["cpu"])
    gpu_64 = rel_l2(grads["gpu"], grads["cpu64"])
    cpu_64 = rel_l2(grads["cpu"], grads["cpu64"])
    gpu_gpu = rel_l2(grads["gpu_again"], grads["gpu"])
    say(f"compare {name} loss GPU {loss['gpu']:.7g} CPU "
        f"{loss['cpu']:.7g} CPU float64 {loss['cpu64']:.10g}; gradient "
        f"relative L2 per parameter: GPU vs CPU {spread(gpu_cpu)}; GPU vs "
        f"float64 {spread(gpu_64)}; CPU vs float64 {spread(cpu_64)}; GPU vs "
        f"GPU again {spread(gpu_gpu)}; the stage-1 MANO head's share through "
        f"the stage-2 trunk {share:.4g}")
    rows = {}
    for k in mets["cpu"]:
        v = {run: mets[run][k] for run in mets}
        rows[k] = {run: float(f"{x:.7g}") for run, x in v.items()}
    say(f"compare {name} metrics ({', '.join(mets)}): " + json.dumps(rows))
    rel_loss = abs(loss["gpu"] - loss["cpu"]) / abs(loss["cpu"])
    need(rel_loss <= 1e-4, f"{name} GPU loss {loss['gpu']} differs "
         f"from the CPU's {loss['cpu']}")
    for k in FS_METRICS:
        m64 = mets["cpu64"][k]
        tol = (3 * max(abs(mets["cpu"][k] - m64),
                       abs(mets["gpu"][k] - mets["gpu_again"][k]))
               + 1e-3 * abs(m64))
        need(abs(mets["gpu"][k] - mets["cpu"][k]) <= tol,
             f"{name} metric {k}: GPU {mets['gpu'][k]} CPU "
             f"{mets['cpu'][k]} float64 {m64} (tolerance {tol:.3g})")

    heads = {k: (float(f"{gpu_cpu[k]:.3g}"), float(f"{cpu_64[k]:.3g}"))
             for k in gpu_cpu if k.startswith(("mano_regress", "finals_s2"))}
    say(f"compare {name} heads' gradients (GPU vs CPU, CPU vs float64): "
        + json.dumps(heads))

    def tol(name):
        """Pretrain's tolerance, with the stage-1 MANO head's share through
        the stage-2 trunk held at the trunks'."""
        if name.startswith("mano_regress."):
            return grad_tol(name) + grad_tol("trunk") * share
        return grad_tol(name)

    bad = {k: v for k, v in gpu_cpu.items() if not v <= tol(k)}
    need(not bad, f"{name} GPU gradients differ from the CPU's: {bad}")
    # against float64, also twice the CPU's own distance where float32
    # rounding alone moves a gradient further: the part labels, nearest
    # faces and silhouettes the losses select move with it, and a second
    # float32 run that far from float64 may lie twice as far
    bad = {k: v for k, v in gpu_64.items()
           if not v <= max(tol(k), 2 * cpu_64[k])}
    need(not bad, f"{name} GPU gradients differ from float64: {bad}")
    ratio = (float(np.median(list(gpu_64.values())))
             / float(np.median(list(cpu_64.values()))))
    need(ratio <= MEDIAN_RATIO, f"{name} GPU gradients lie {ratio:.3g} "
         "times further from float64 than the CPU's, in the median")
    if bf16:
        check_bf16_runs("FinetuneStage", loss, grads)


# the Finetune metrics held in phase 5, as FS_METRICS
F_METRICS = ("d2m", "pd2m", "m2d", "coll", "P2M", "M2P")


def compare_finetune(mano_path, net="ResNet_stage_18"):
    """One Finetune loss with the stand-in generator and its gradients on
    the card and on the CPU, from the same weights (net and generator), on
    the card's synth batch and one real batch (the same cloud-sampling
    scores); the same loss on the CPU in float64 (net, generator, MANO and
    batch) is the witness.  The generator's image of the synth batch is
    printed against the CPU's and float64's first: the card's cuDNN
    convolutions may take FFT or Winograd algorithms, whose float32
    rounding differs from the CPU's, so it is held to 1e-3 on its tanh
    output.  The one-stage heads feed the losses only, so they are held
    at grad_tol's 1e-2 and every trunk layer at 0.2, against float64 also
    twice the CPU's own distance where that is larger, as FinetuneStage's;
    the metrics as FinetuneStage's.  ``net`` names the trunks."""
    import copy
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.training import phases
    from dsf_tpu_torch.training.trainer import Trainer

    B = COMPARE_BATCH
    cfg = dataclasses.replace(train_config(mano_path, 1, SEED + 10,
                                           net=net), batch_size=B)
    gpu = Trainer(cfg, mano_path, device="cuda")
    cpu = Trainer(cfg, mano_path, device="cpu")
    sg, sc = gpu.init_state(), cpu.init_state()
    net64 = copy.deepcopy(sc.net).double()
    gen64 = copy.deepcopy(cpu.transfer_net).double()
    r64 = float64_renderer(cpu.renderer)
    para, cube = next(random_param_source(B, seed=SEED + 11))
    para, cube = torch.from_numpy(para), torch.from_numpy(cube)
    draws = gpu.draw(B, "Finetune")
    real = demo.real_batch(cpu.renderer, B, np.random.RandomState(SEED + 12))
    keys = ("img", "center", "cube", "M", "xyz_gt")

    def transfer64(img):
        with torch.no_grad():
            return gen64(img)

    with exact_float32():
        sample_g = phases.finetune_stage_sample(
            gpu.renderer, draws.to("cuda"), para.cuda(), cube.cuda())
        on_cpu = [x.cpu() for x in sample_g]
        img_t = {"gpu": gpu.transfer(sample_g[0]).cpu(),
                 "cpu": cpu.transfer(on_cpu[0]),
                 "cpu64": transfer64(on_cpu[0].double())}
        runs = {"gpu": (sg.net, gpu.renderer, sample_g,
                        [real[k].cuda() for k in keys], draws.scores.cuda(),
                        gpu.transfer),
                "cpu": (sc.net, cpu.renderer, on_cpu,
                        [real[k] for k in keys], draws.scores, cpu.transfer),
                "cpu64": (net64, r64, [x.double() for x in on_cpu],
                          [real[k].double() for k in keys],
                          draws.scores.double(), transfer64)}
        runs["gpu_again"] = runs["gpu"]
        loss, grads, mets = {}, {}, {}
        for key, (net, r, smp, rb, scores, transfer) in runs.items():
            net.zero_grad(set_to_none=True)
            value, m = phases.finetune_loss(net, r, smp, scores, *rb, cfg,
                                            transfer)
            value.backward()
            loss[key] = value.item()
            mets[key] = {k: float(v) for k, v in m.items()}
            grads[key] = {n: p.grad.detach().cpu()
                          for n, p in net.named_parameters()}
    gen_gpu_cpu = float((img_t["gpu"] - img_t["cpu"]).abs().max())
    gen_gpu_64 = float((img_t["gpu"].double() - img_t["cpu64"]).abs().max())
    gen_cpu_64 = float((img_t["cpu"].double() - img_t["cpu64"]).abs().max())
    say(f"compare generator B={B} {INPUT_SIZE}^2 (stand-in, on the synth "
        f"batch): max abs GPU vs CPU {gen_gpu_cpu:.3g}, GPU vs float64 "
        f"{gen_gpu_64:.3g}, CPU vs float64 {gen_cpu_64:.3g}")
    need(gen_gpu_cpu <= 1e-3, f"the generator's image on the card differs "
         f"from the CPU's by {gen_gpu_cpu}")
    gpu_cpu = rel_l2(grads["gpu"], grads["cpu"])
    gpu_64 = rel_l2(grads["gpu"], grads["cpu64"])
    cpu_64 = rel_l2(grads["cpu"], grads["cpu64"])
    gpu_gpu = rel_l2(grads["gpu_again"], grads["gpu"])
    say(f"compare Finetune {cfg.net} B={B} {INPUT_SIZE}^2 with the generator: loss GPU "
        f"{loss['gpu']:.7g} CPU {loss['cpu']:.7g} CPU float64 "
        f"{loss['cpu64']:.10g}; gradient relative L2 per parameter: GPU vs "
        f"CPU {spread(gpu_cpu)}; GPU vs float64 {spread(gpu_64)}; CPU vs "
        f"float64 {spread(cpu_64)}; GPU vs GPU again {spread(gpu_gpu)}")
    say("compare Finetune metrics (GPU, GPU again, CPU, CPU float64): "
        + json.dumps({k: {run: float(f"{mets[run][k]:.7g}") for run in mets}
                      for k in mets["cpu"]}))
    rel_loss = abs(loss["gpu"] - loss["cpu"]) / abs(loss["cpu"])
    need(rel_loss <= 1e-4, f"Finetune GPU loss {loss['gpu']} differs from "
         f"the CPU's {loss['cpu']}")
    for k in F_METRICS:
        m64 = mets["cpu64"][k]
        tol = (3 * max(abs(mets["cpu"][k] - m64),
                       abs(mets["gpu"][k] - mets["gpu_again"][k]))
               + 1e-3 * abs(m64))
        need(abs(mets["gpu"][k] - mets["cpu"][k]) <= tol,
             f"Finetune metric {k}: GPU {mets['gpu'][k]} CPU "
             f"{mets['cpu'][k]} float64 {m64} (tolerance {tol:.3g})")

    def tol(name):
        return 1e-2 if name.startswith(("mano_regress", "finals")) else 0.2

    bad = {k: v for k, v in gpu_cpu.items() if not v <= tol(k)}
    need(not bad, f"Finetune GPU gradients differ from the CPU's: {bad}")
    bad = {k: v for k, v in gpu_64.items()
           if not v <= max(tol(k), 2 * cpu_64[k])}
    need(not bad, f"Finetune GPU gradients differ from float64: {bad}")
    ratio = (float(np.median(list(gpu_64.values())))
             / float(np.median(list(cpu_64.values()))))
    need(ratio <= MEDIAN_RATIO, f"Finetune GPU gradients lie {ratio:.3g} "
         "times further from float64 than the CPU's, in the median")


def compare_m2p(mano_path):
    """The M2P term and its gradient with a gate that passes.  One Finetune
    loss (one stage, no generator) at B=4 whose MANO head's weight is
    zeroed in every copy of the net, so the head predicts its bias (a flat
    hand, cam scale 1) whatever the image; the real half is that
    prediction rendered (``demo.real_batch(..., para=...)``), so the real
    crop and the render agree and the ICP distances vanish, and the gate
    opens.  On the card (twice), on the CPU and on the CPU in float64: the
    gate's samples and joints, the M2P term (held as the Finetune metrics
    are) and its own gradient in the net (``torch.autograd.grad`` of the
    term; the heads' ``finals`` at 1e-2 and the rest at 0.2 relative L2,
    against float64 also twice the CPU's own distance, as
    ``compare_finetune`` holds the whole loss's)."""
    import copy
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.training import phases
    from dsf_tpu_torch.training.trainer import Trainer

    B = COMPARE_BATCH
    cfg = dataclasses.replace(train_config(mano_path, 1, SEED + 13),
                              batch_size=B, transferNet_pth="")
    gpu = Trainer(cfg, mano_path, device="cuda")
    cpu = Trainer(cfg, mano_path, device="cpu")
    sg, sc = gpu.init_state(), cpu.init_state()
    with torch.no_grad():
        for net in (sg.net, sc.net):
            net.mano_regress[2].weight.zero_()
    net64 = copy.deepcopy(sc.net).double()
    r64 = float64_renderer(cpu.renderer)
    own = sc.net.mano_regress[2].bias.detach().expand(B, -1)
    real = demo.real_batch(cpu.renderer, B, np.random.RandomState(SEED + 14),
                           para=own)
    para, cube = next(random_param_source(B, seed=SEED + 15))
    para, cube = torch.from_numpy(para), torch.from_numpy(cube)
    draws = gpu.draw(B, "Finetune")
    keys = ("img", "center", "cube", "M", "xyz_gt")
    with exact_float32():
        sample_g = phases.finetune_stage_sample(
            gpu.renderer, draws.to("cuda"), para.cuda(), cube.cuda())
        on_cpu = [x.cpu() for x in sample_g]
        runs = {"gpu": (sg.net, gpu.renderer, sample_g,
                        [real[k].cuda() for k in keys], draws.scores.cuda()),
                "cpu": (sc.net, cpu.renderer, on_cpu,
                        [real[k] for k in keys], draws.scores),
                "cpu64": (net64, r64, [x.double() for x in on_cpu],
                          [real[k].double() for k in keys],
                          draws.scores.double())}
        runs["gpu_again"] = runs["gpu"]
        m2p, gate, grads = {}, {}, {}
        for key, (net, r, smp, rb, scores) in runs.items():
            rec = {}
            with recording(phases, "_m2p_mask", rec), \
                    recording(phases, "_masked_select_sl1", rec):
                phases.finetune_loss(net, r, smp, scores, *rb, cfg, None)
            names = [n for n, _ in net.named_parameters()]
            g = torch.autograd.grad(rec["_masked_select_sl1"],
                                    list(net.parameters()), allow_unused=True)
            m2p[key] = (float(rec["_masked_select_sl1"].detach())
                        * cfg.coord_weight)
            gate[key] = rec["_m2p_mask"].cpu()
            grads[key] = {n: x.detach().cpu() for n, x in zip(names, g)
                          if x is not None}
    reached = sorted(grads["cpu"])
    say(f"compare M2P B={B} {INPUT_SIZE}^2 (real half rendered from the "
        f"net's own MANO prediction): gate samples x joints open GPU "
        f"{int(gate['gpu'].sum())}, CPU {int(gate['cpu'].sum())}, float64 "
        f"{int(gate['cpu64'].sum())} of {gate['cpu'].numel()}; M2P "
        + json.dumps({k: float(f"{v:.7g}") for k, v in m2p.items()})
        + f"; its gradient reaches {len(reached)} parameter tensors")
    need(all(bool(gate[k].any()) for k in gate) and m2p["cpu"] > 0,
         "the M2P gate stayed shut")
    need(all(torch.equal(gate[k], gate["cpu"]) for k in gate),
         "the M2P gate differs between the runs")
    tol = (3 * max(abs(m2p["cpu"] - m2p["cpu64"]),
                   abs(m2p["gpu"] - m2p["gpu_again"]))
           + 1e-3 * abs(m2p["cpu64"]))
    need(abs(m2p["gpu"] - m2p["cpu"]) <= tol, f"M2P: GPU {m2p['gpu']} CPU "
         f"{m2p['cpu']} float64 {m2p['cpu64']} (tolerance {tol:.3g})")
    need(all(sorted(grads[k]) == reached for k in grads),
         "M2P's gradient reaches other parameters on the card")
    gpu_cpu = rel_l2(grads["gpu"], grads["cpu"])
    gpu_64 = rel_l2(grads["gpu"], grads["cpu64"])
    cpu_64 = rel_l2(grads["cpu"], grads["cpu64"])
    gpu_gpu = rel_l2(grads["gpu_again"], grads["gpu"])
    say(f"compare M2P gradient relative L2 per parameter: GPU vs CPU "
        f"{spread(gpu_cpu)}; GPU vs float64 {spread(gpu_64)}; CPU vs float64 "
        f"{spread(cpu_64)}; GPU vs GPU again {spread(gpu_gpu)}; finals "
        + json.dumps({k: (float(f"{gpu_cpu[k]:.3g}"), float(f"{cpu_64[k]:.3g}"))
                      for k in gpu_cpu if k.startswith("finals")}))
    need(any(k.startswith("finals") for k in reached)
         and any(k.startswith("layer") for k in reached),
         f"M2P's gradient misses the heads or the trunk: {reached}")

    def gtol(name):
        return 1e-2 if name.startswith("finals") else 0.2

    bad = {k: v for k, v in gpu_cpu.items() if not v <= gtol(k)}
    need(not bad, f"M2P's GPU gradient differs from the CPU's: {bad}")
    bad = {k: v for k, v in gpu_64.items()
           if not v <= max(gtol(k), 2 * cpu_64[k])}
    need(not bad, f"M2P's GPU gradient differs from float64: {bad}")


# ----------------------------------------------------------------- phase 6

@contextlib.contextmanager
def max_epochs(n):
    """``Config.max_epoch`` (a per-dataset property) set to ``n``."""
    from dsf_tpu_torch.config import Config
    saved = Config.max_epoch
    Config.max_epoch = property(lambda self: n)
    try:
        yield
    finally:
        Config.max_epoch = saved


@contextlib.contextmanager
def watched_loop(rec):
    """The loop's trainer with each train step, eval batch, epoch, restore
    and 3-view evaluation recorded in ``rec``: per call its launch deltas,
    its host start time, its metrics or errors (left on the device)."""
    import torch
    from dsf_tpu_torch import kernels
    from dsf_tpu_torch.training import checkpoints as ck
    from dsf_tpu_torch.training import loop as L
    from dsf_tpu_torch.training import trainer as T
    orig = (T.Trainer.train_step_fn, T.Trainer._eval_step,
            T.Trainer.fit_epoch, ck.restore, L._test_views)
    for k in ("steps", "starts", "metrics", "evals", "errors", "epochs",
              "restored", "views_s"):
        rec.setdefault(k, [])

    def delta(before):
        return {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}

    def train_step_fn(self, phase):
        step = orig[0](self, phase)

        def watched(state, draws, batch):
            before = dict(kernels.LAUNCHES)
            rec["starts"].append(time.perf_counter())
            state, metrics = step(state, draws, batch)
            rec["steps"].append(delta(before))
            rec["metrics"].append(metrics)
            return state, metrics
        return watched

    def eval_step(self, state, batch):
        before = dict(kernels.LAUNCHES)
        errors, results = orig[1](self, state, batch)
        rec["evals"].append(delta(before))
        rec["errors"].append(errors)
        return errors, results

    def fit_epoch(self, *a, **kw):
        t0 = time.perf_counter()
        out = orig[2](self, *a, **kw)
        torch.cuda.synchronize()
        rec["epochs"].append(time.perf_counter() - t0)
        return out

    def restore(*a, **kw):
        state, epoch = orig[3](*a, **kw)
        rec["restored"].append((state, epoch))
        return state, epoch

    def test_views(*a, **kw):
        t0 = time.perf_counter()
        orig[4](*a, **kw)
        torch.cuda.synchronize()
        rec["views_s"].append(time.perf_counter() - t0)

    (T.Trainer.train_step_fn, T.Trainer._eval_step, T.Trainer.fit_epoch,
     ck.restore, L._test_views) = (train_step_fn, eval_step, fit_epoch,
                                   restore, test_views)
    try:
        yield rec
    finally:
        (T.Trainer.train_step_fn, T.Trainer._eval_step, T.Trainer.fit_epoch,
         ck.restore, L._test_views) = orig


def loop_config(mano_path, root, save_dir, **kw):
    """The default configuration (FinetuneStage, two stages, NYU) at full
    width with the stand-in generator, one epoch, every export on; ``kw``
    overrides."""
    from dsf_tpu_torch.config import Config
    base = dict(dataset="nyu", batch_size=TRAIN_BATCH, stage_num=2,
                train_stage="Finetune", input_size=INPUT_SIZE, seed=SEED,
                root_dir=root, mano_model_path=mano_path, save_dir=save_dir,
                transferNet_pth=STAND_IN, test_during_train=True,
                save_result=True, save_mesh=True, image_every=0)
    return Config(**dict(base, **kw))


def run_loop(mano_path, smi, root):
    """Phase 6: the trainer's own entry point.  A fake NYU set built on
    the card (K6) under ``root`` (phase 8 trains on it too), ``loop.run``
    on it at full width (one epoch: 8
    FinetuneStage steps fed by the loader, the per-epoch test, latest and
    best, the 3-view evaluation and exports), a resume from its run
    directory, its checkpoint evaluated on the card against the CPU, the
    finite guard under ``set_sync_debug_mode("error")``, the other host
    syncs of a step, and the loader's, the epoch's and the evaluation's
    rates.  Returns the launch counts of the fake set's build and of the
    loop's run."""
    import warnings
    import zlib

    import torch
    from dsf_tpu_torch import kernels
    from dsf_tpu_torch.data import datasets as D
    from dsf_tpu_torch.data import native, readers
    from dsf_tpu_torch.data.fake import make_fake_nyu
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.serving import InferenceEngine
    from dsf_tpu_torch.training import checkpoints as ck
    from dsf_tpu_torch.training import loop as L
    from dsf_tpu_torch.training.trainer import Trainer, guarded_update

    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        make_fake_nyu(root, mano_path, n_train=FAKE_TRAIN, n_test=FAKE_TEST,
                      seed=SEED, batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts["fake"] = dict(kernels.LAUNCHES)
        n = FAKE_TRAIN + FAKE_TEST
        batches = -(-FAKE_TRAIN // TRAIN_BATCH) + -(-FAKE_TEST // TRAIN_BATCH)
        say(f"loop fake NYU set: {FAKE_TRAIN} train + {FAKE_TEST} test "
            f"frames (x3 views) of 640x480 in {secs:.3f} s, "
            f"{n / secs:.1f} frames/s (render, PNG writing, labels); "
            f"launches {json.dumps(counts['fake'])}; {smi}")
        need(counts["fake"] == launches(raster_dense=batches),
             f"the fake set did not launch K6 once a batch: {counts['fake']}")
        nyu = os.path.join(root, "nyu")

        # the loader alone: one augmented pass decoding every PNG, then one
        # from its depth cache; and one thread's decode of a frame
        frames = [os.path.join(nyu, "train", f"depth_1_{i + 1:07d}.png")
                  for i in range(TRAIN_BATCH)]
        t0 = time.perf_counter()
        native.load()
        say(f"loop host library csrc/host_data.cpp built and loaded in "
            f"{time.perf_counter() - t0:.3f} s (c++ at first use)")
        t0 = time.perf_counter()
        raws = [readers.read_png_chunks(f) for f in frames]
        t1 = time.perf_counter()
        raws = [zlib.decompress(idat) for _, idat in raws]
        t2 = time.perf_counter()
        for r in raws:
            native.png_nyu_depth(r, 480, 640, 3)
        t3 = time.perf_counter()
        say(f"loop one thread's decode of a 640x480 frame, ms: read "
            f"{(t1 - t0) * 1e3 / len(frames):.3f}, inflate "
            f"{(t2 - t1) * 1e3 / len(frames):.3f}, unfilter and unpack "
            f"{(t3 - t2) * 1e3 / len(frames):.3f}; os.cpu_count() "
            f"{os.cpu_count()}")
        ds = D.NYUDataset(nyu, "train", img_size=INPUT_SIZE, seed=SEED)
        ds.enable_depth_cache()
        rates = []
        for _ in range(2):
            t0 = time.perf_counter()
            k = sum(1 for _ in ds.prefetch_batches(TRAIN_BATCH, shuffle=True))
            rates.append(k / (time.perf_counter() - t0))
        ds.close()
        say(f"loop loader alone: augmented batches of {TRAIN_BATCH} at "
            f"{INPUT_SIZE}^2, {ds.NUM_WORKERS} worker threads: "
            f"{rates[0]:.2f} batches/s decoding the PNGs, {rates[1]:.2f} "
            f"from the depth cache; {smi}")

        # the loop, one epoch
        cfg = loop_config(mano_path, root, os.path.join(tmp, "ckpt"))
        rec = {}
        with max_epochs(1), watched_loop(rec):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            run_dir = L.run(cfg)
            torch.cuda.synchronize()
            counts["loop"] = dict(kernels.LAUNCHES)
        steps = FAKE_TRAIN // TRAIN_BATCH
        evals = 4 * -(-FAKE_TEST // TRAIN_BATCH)    # view 0, then 3 views
        say(f"loop launches over {len(rec['steps'])} FinetuneStage steps and "
            f"{len(rec['evals'])} eval batches: {json.dumps(counts['loop'])}")
        need(len(rec["steps"]) == steps and len(rec["evals"]) == evals,
             f"the loop ran {len(rec['steps'])} steps and "
             f"{len(rec['evals'])} eval batches, not {steps} and {evals}")
        for i, d in enumerate(rec["steps"]):
            need(d == FS_STEP_LAUNCHES, f"loop step {i} did not launch every "
                 f"kernel of the path as expected: {d} != {FS_STEP_LAUNCHES}")
        for i, d in enumerate(rec["evals"]):
            need(d == EVAL_LAUNCHES, f"loop eval batch {i}: {d} != "
                 f"{EVAL_LAUNCHES}")
        losses = [float(m["loss"]) for m in rec["metrics"]]
        bad = [(i, k) for i, m in enumerate(rec["metrics"])
               for k, v in m.items() if not np.isfinite(float(v))]
        need(not bad, f"loop steps with non-finite metrics: {bad}")
        errs = torch.stack([e for e in rec["errors"]]).cpu().numpy()
        need(np.isfinite(errs).all(), "a non-finite eval error")
        log = open(os.path.join(run_dir, "train.log")).read()
        need("Epoch#0" in log and "test:" in log, "train.log lacks Epoch#0 "
             "or test:")
        for name in ("latest", "best"):
            need(os.path.exists(os.path.join(run_dir, name, ck.FILE)),
                 f"no {name} checkpoint")
        for view in range(3):
            for i in (0, 1):
                rows = np.loadtxt(os.path.join(run_dir,
                                               f"result_{i}_{view}.txt"))
                need(rows.shape == (FAKE_TEST, 63) and np.isfinite(rows).all(),
                     f"result_{i}_{view}: {rows.shape}")
            mesh = np.loadtxt(os.path.join(run_dir, f"mesh_result_3_{view}.txt"))
            need(mesh.shape[0] == FAKE_TEST, f"mesh_result_3_{view}: "
                 f"{mesh.shape}")
        starts = np.diff(rec["starts"]) * 1e3
        med = float(np.median(starts[1:]))
        epoch_s = rec["epochs"][0]
        frames = 3 * FAKE_TEST
        say(f"loop losses: {json.dumps([float(f'{x:.6g}') for x in losses])}; "
            f"eval errors mm (mean per row over the batches) "
            f"{np.round(errs.mean(axis=(0, 2)), 3).tolist()}")
        say(f"loop epoch: {steps} steps in {epoch_s:.3f} s, "
            f"{steps / epoch_s:.3f} steps/s; median step {med:.3f} ms inside "
            f"the loop (host clock between step starts, steps 2-{steps}; the "
            f"loader's batches read one step late) against phase 4's "
            f"{STEP_MEDIAN_MS['finetune_stage']:.3f} ms for the same step "
            f"without the loader; {smi}")
        say(f"loop 3-view evaluation: {frames} frames in "
            f"{rec['views_s'][-1]:.3f} s, {frames / rec['views_s'][-1]:.1f} "
            f"frames/s (batches of {TRAIN_BATCH}, the tail padded; exports "
            f"written); {smi}")

        # resume from the run directory: epoch 1, the saved state bitwise
        rec2 = {}
        with max_epochs(1), watched_loop(rec2):
            L.run(cfg.replace(add_info="resume", load_model=run_dir))
        state, epoch = rec2["restored"][0]
        need(epoch == 1 and not rec2["steps"], f"the resumed run started at "
             f"epoch {epoch} and ran {len(rec2['steps'])} steps")
        saved = torch.load(os.path.join(run_dir, "latest", ck.FILE),
                           map_location="cpu", weights_only=True)
        pairs = list(state.net.state_dict().items()) + [
            (f"optimizer.{k}", v) for k, v in state.optimizer.buffers.items()]
        ref = dict(saved["net"], **{f"optimizer.{k}": v
                                    for k, v in saved["optimizer"].items()})
        off = [k for k, v in pairs if v.device.type != "cuda"
               or not torch.equal(v.cpu(), ref[k])]
        need(not off, f"restored tensors off the card or not bitwise the "
             f"saved ones: {off[:5]}")
        say(f"loop resume: epoch {epoch}, {len(pairs)} tensors (the net and "
            f"the AdamW moments) on the card and bitwise the saved ones; "
            f"updates {int(state.updates)}")

        # a checkpoint evaluated on the card and on the CPU: the seeded
        # weights the loop starts from (saved as a checkpoint), at the
        # engine's tolerance, and the loop's best (after 8 steps its
        # eval-mode outputs leave the engine's range: printed)
        ecfg = cfg.replace(transferNet_pth="")
        batch = next(D.NYUDataset(nyu, "test", img_size=INPUT_SIZE).batches(
            TRAIN_BATCH))
        tr0 = Trainer(ecfg, mano_path, device="cpu")
        ck.save(os.path.join(tmp, "init"), tr0, tr0.init_state(), 0)
        ck.wait_until_finished()
        diffs = {}
        for name in ("init", "best"):
            path = os.path.join(tmp, "init") if name == "init" else \
                os.path.join(run_dir, "best")
            out = {}
            for dev in ("cuda", "cpu"):
                tr = Trainer(ecfg, mano_path, device=dev)
                st, _ = ck.restore(path, tr, tr.init_state())
                out[dev] = tr.eval_step_fn()(st, batch)[0].cpu().numpy()
            need(np.isfinite(out["cuda"]).all(), f"{name}: a non-finite "
                 "eval error on the card")
            diffs[name] = (np.abs(out["cuda"] - out["cpu"]).max(axis=1),
                           np.abs(out["cpu"]).max(axis=1))
        for name, (d, mag) in diffs.items():
            say(f"loop eval of view 0's first batch from the {name} "
                f"checkpoint, card vs CPU, max abs mm per row (stage 1 pixel, "
                f"MANO, stage 2 pixel, MANO): {np.round(d, 5).tolist()}; the "
                f"rows' largest error {np.round(mag, 3).tolist()} mm")
        d = diffs["init"][0]
        need(d[:2].max() <= 1e-2 and d[2:].max() <= 0.5, "the card's eval "
             f"differs from the CPU's: {d}")

        # serving the run directory, from a raw test frame
        eng = InferenceEngine.from_run_dir(run_dir)
        frame = readers.nyu_reader(os.path.join(nyu, "test",
                                                "depth_1_0000001.png"))
        pred = eng.predict_from_depth(frame)
        need(all(np.isfinite(v).all() for v in pred.values()),
             "from_run_dir + predict_from_depth: a non-finite output")

        # the guard never waits for the card; the step's other host syncs
        tr = Trainer(cfg, mano_path, device="cuda", steps_per_epoch=steps)
        state = tr.init_state()
        params = list(state.net.parameters())
        for p in params:
            p.grad = torch.randn_like(p) * 1e-3
        nan_grad = params[0].grad.clone()
        nan_grad.view(-1)[0] = float("nan")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ok = guarded_update(state)
            params[0].grad = nan_grad
            rejected = guarded_update(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        need(bool(ok) and not bool(rejected)
             and int(state.notfinite_count) == 1,
             "the guard's decisions or counters are wrong")
        batch = next(D.NYUDataset(nyu, "train", img_size=INPUT_SIZE).batches(
            TRAIN_BATCH))
        batch = L._to_device(torch.device("cuda"))(batch)
        draws = tr.draw(TRAIN_BATCH, "FinetuneStage")
        para, cube = next(random_param_source(TRAIN_BATCH, seed=SEED))
        step = tr.train_step_fn("FinetuneStage")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                step(state, draws, dict(batch, model_para=para,
                                        cube_synth=cube))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        sites = {}
        for w in caught:
            if "synchroniz" in str(w.message):
                where = f"{os.path.relpath(w.filename)}:{w.lineno}"
                sites[where] = sites.get(where, 0) + 1
        say(f"loop guard: guarded_update with a finite and a NaN gradient "
            f"under set_sync_debug_mode('error'): no synchronization "
            f"(accepted {bool(ok)}, then {bool(rejected)})")
        say(f"loop host syncs left in one FinetuneStage step "
            f"(set_sync_debug_mode('warn')): {sum(sites.values())} at "
            + json.dumps(sites))
    return counts


# ----------------------------------------------------------------- phase 7

# the other datasets' stand-ins (tests/torch_fake_sets.py): ICVL 128 train
# and 40 test frames (+ 2 test lines its loader drops), MSRA's P3 and P7
# (cubes 180 and 160) 2 gestures x 32 frames to train on, P2 (200) 2 x 20
# to test on, SHREC one sequence of 40 frames; K6 renders each in batches
# of 32 (ICVL's 170 frames in one call, MSRA's per gesture, SHREC's 40)
ICVL_TRAIN, ICVL_TEST, SHREC_FRAMES, MSRA_TEST_ID = 128, 40, 40, 2
MSRA_FRAMES = {2: (("1", "2"), 20), 3: (("1", "2"), 32), 7: (("1", "2"), 32)}
MSRA_TEST = sum(len(g) * n for p, (g, n) in MSRA_FRAMES.items()
                if p == MSRA_TEST_ID)
MSRA_TRAIN = sum(len(g) * n for g, n in MSRA_FRAMES.values()) - MSRA_TEST
# one eval batch of a one-stage net: a decode
EVAL1_LAUNCHES = launches(codec_decode=1)


def run_datasets(mano_path, smi):
    """Phase 7: the other datasets.  ICVL, MSRA and SHREC stand-ins built
    on the card (K6 at 320x240 and 640x480), K6 checked and timed on 32
    ICVL frames; the ICVL and MSRA loaders' augmented batches/s;
    ``loop.run`` at full width on ICVL (FinetuneStage) and on MSRA
    (Finetune, subject 2 left out), one epoch of 4 steps each with the
    per-epoch test and the exports, each step's and eval batch's launch
    deltas as phase 4's; one ICVL and one MSRA eval batch from the seeded
    weights on the card against the CPU; ``export_skeletons`` over the
    SHREC set on the card against the CPU's.  Returns the launch counts
    of the sets' build, the two loops and the export."""
    import torch
    from dsf_tpu_torch import kernels
    from dsf_tpu_torch.config import CAMERA
    from dsf_tpu_torch.data import datasets as D
    from dsf_tpu_torch.mano import model as mano
    from dsf_tpu_torch.render import renderer as rnd
    from dsf_tpu_torch.tools.skeleton_export import export_skeletons
    from dsf_tpu_torch.training import checkpoints as ck
    from dsf_tpu_torch.training import loop as L
    from dsf_tpu_torch.training.trainer import Trainer
    # the stand-ins' builders sit beside the tests that use them (another
    # installed package may own the name "tests")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_fake_sets as F

    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        F.make_icvl(root, mano_path, ICVL_TRAIN, ICVL_TEST, seed=SEED,
                    batch_size=TRAIN_BATCH)
        F.make_msra(root, mano_path, MSRA_FRAMES, test_id=MSRA_TEST_ID,
                    seed=SEED + 1, batch_size=TRAIN_BATCH)
        F.make_shrec(root, mano_path, SHREC_FRAMES, seed=SEED + 2,
                     batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts["sets"] = dict(kernels.LAUNCHES)
        n = ICVL_TRAIN + ICVL_TEST + 2 + MSRA_TRAIN + MSRA_TEST + SHREC_FRAMES
        k6 = -(-(ICVL_TRAIN + ICVL_TEST + 2) // TRAIN_BATCH) + sum(
            len(g) * -(-f // TRAIN_BATCH) for g, f in MSRA_FRAMES.values()) \
            + -(-SHREC_FRAMES // TRAIN_BATCH)
        say(f"datasets stand-ins built: ICVL {ICVL_TRAIN} + {ICVL_TEST} (+2 "
            f"dropped) frames of 320x240, MSRA {MSRA_TRAIN} + {MSRA_TEST} of "
            f"320x240, "
            f"SHREC {SHREC_FRAMES} of 640x480 in {secs:.3f} s, "
            f"{n / secs:.1f} frames/s (render, PNG and .bin writing, "
            f"labels); launches {json.dumps(counts['sets'])}; {smi}")
        need(counts["sets"] == launches(raster_dense=k6),
             f"the sets did not launch K6 once a batch: {counts['sets']}")

        paras, wh = CAMERA["icvl"]
        icvl_r = rnd.Renderer.create(mano.load_model(mano_path, device="cuda"),
                                     "icvl", paras, wh)
        with torch.inference_mode():
            k6 = check_raster_dense(icvl_r, TRAIN_BATCH,
                                    np.random.RandomState(SEED + 3),
                                    depth=(250, 450))
        say(f"datasets K6 at 320x240 (ICVL's camera, B={TRAIN_BATCH}): "
            f"kernel {k6['ms']:.4f} ms, route {k6['route_ms']:.4f} ms, plain "
            f"{k6['plain_ms']:.4f} ms, bound {k6['bound_ms']:.6f} ms by "
            f"{k6['bound_by']}; {smi}")

        icvl, msra = os.path.join(root, "icvl"), os.path.join(root, "msra")
        for name, make in (
                ("ICVL", lambda: D.ICVLDataset(icvl, "train",
                                               img_size=INPUT_SIZE, seed=SEED)),
                ("MSRA", lambda: D.MSRADataset(msra, "train",
                                               test_persons=MSRA_TEST_ID,
                                               img_size=INPUT_SIZE,
                                               seed=SEED))):
            ds = make()
            ds.enable_depth_cache()
            rates = []
            for _ in range(2):
                t0 = time.perf_counter()
                k = sum(1 for _ in ds.prefetch_batches(TRAIN_BATCH,
                                                       shuffle=True))
                rates.append(k / (time.perf_counter() - t0))
            ds.close()
            say(f"datasets {name} loader alone: augmented batches of "
                f"{TRAIN_BATCH} at {INPUT_SIZE}^2, {ds.NUM_WORKERS} worker "
                f"threads: {rates[0]:.2f} batches/s decoding the frames, "
                f"{rates[1]:.2f} from the depth cache; {smi}")

        runs = {"icvl": ("FinetuneStage", 2, FS_STEP_LAUNCHES, EVAL_LAUNCHES,
                         ICVL_TRAIN, ICVL_TEST, "finetune_stage"),
                "msra": ("Finetune", 1, F_STEP_LAUNCHES, EVAL1_LAUNCHES,
                         MSRA_TRAIN, MSRA_TEST, "finetune")}
        for dataset, (phase, stages, step_l, eval_l, n_train, n_test, tag) \
                in runs.items():
            cfg = loop_config(mano_path, root, os.path.join(tmp, "ckpt"),
                              dataset=dataset, stage_num=stages,
                              test_id=MSRA_TEST_ID)
            rec = {}
            with max_epochs(1), watched_loop(rec):
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                run_dir = L.run(cfg)
                torch.cuda.synchronize()
                counts[f"loop_{dataset}"] = dict(kernels.LAUNCHES)
            steps = n_train // TRAIN_BATCH
            evals = 2 * -(-n_test // TRAIN_BATCH)   # per-epoch, then final
            say(f"datasets {dataset} loop launches over {len(rec['steps'])} "
                f"{phase} steps and {len(rec['evals'])} eval batches: "
                + json.dumps(counts[f"loop_{dataset}"]))
            need(len(rec["steps"]) == steps and len(rec["evals"]) == evals,
                 f"the {dataset} loop ran {len(rec['steps'])} steps and "
                 f"{len(rec['evals'])} eval batches, not {steps} and {evals}")
            for i, d in enumerate(rec["steps"]):
                need(d == step_l, f"{dataset} loop step {i}: {d} != {step_l}")
            for i, d in enumerate(rec["evals"]):
                need(d == eval_l, f"{dataset} loop eval batch {i}: {d} != "
                     f"{eval_l}")
            bad = [(i, k) for i, m in enumerate(rec["metrics"])
                   for k, v in m.items() if not np.isfinite(float(v))]
            need(not bad, f"{dataset} loop steps with non-finite metrics: "
                 f"{bad}")
            # the eval errors of the trained weights are printed, not held:
            # after 4 steps from random weights the eval-mode outputs (the
            # running statistics lag the weights) reach 5e16 mm in one run
            # and overflow float32 in the next; the eval path's finiteness
            # and card = CPU are held on the seeded weights below
            errs = torch.stack(rec["errors"]).cpu().numpy()
            for name in ("latest", "best"):
                need(os.path.exists(os.path.join(run_dir, name, ck.FILE)),
                     f"{dataset}: no {name} checkpoint")
            for i in (0, 1):
                rows = np.loadtxt(os.path.join(run_dir, f"result_{i}_0.txt"))
                need(rows.shape == (n_test, 63), f"{dataset} result_{i}_0: "
                     f"{rows.shape}")
            need(not os.path.exists(os.path.join(run_dir, "result_0_1.txt")),
                 f"{dataset}: views past 0 evaluated")
            losses = [float(m["loss"]) for m in rec["metrics"]]
            med = float(np.median(np.diff(rec["starts"])[1:] * 1e3))
            say(f"datasets {dataset} loop: losses "
                f"{json.dumps([float(f'{x:.6g}') for x in losses])}; eval "
                f"errors mm (the trained weights, mean per row) "
                f"{np.round(errs.mean(axis=(0, 2)), 3).tolist()}, "
                f"{int((~np.isfinite(errs)).sum())} of {errs.size} not "
                f"finite; "
                f"epoch {steps} steps in {rec['epochs'][0]:.3f} s, median "
                f"step {med:.3f} ms inside the loop (steps 2-{steps}) against "
                f"phase 4's {STEP_MEDIAN_MS[tag]:.3f} ms; evaluation of "
                f"{n_test} frames in {rec['views_s'][-1]:.3f} s, "
                f"{n_test / rec['views_s'][-1]:.1f} frames/s; {smi}")

            # one test batch from the seeded weights on the card and the CPU
            ecfg = cfg.replace(transferNet_pth="")
            ds = L._test_dataset(ecfg)
            batch = next(ds.batches(TRAIN_BATCH))
            ds.close()
            out = {}
            for dev in ("cuda", "cpu"):
                tr = Trainer(ecfg, mano_path, device=dev)
                out[dev] = tr.eval_step_fn()(tr.init_state(), batch)[0]
                out[dev] = out[dev].cpu().numpy()
            d = np.abs(out["cuda"] - out["cpu"]).max(axis=1)
            say(f"datasets {dataset} eval of the test split's first batch from "
                f"the seeded weights, card vs CPU, max abs mm per row: "
                f"{np.round(d, 5).tolist()}; the rows' largest error "
                f"{np.round(np.abs(out['cpu']).max(axis=1), 3).tolist()} mm")
            need(np.isfinite(out["cuda"]).all() and d[:2].max() <= 1e-2
                 and d[2:].max(initial=0.0) <= 0.5, f"{dataset}: the card's "
                 f"eval differs from the CPU's: {d}")

        # the skeleton export over the SHREC set, card and CPU
        scfg = loop_config(mano_path, root, os.path.join(tmp, "ckpt"),
                           dataset="shrec", transferNet_pth="")
        shrec = os.path.join(root, "shrec")
        ds = D.SHRECDataset(shrec, img_size=INPUT_SIZE)
        pred = {}
        for dev in ("cuda", "cpu"):
            tr = Trainer(scfg, mano_path, device=dev)
            state = tr.init_state()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            seqs = export_skeletons(tr, state, ds, batch_size=TRAIN_BATCH,
                                    out_name=f"pred_{dev}.txt")
            torch.cuda.synchronize()
            if dev == "cuda":
                secs = time.perf_counter() - t0
                counts["export_shrec"] = dict(kernels.LAUNCHES)
            pred[dev] = np.loadtxt(os.path.join(seqs[0], f"pred_{dev}.txt"))
        ds.close()
        d = float(np.abs(pred["cuda"] - pred["cpu"]).max())
        say(f"datasets SHREC export_skeletons: {pred['cuda'].shape} rows in "
            f"{secs:.3f} s on the card ({SHREC_FRAMES / secs:.1f} frames/s); "
            f"card vs CPU max abs {d:.5f} mm; launches "
            f"{json.dumps(counts['export_shrec'])}; {smi}")
        need(pred["cuda"].shape == (SHREC_FRAMES, 63)
             and np.isfinite(pred["cuda"]).all(), "the SHREC export's rows")
        need(d <= 0.5, f"the SHREC export differs from the CPU's by {d} mm")
        need(counts["export_shrec"] == {
            k: v * -(-SHREC_FRAMES // TRAIN_BATCH)
            for k, v in EVAL_LAUNCHES.items()},
            f"the export's launches: {counts['export_shrec']}")
    return counts


# ----------------------------------------------------------------- phase 8

CYCLEGAN_STEPS = 6
CYCLEGAN_COMPARE_BATCH = 2
# one step of the CycleGAN pipeline: K1 renders the synth batch, K9 is the
# head of each of the six generator passes (fake, reconstruction and
# identity of both generators; its backward is the plain version's)
CYCLEGAN_STEP_LAUNCHES = launches(raster_skip=1, tail_conv=6)
CYCLEGAN_NETS = ("G_A", "G_B", "D_A", "D_B")
# the generators' float32 gradients at full width lie ~0.6% from float64
# (relative L2, on the CPU at 64^2; the cycle term through both
# generators: the port's CPU 2.2e-3 and the JAX package's 3.9e-3 on one
# tensor), where the narrow test nets lie 3e-6
CYCLEGAN_GRAD_TOL = 0.05
# ... and there the card's float32 lies further from float64 than the
# CPU's: a generator's median 3.33x the CPU's in the first full-width run
# (0.0049 against 0.00147; the JAX package's CPU float32 lies 1.76x the
# port's CPU on one tensor at 64^2), so the nets are held at twice phase
# 5's median ratio
CYCLEGAN_MEDIAN_RATIO = 2 * MEDIAN_RATIO


@contextlib.contextmanager
def watched_cyclegan(rec):
    """``pipelines.run_cyclegan`` with each step's launch deltas (since
    the previous step's end: the synth render, the real batch, the step),
    its host time to a synchronized ``g_loss`` and its metrics in
    ``rec``."""
    from dsf_tpu_torch import kernels
    from dsf_tpu_torch.training import cyclegan_trainer as CT
    orig = CT.CycleGANTrainer.train_step_fn
    for k in ("steps", "ms", "metrics"):
        rec.setdefault(k, [])
    last = [dict(kernels.LAUNCHES)]

    def train_step_fn(self):
        step = orig(self)

        def watched(state, synth, real):
            t0 = time.perf_counter()
            state, metrics = step(state, synth, real)
            float(metrics["g_loss"])
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            now = dict(kernels.LAUNCHES)
            rec["steps"].append({k: now[k] - last[0][k] for k in now})
            last[0] = now
            rec["metrics"].append({k: float(v) for k, v in metrics.items()})
            return state, metrics
        return watched

    CT.CycleGANTrainer.train_step_fn = train_step_fn
    try:
        yield rec
    finally:
        CT.CycleGANTrainer.train_step_fn = orig


def cyclegan_losses_and_grads(gan, state, synth, real, fakes=None):
    """One CycleGAN step's losses, both fakes and every net's gradients
    (float64, on the CPU), from ``state`` on ``synth`` and ``real``; the
    discriminators' on ``fakes`` (fake_real, fake_synth) when given, else
    on the step's own."""
    import torch
    g_loss, aux = gan._g_loss(state, synth, real)
    g = torch.autograd.grad(g_loss, state.generators())
    if fakes is None:
        fakes = aux["fake_real"], aux["fake_synth"]
    d_loss = gan._d_loss(state, synth, real, *fakes)
    d = torch.autograd.grad(d_loss, state.discriminators())
    names = [f"{k}.{n}" for k in CYCLEGAN_NETS
             for n, _ in getattr(state, k).named_parameters()]
    out = {"g_loss": float(g_loss), "d_loss": float(d_loss),
           "fake_real": aux["fake_real"].detach().double().cpu(),
           "fake_synth": aux["fake_synth"].detach().double().cpu()}
    return out, dict(zip(names, (t.detach().double().cpu() for t in (*g, *d))))


def compare_cyclegan_step(mano_path, root):
    """One CycleGAN step at full width (ngf 64, 9 blocks, PatchGAN ndf 64)
    at B=2, 128^2, on the card and on the CPU (the plain tail conv) from
    the same seeded weights and inputs (a synth render, a real crop of the
    fake NYU set), and on the CPU in float64 (the discriminators' loss and
    gradients on float64's fakes on every device): g_loss and d_loss within
    1e-4 relative, both fakes within 1e-3 max abs (cuDNN may pick other
    algorithms); each net's gradients against float64: every tensor within
    CYCLEGAN_GRAD_TOL relative L2, the card's median over the net within
    CYCLEGAN_MEDIAN_RATIO x the CPU's.  The bias of a conv feeding an
    instance norm has a zero
    gradient (float64's within 1e-9 of its weight's): both devices' within
    1e-4 of the weight gradient's norm (2.2e-6 on the CPU at 64^2)."""
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.data import datasets as D
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.mano import model as mano
    from dsf_tpu_torch.render import renderer as rnd
    from dsf_tpu_torch.training.cyclegan_trainer import CycleGANTrainer
    from dsf_tpu_torch.training.pipelines import synth_batch

    Bc = CYCLEGAN_COMPARE_BATCH
    r = rnd.Renderer.create(mano.load_model(mano_path, device="cuda"), "nyu",
                            demo.PARAS, (640, 480), (INPUT_SIZE, INPUT_SIZE))
    para, cube = next(random_param_source(Bc, seed=SEED + 81))
    synth = synth_batch(r, torch.Generator().manual_seed(SEED + 82), para,
                        cube).cpu()
    ds = D.NYUDataset(os.path.join(root, "nyu"), "train",
                      img_size=INPUT_SIZE)
    real = torch.from_numpy(next(ds.batches(Bc, shuffle=True,
                                            seed=SEED + 83))["img"])
    ds.close()
    runs = {}
    for label, dev, dt in (("cpu64", "cpu", torch.float64),
                           ("card", "cuda", torch.float32),
                           ("cpu", "cpu", torch.float32)):
        gan = CycleGANTrainer(device=dev)
        state = gan.init_state(torch.Generator().manual_seed(SEED + 80))
        for k in CYCLEGAN_NETS:
            getattr(state, k).to(dt)
        # the discriminators' inputs: float64's fakes, so that their
        # gradients measure their own arithmetic (each device's fakes lie
        # 1e-5 apart, and D's gradients follow their leaky ReLUs' kinks)
        fakes = None if dt == torch.float64 else tuple(
            runs["cpu64"][0][k].to(dev, dt) for k in ("fake_real",
                                                      "fake_synth"))
        runs[label] = cyclegan_losses_and_grads(
            gan, state, synth.to(dev, dt), real.to(dev, dt), fakes)
    (card, g_card), (cpu, g_cpu), (c64, g_64) = (runs[k] for k in
                                                  ("card", "cpu", "cpu64"))
    for k in ("g_loss", "d_loss"):
        say(f"cyclegan compare B={Bc} {INPUT_SIZE}^2 {k}: card {card[k]:.7g} "
            f"CPU {cpu[k]:.7g} CPU float64 {c64[k]:.10g}")
        need(np.isfinite(card[k]) and abs(card[k] - cpu[k]) <= 1e-4 * abs(
            cpu[k]), f"cyclegan {k}: card {card[k]} against CPU {cpu[k]}")
    for k in ("fake_real", "fake_synth"):
        d = float((card[k] - cpu[k]).abs().max())
        say(f"cyclegan compare {k}: card vs CPU max abs {d:.3g}, CPU vs "
            f"float64 {float((cpu[k] - c64[k]).abs().max()):.3g}")
        need(d <= 1e-3, f"cyclegan {k}: card vs CPU max abs {d}")
    rel = lambda a, b: float((a - b).norm() / (b.norm() + 1e-300))
    for net in CYCLEGAN_NETS:
        names = [n for n in g_64 if n.startswith(net + ".")]
        noise = [n for n in names if n.endswith(".bias") and float(
            g_64[n].norm()) <= 1e-9 * float(
                g_64[n[:-len("bias")] + "weight"].norm())]
        worst = 0.0
        for n in noise:
            scale = float(g_64[n[:-len("bias")] + "weight"].norm())
            worst = max(worst, float(g_card[n].norm()) / scale,
                        float(g_cpu[n].norm()) / scale)
        need(worst <= 1e-4, f"cyclegan {net}: a bias before an instance "
             f"norm has a gradient {worst:.3g} of its weight's")
        card_64 = {n: rel(g_card[n], g_64[n]) for n in names
                   if n not in noise}
        cpu_64 = {n: rel(g_cpu[n], g_64[n]) for n in names if n not in noise}
        card_cpu = {n: rel(g_card[n], g_cpu[n]) for n in card_64}
        med = (float(np.median(list(card_64.values()))),
               float(np.median(list(cpu_64.values()))))
        say(f"cyclegan compare {net} gradients ({len(card_64)} tensors, "
            f"{len(noise)} biases before an instance norm at "
            f"{worst:.3g} of their weight's): relative L2 card vs CPU max "
            f"{max(card_cpu.values()):.3g}; card vs float64 median "
            f"{med[0]:.3g}, max {max(card_64.values()):.3g} "
            f"({max(card_64, key=card_64.get)}); CPU vs float64 median "
            f"{med[1]:.3g}, max {max(cpu_64.values()):.3g}")
        bad = {n: v for n, v in card_64.items() if v > CYCLEGAN_GRAD_TOL}
        need(not bad, f"cyclegan {net} card gradients differ from float64: "
             f"{bad}")
        need(med[0] <= CYCLEGAN_MEDIAN_RATIO * med[1], f"cyclegan {net} card "
             f"gradients lie {med[0] / med[1]:.3g} times further from "
             "float64 than the CPU's, in the median")


def run_cyclegan_phase(mano_path, smi, root):
    """Phase 8: ``pipelines.run_cyclegan`` at full width on phase 6's fake
    NYU set (B=32, 128^2, CYCLEGAN_STEPS steps): each step's launch deltas
    (K1 x1, K9 x6), finite metrics, the median step time of the last 5
    and the peak memory; the export read back by ``load_transfer_net``
    (bitwise G_A) and one FinetuneStage step of the port's trainer with it
    (phase 4's launches, K9 among them); then ``compare_cyclegan_step``.
    Returns the launch counts of the pipeline and of that step."""
    import torch
    from dsf_tpu_torch import demo, kernels
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.training import pipelines
    from dsf_tpu_torch.training.trainer import Trainer, load_transfer_net

    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(dataset="nyu", batch_size=TRAIN_BATCH,
                     input_size=INPUT_SIZE, root_dir=root, seed=SEED,
                     mano_model_path=mano_path,
                     save_dir=os.path.join(tmp, "ckpt"))
        rec = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with watched_cyclegan(rec):
            t0 = time.perf_counter()
            out, state = pipelines.run_cyclegan(cfg, steps=CYCLEGAN_STEPS)
            secs = time.perf_counter() - t0
        counts["cyclegan"] = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        need(len(rec["steps"]) == CYCLEGAN_STEPS and state.step ==
             CYCLEGAN_STEPS, f"run_cyclegan ran {len(rec['steps'])} steps")
        for i, d in enumerate(rec["steps"]):
            need(d == CYCLEGAN_STEP_LAUNCHES, f"cyclegan step {i} did not "
                 f"launch every kernel of the path as expected: {d} != "
                 f"{CYCLEGAN_STEP_LAUNCHES}")
        bad = [(i, k) for i, m in enumerate(rec["metrics"])
               for k, v in m.items() if not np.isfinite(v)]
        need(not bad, f"cyclegan steps with non-finite metrics: {bad}")
        med = float(np.median(rec["ms"][-5:]))
        say(f"cyclegan launches over {CYCLEGAN_STEPS} steps (B={TRAIN_BATCH} "
            f"synth + {TRAIN_BATCH} real, {INPUT_SIZE}^2, ngf 64, 9 blocks, "
            f"float32): {json.dumps(counts['cyclegan'])}")
        say("cyclegan losses (g_loss, d_loss): " + json.dumps(
            [[float(f"{m['g_loss']:.6g}"), float(f"{m['d_loss']:.6g}")]
             for m in rec["metrics"]]) + "; first step " + json.dumps(
            {k: float(f"{v:.5g}") for k, v in rec["metrics"][0].items()}))
        say(f"cyclegan step ms (host clock, to a synchronized g_loss): "
            + json.dumps([round(t, 3) for t in rec["ms"]])
            + f"; median of the last 5 {med:.3f} ms, "
            f"{2 * TRAIN_BATCH * 1e3 / med:.1f} images/s (B synth + B real "
            f"a step); the run with its set-up and export {secs:.3f} s; "
            f"{smi}")
        say(f"cyclegan peak device memory {peak:.1f} MiB")

        # the export as the training steps' transfer net
        gen = load_transfer_net(out, "cuda")
        same = all(torch.equal(a, b) for a, b in zip(
            state.G_A.state_dict().values(), gen.state_dict().values()))
        need(same, "the exported transfer_G_A.npz is not G_A bitwise")
        tr = Trainer(Config(dataset="nyu", batch_size=TRAIN_BATCH,
                            input_size=INPUT_SIZE, seed=SEED,
                            mano_model_path=mano_path, transferNet_pth=out),
                     mano_path, device="cuda")
        fs = tr.train_step_fn("FinetuneStage")
        para, cube = next(random_param_source(TRAIN_BATCH, seed=SEED + 84))
        batch = dict(demo.real_batch(tr.renderer, TRAIN_BATCH,
                                     np.random.RandomState(SEED + 85)),
                     model_para=para, cube_synth=cube)
        st = tr.init_state()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        st, m = fs(st, tr.draw(TRAIN_BATCH, "FinetuneStage"), batch)
        loss = float(m["loss"])
        counts["cyclegan_finetune"] = dict(kernels.LAUNCHES)
        need(counts["cyclegan_finetune"] == FS_STEP_LAUNCHES,
             f"the FinetuneStage step with the exported generator: "
             f"{counts['cyclegan_finetune']} != {FS_STEP_LAUNCHES}")
        need(np.isfinite(loss), f"the FinetuneStage step with the exported "
             f"generator: loss {loss}")
        say(f"cyclegan export {os.path.basename(out)} read by "
            f"load_transfer_net (G_A bitwise); one FinetuneStage step with "
            f"it as the transfer net: loss {loss:.6g}, launches "
            f"{json.dumps(counts['cyclegan_finetune'])}")
    compare_cyclegan_step(mano_path, root)
    return counts

# ----------------------------------------------------------------- phase 9

PAR_STEPS = 2                   # steps of each phase in (a), (b), (c), (e)
PAR_RANKS = 2
PAR_TIMEOUT = 420               # seconds for a world of ranks
PAR_PHASES = ("FinetuneStage", "Pretrain")
# the parameters whose gradients feed the losses only (grad_tol's heads)
HEADS = ("mano_regress", "finals_s2")
# Limits of ``par_distances``' readings: the loss's relative distance,
# the heads' largest gradient relative L2, the trunks' median and largest
# and least cosine, the running statistics' largest distance over scale
# in stage 1 and 2.  Readings below: NVIDIA H100 80GB HBM3 at 700 W.
# Two runs of one split of the batch, phase 5's float32 tolerances
# (grad_tol): (a)'s world 1 against the one-device step (trunks median
# 0.02-0.08, largest 0.12, heads up to 7.7e-4, statistics 4e-7 / 1.6e-4)
# and (c) against (b) (heads up to 5.0e-3).
PAR_SAME_SPLIT = dict(loss=1e-4, heads=1e-2, trunk_max=0.2, stats1=1e-3,
                      stats2=5e-2)
# (b) against world 1 rendering its synth batch in the ranks' stripes: as
# PAR_SAME_SPLIT (measured trunks median 0.03-0.09, largest 0.13, loss
# up to 8.4e-6, statistics 6.4e-7 / 1.7e-4), but the heads 5e-2: the
# losses' own renders inside the step still take 16 rows on a rank and 32
# in world 1 (FinetuneStage heads 5.1e-3, then 1.01e-2 on the second
# step, where the whole render's lie 0.019-0.034 apart).
PAR_STRIPED = dict(PAR_SAME_SPLIT, heads=5e-2)
# (a) in bfloat16 (FinetuneStage bitwise; Pretrain: loss 1.2e-4, heads
# 4.4e-3, trunks median 0.68 and least cosine 0.56, statistics 3.7e-4 /
# 2.8e-3): bfloat16 rounding of the trunks at random weights (phase 5),
# so their cosine, which a zeroed or flipped gradient fails.
PAR_BF16 = dict(loss=1e-3, heads=5e-2, trunk_cos=0.25, stats1=5e-3,
                stats2=5e-2)
# (b), (e): two ranks of 16 rows against world 1 rendering all 32.  A
# row's synth render rounds by the batch it is rendered in (joints 1e-6
# mm apart, 0.003-0.008% of the pixels moved by more than 1e-3 at edges),
# and the trunks' gradients at random weights are ill-conditioned in
# those pixels: world 1 rendering in two stripes, with no collective,
# lies as far from world 1 (trunks median 0.35 FinetuneStage / 0.59
# Pretrain, least cosine 0.85 / 0.65, statistics 3.6e-4 / 1.6e-3 in
# stage 1 and 1.9e-3 / 4.9e-3 in stage 2, heads 2.6e-3 / 5.0e-3, loss
# 1.9e-5 / 2.3e-4) as the ranks do; the second step lies nearer (trunks
# median 0.14-0.18, heads up to 0.034).  The control, BatchNorm on each
# rank's own rows: trunks median 1.04-1.12, least cosine 0.03-0.09,
# statistics 2.3e-2-2.5e-2 and 3.4e-2-3.8e-2; its loss (3.9e-4, 5.4e-4)
# and heads (9e-3, 1.2e-2) lie among the sound readings, so those two
# limits are sanity bounds only.  Each limit of PAR_CAUGHT lies between.
PAR_SPLIT = dict(loss=1e-3, heads=5e-2, trunk_median=0.8, trunk_cos=0.3,
                 stats1=5e-3, stats2=1.5e-2)
# (b) with cuDNN off on both sides (every convolution outside cuDNN): the
# gap stays as it is (not cuDNN's algorithms by batch)
PAR_SPLIT_NO_CUDNN = PAR_SPLIT
# the readings by which BatchNorm on each rank's own rows (the control)
# must break PAR_SPLIT
PAR_CAUGHT = ("trunk_median", "trunk_cos", "stats1", "stats2")
# the share of a rank's synth render's pixels that may differ from its rows
# of world 1's render made in the ranks' stripes (0 measured)
PAR_RENDER = 1e-3


def par_names(net):
    """(name, numel) of the net's parameters in the optimizer's order."""
    return [(n, p.numel()) for n, p in net.named_parameters()]


def par_split(flat, names):
    import torch
    flat = torch.as_tensor(flat)
    return dict(zip([n for n, _ in names],
                    flat.split([k for _, k in names])))


def par_steps(mano_path, mesh, dtype, phase, steps, device, out_dir=None,
              carry=None, local_bn=False, cudnn=True, witness=False,
              render_parts=1, deterministic=True, moments=False):
    """``steps`` steps of ``phase`` (Pretrain or FinetuneStage) at the
    global B=TRAIN_BATCH from the seeded weights, draws and batches, on
    this process's stripe (``mesh``); per step the global loss, the flat
    gradient of this process's rows, the running statistics, the launch
    deltas and the step ms.  ``out_dir``: save the state after each step
    but the last; ``carry(k)``: a saved state to load before step k > 0
    (the other side's, so that Adam's sign steps do not part the runs).
    ``local_bn``: BatchNorm on this rank's own rows (the control that
    phase 9's limits must catch); ``cudnn`` False: every convolution
    outside cuDNN; ``witness``: the first step's record also holds the
    synth batch's render and joints, rendered apart from the step;
    ``render_parts``: the synth batch rendered in that many row stripes
    (``par_split_render``).  ``deterministic``: the steps run under
    ``deterministic_algorithms`` (the second step of a run is compared
    with another side's second step, each started from the state the
    ranks' first step left: with the defaults that state, and so the
    comparison, differs from run to run).  ``moments``: each record also
    holds the digests of the gathered AdamW moments after its step.
    Under ``n_fsdp`` 2 (ZeRO-3) a record's gradient is the ranks' mean
    the optimizer read, and every record holds this rank's parameter
    bytes (``fsdp.param_bytes``) and optimizer bytes after its step."""
    import torch
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.parallel import fsdp
    from dsf_tpu_torch.training.trainer import Trainer
    B = TRAIN_BATCH
    stages = 2
    tr = Trainer(train_config(mano_path, stages, SEED, dtype), mano_path,
                 device=device, mesh=mesh)
    state = tr.init_state()
    if local_bn:
        state.net.sync = None
    src = random_param_source(B, seed=SEED + 5)
    rng = np.random.RandomState(SEED + 6)
    step = tr.train_step_fn(phase)
    recs = []
    was = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn
    try:
        with par_split_render(render_parts), (
                deterministic_algorithms() if deterministic
                else contextlib.nullcontext()):
            for k in range(steps):
                state, rec = _par_step(tr, state, step, phase, src, rng, k,
                                       carry, witness and k == 0, moments)
                recs.append(rec)
                if out_dir is None or k + 1 == steps:
                    continue
                # collectives under n_fsdp 2: every rank takes them
                sd = {"net": fsdp.state_dict(state.net),
                      "optimizer": state.optimizer.state_dict()}
                if tr.mesh.rank == 0:
                    torch.save(sd, os.path.join(out_dir,
                                                f"{phase}_{k + 1}.pt"))
    finally:
        torch.backends.cudnn.enabled = was
    return recs, par_names(state.net)


@contextlib.contextmanager
def par_split_render(parts):
    """Inside, the steps render their synth batch in ``parts`` row
    stripes, as ``parts`` ranks each render their own (a row's render
    depends at rounding on the batch it is rendered in, and the raster
    turns that into other pixels)."""
    import torch
    from dsf_tpu_torch.parallel.mesh import Mesh
    from dsf_tpu_torch.training import phases
    saved = phases.pretrain_sample, phases.finetune_stage_sample
    meshes = [Mesh(world=parts, rank=i) for i in range(parts)]

    def split(fn):
        def sample(r, draws, para, cube):
            outs = [fn(r, draws.stripe(m), m.stripe(para), m.stripe(cube))
                    for m in meshes]
            return tuple(torch.cat(t) for t in zip(*outs))
        return sample

    if parts > 1:
        phases.pretrain_sample, phases.finetune_stage_sample = map(split,
                                                                   saved)
    try:
        yield
    finally:
        phases.pretrain_sample, phases.finetune_stage_sample = saved


def _par_step(tr, state, step, phase, src, rng, k, carry, witness,
              moments=False):
    """Step k of ``par_steps`` -> (state, its record)."""
    import torch
    from dsf_tpu_torch import demo, kernels
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.parallel import fsdp
    from dsf_tpu_torch.training import phases
    B = TRAIN_BATCH
    batch = dict(zip(("model_para", "cube_synth"), next(src)))
    if phase != "Pretrain":
        batch.update(demo.real_batch(tr.renderer, B, rng))
    batch = {key: tr.mesh.stripe(v) for key, v in batch.items()}
    draws = tr.draw(B, phase)
    if carry is not None and k > 0:
        saved = torch.load(carry(k), map_location=tr.device,
                           weights_only=True)
        fsdp.load_state_dict(state.net, saved["net"])
        state.optimizer.load_state_dict(saved["optimizer"])
    seen = {}
    if witness:
        sample = (phases.pretrain_sample if phase == "Pretrain"
                  else phases.finetune_stage_sample)
        with torch.no_grad(), exact_float32():
            smp = sample(tr.renderer, draws.to(tr.device), *[
                torch.as_tensor(np.asarray(batch[key], np.float32),
                                device=tr.device)
                for key in ("model_para", "cube_synth")])
        seen = dict(render=smp[0].cpu(), joints=smp[3].cpu())
    torch.cuda.synchronize(tr.device)
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    state, m = step(state, draws, batch)
    loss = float(tr.global_metrics(m)["loss"])
    torch.cuda.synchronize(tr.device)
    ms = (time.perf_counter() - t0) * 1e3
    launched = {n: kernels.LAUNCHES[n] - before[n] for n in KERNELS}
    net, opt = state.net, state.optimizer
    sharded = fsdp.sharded(net)
    if sharded is None:
        grad = torch.cat([p.grad.reshape(-1) for p in net.parameters()])
    else:
        grad = sharded.whole_flat(sharded.grad)
    sd = fsdp.state_dict(net)
    rec = dict(
        seen, loss=loss, ms=ms, launches=launched, grad=grad.float().cpu(),
        stats={n: b.detach().cpu().clone()
               for n, b in net.named_buffers() if "running" in n},
        params=torch.cat([sd[n].reshape(-1)
                          for n, _ in net.named_parameters()]),
        param_bytes=fsdp.param_bytes(net),
        opt_bytes=sum(b.untyped_storage().nbytes()
                      for b in opt.buffers.values()))
    if moments:
        rec["moments"] = {k: digest(v) for k, v in opt.state_dict().items()
                          if torch.is_tensor(v) and v.dim() == 1}
    return state, rec


def digest(t):
    """A tensor's shape and bytes, hashed (bitwise equality of the
    gathered moments without carrying them)."""
    import hashlib
    a = t.detach().cpu().contiguous().numpy()
    return f"{a.shape}:{hashlib.sha1(a.tobytes()).hexdigest()}"


def par_expected(phase, dtype):
    counts = STEP_LAUNCHES if phase == "Pretrain" else FS_STEP_LAUNCHES
    return counts if dtype == "float32" else bf16_launches(counts)


def par_allreduce_ms(numel, group, device, iters=5):
    """The flat gradient's all-reduce over ``group``: median ms on the host
    clock, from the call to the card's synchronize (gloo returns when its
    host-staged reduction is done, NCCL when it is queued)."""
    import torch
    import torch.distributed as dist
    g = torch.ones(numel, device=device)
    dist.all_reduce(g, group=group)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        dist.all_reduce(g, group=group)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def free_port():
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def par_bn_stack(mesh, device):
    """Two conv+BN+ReLU layers (1 -> 8 -> 16 channels, 24^2) in train mode
    without TF32, one group and two of 8 rows each (group-major, each rank
    its stripe of every group; world 1 with ``mesh`` None) from seeded
    weights: by group count, the output, the running statistics and the
    gradients of sum(y * r) (this process's share), as
    tests/test_torch_parallel.py holds them on the CPU."""
    from dsf_tpu_torch.device import exact_float32
    with exact_float32():
        return {g: _par_bn_stack(mesh, device, g) for g in (1, 2)}


def _par_bn_stack(mesh, device, g):
    import torch
    from dsf_tpu_torch.models import layers as TL
    rng = np.random.RandomState(SEED + 70 + g)
    f = lambda *sh: torch.from_numpy(rng.randn(*sh).astype(np.float32))
    x = torch.cat([f(8, 1, 24, 24) * (1 + i) + 2 * i for i in range(g)])
    r = f(8 * g, 16, 24, 24)
    net = torch.nn.Sequential(TL.ConvBNRelu(1, 8), TL.ConvBNRelu(8, 16))
    with torch.no_grad():
        for layer in net:
            layer[0].weight.copy_(f(*layer[0].weight.shape) * 0.3)
    net = net.to(device)
    for m in net.modules():
        if isinstance(m, TL.BatchNorm2d):
            m.groups, m.sync = g, mesh
    if mesh is not None:
        x, r = (torch.cat([mesh.stripe(h) for h in t.chunk(g)])
                for t in (x, r))
    y = net(x.to(device))
    (y * r.to(device)).sum().backward()
    return dict(y=y.detach().cpu(), stats=[
        t.detach().cpu().clone() for layer in net
        for t in (layer[1].running_mean, layer[1].running_var)],
        grads={n: p.grad.cpu() for n, p in net.named_parameters()})


def par_fsdp_same_grads(dp, fsdp, names, grads, device):
    """The guarded AdamW of data parallelism (``dp``) and of ``n_fsdp=2``
    (``fsdp``) from the same seeded weights, fed this rank's gradients of
    (b)'s steps: whether the parameters after each update and the
    gathered moments are bitwise the same (the exchange's collectives on
    the card: reduce-scatter and all-gather against one all-reduce; the
    steps themselves are not repeatable on the card, so this isolates
    them)."""
    import torch
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.parallel import fsdp as Z
    from dsf_tpu_torch.training.trainer import make_optimizer
    gen = torch.Generator().manual_seed(SEED + 80)
    w = [torch.randn(k, generator=gen) for _, k in names]
    sides = []
    for mesh in (dp, fsdp):
        module = torch.nn.ParameterList([torch.nn.Parameter(t) for t in w])
        # n_fsdp 2: the parameters sharded too, the list one unit
        held = (Z.shard(module, mesh, device) if mesh.n_fsdp > 1
                else list(module.to(device)))
        sides.append((module, make_optimizer(Config(), held, 1000, mesh)))
    same = []
    for g in grads:
        for module, opt in sides:
            for p, x in zip(module, g.split([k for _, k in names])):
                p.grad = x.to(device)
            opt.step()
        a, b = (Z.state_dict(module) for module, _ in sides)
        same.append(all(torch.equal(a[k], b[k]) for k in a))
    sd = [opt.state_dict() for _, opt in sides]
    same.append(all(torch.equal(sd[0][k], sd[1][k]) for k in ("mu", "nu")))
    return same


def parallel_rank(out_dir):
    """One rank of phase 9's worlds (``chip_smoke.py --phase9-rank DIR``,
    started by ``run_parallel`` with torchrun's environment; ``PAR_BACKEND``
    gloo puts every rank on cuda:0, nccl rank r on cuda:r): PAR_STEPS
    FinetuneStage and Pretrain steps with data parallelism, one step of
    each with rank-local BatchNorm (the control) and one with cuDNN off
    (the witness), then the FinetuneStage steps again with ``n_fsdp=2``
    (ZeRO-3) from the same seeded weights and inputs; with ``PAR_MODE``
    "memory" ``par_memory`` alone.  Its records go to
    ``out_dir/rank{r}.pt``."""
    import torch
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.parallel import distributed
    from dsf_tpu_torch.parallel.mesh import make_mesh
    backend = os.environ["PAR_BACKEND"]
    local = 0 if backend == "gloo" else int(os.environ["LOCAL_RANK"])
    device = distributed.initialize(f"cuda:{local}", backend=backend)
    path = os.environ["PAR_MANO"]
    out = {"device": str(device), "backend": backend}
    if os.environ.get("PAR_MODE") == "memory":
        with exact_float32():
            out["memory"] = par_memory(path, device)
        return _par_rank_done(out, out_dir)
    with exact_float32():
        mesh = make_mesh()
        for phase in PAR_PHASES:
            out[phase], names = par_steps(
                path, mesh, "float32", phase, PAR_STEPS, device,
                out_dir=out_dir, witness=True,
                moments=phase == "FinetuneStage")
            out[f"{phase} local_bn"], _ = par_steps(
                path, mesh, "float32", phase, 1, device, local_bn=True,
                deterministic=False)
            out[f"{phase} no_cudnn"], _ = par_steps(
                path, mesh, "float32", phase, 1, device, cudnn=False,
                deterministic=False)
        out["bn"] = par_bn_stack(mesh, device)
        n = sum(k for _, k in names)
        out["allreduce_ms"] = par_allreduce_ms(n, mesh.group, device)
        out["numel"] = n
        fsdp = make_mesh(2)
        out["fsdp_same"] = par_fsdp_same_grads(
            mesh, fsdp, names, [r["grad"] for r in out["FinetuneStage"]],
            device)
        out["fsdp"], _ = par_steps(path, fsdp, "float32", "FinetuneStage",
                                   PAR_STEPS, device, moments=True)
    return _par_rank_done(out, out_dir)


def _par_rank_done(out, out_dir):
    import torch
    from dsf_tpu_torch.parallel import distributed
    torch.save(out, os.path.join(out_dir, f"rank{distributed.rank()}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


PAR_MEMORY_NET = "ResNet_stage_152"
PAR_MEMORY_STEPS = 2


def par_memory(mano_path, device):
    """ZeRO-3's memory at depth 152 (139.0 M parameters): one float32
    FinetuneStage run of PAR_MEMORY_STEPS steps at the global B=32 (16
    rows this rank) with ``n_fsdp`` 1 and then 2, with the card's default
    algorithms.  Per run: this rank's parameter and optimizer bytes after
    init_state and after each step, ``max_memory_allocated`` over the
    steps (the peak reset after init_state), and each step's ms (host
    clock to a synchronized loss; the first step chooses cuDNN's
    algorithms)."""
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.parallel import fsdp
    from dsf_tpu_torch.parallel.mesh import make_mesh
    from dsf_tpu_torch.training.trainer import Trainer
    out = {}
    for n_fsdp in (1, 2):
        mesh = make_mesh(n_fsdp)
        tr = Trainer(train_config(mano_path, 2, SEED, "float32",
                                  PAR_MEMORY_NET), mano_path, device=device,
                     mesh=mesh)
        state = tr.init_state()
        opt = state.optimizer
        resident = lambda: (fsdp.param_bytes(state.net), sum(
            b.untyped_storage().nbytes() for b in opt.buffers.values()))
        rec = dict(rest=[resident()], ms=[], loss=[])
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        src = random_param_source(TRAIN_BATCH, seed=SEED + 5)
        rng = np.random.RandomState(SEED + 6)
        step = tr.train_step_fn("FinetuneStage")
        for _ in range(PAR_MEMORY_STEPS):
            batch = dict(zip(("model_para", "cube_synth"), next(src)))
            batch.update(demo.real_batch(tr.renderer, TRAIN_BATCH, rng))
            batch = {k: mesh.stripe(v) for k, v in batch.items()}
            draws = tr.draw(TRAIN_BATCH, "FinetuneStage")
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, m = step(state, draws, batch)
            rec["loss"].append(float(tr.global_metrics(m)["loss"]))
            torch.cuda.synchronize(device)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["rest"].append(resident())
        rec["peak"] = torch.cuda.max_memory_allocated(device)
        rec["numel"] = opt.numel
        out[n_fsdp] = rec
        del tr, state, opt, step
        torch.cuda.empty_cache()
    return out


def par_world(backend, mano_path, out_dir, mode="steps"):
    """Start PAR_RANKS ranks of this script (``parallel_rank``; ``mode``
    "memory": ``par_memory`` alone) and return their records; a rank that
    fails or passes PAR_TIMEOUT fails the phase (every rank is killed
    first)."""
    import torch
    port = free_port()
    procs = []
    for r in range(PAR_RANKS):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(PAR_RANKS), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), PAR_BACKEND=backend,
                   PAR_MANO=mano_path, PAR_MODE=mode)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase9-rank",
             out_dir], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=PAR_TIMEOUT)[0].decode(
            errors="replace") for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise SmokeFailure(f"parallel ({backend}): the ranks passed "
                           f"{PAR_TIMEOUT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        need(p.returncode == 0, f"parallel ({backend}) rank {r} failed "
             f"({p.returncode}):\n{log[-4000:]}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(PAR_RANKS)]


def par_distances(got, ref, names):
    """``par_hold``'s readings of a step (``got``: its global loss, flat
    gradient and running statistics) against ``ref``'s: the loss's
    relative distance; each parameter's gradient's relative L2, as the
    heads' largest and the trunks' median and largest, and the trunks'
    least cosine; the running statistics' largest distance over each
    tensor's largest entry, in stage 1 and in stage 2."""
    import torch
    g, r = par_split(got["grad"], names), par_split(ref["grad"], names)
    errs = rel_l2(g, {n: v.double() for n, v in r.items()})
    trunks = [n for n in errs if not n.startswith(HEADS)]
    cos = [float(torch.nn.functional.cosine_similarity(
        g[n].double(), r[n].double(), dim=0)) for n in trunks
        if float(r[n].norm()) > 0]
    st = {True: 0.0, False: 0.0}
    for n, v in ref["stats"].items():
        d = float((got["stats"][n] - v).abs().max() / v.abs().max())
        s2 = "_s2" in n or n.startswith("fusion")
        st[s2] = max(st[s2], d)
    t = [errs[n] for n in trunks]
    return dict(loss=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                heads=max(e for n, e in errs.items() if n.startswith(HEADS)),
                trunk_median=float(np.median(t)), trunk_max=max(t),
                trunk_cos=min(cos), stats1=st[False], stats2=st[True])


def par_breaches(d, limits):
    """The readings of ``d`` outside ``limits`` (a least for trunk_cos, a
    most for the others)."""
    return {k: d[k] for k, lim in limits.items()
            if (d[k] < lim if k == "trunk_cos" else d[k] > lim)}


def par_hold(tag, got, ref, names, limits):
    """Print ``got``'s readings against ``ref`` (``par_distances``) and
    fail on any outside ``limits``."""
    d = par_distances(got, ref, names)
    say(f"{tag}: loss {got['loss']:.7g} vs {ref['loss']:.7g}; readings "
        + json.dumps({k: float(f"{v:.4g}") for k, v in d.items()})
        + " (limits " + json.dumps(limits) + ")")
    bad = par_breaches(d, limits)
    need(not bad, f"{tag}: outside the limits: {bad}")
    return d


def par_mean(ranks, key, k):
    """Step k of the ranks' records ``key``, with the ranks' mean
    gradient (the global one)."""
    return dict(ranks[0][key][k], grad=sum(
        rk[key][k]["grad"] for rk in ranks) / len(ranks))


def par_check_world(tag, ranks, plain, names):
    """A world of ranks (b, e) against world 1 (``plain``): each step's
    readings within PAR_SPLIT, each rank's launches per step phase 4's,
    the ranks' parameters after the steps equal; the step with cuDNN off
    within PAR_SPLIT_NO_CUDNN of world 1's with cuDNN off; the step with
    rank-local BatchNorm outside PAR_SPLIT by each of PAR_CAUGHT; the
    conv+BN stack (``par_bn_stack``) within 1e-5 of world 1's."""
    import torch
    for phase in PAR_PHASES:
        for k, ref in enumerate(plain[phase]):
            for r, rk in enumerate(ranks):
                rec = rk[phase][k]
                need(rec["launches"] == par_expected(phase, "float32"),
                     f"{tag} rank {r} {phase} step {k}: launches "
                     f"{rec['launches']}")
            par_hold(f"{tag} {phase} step {k}", par_mean(ranks, phase, k),
                     ref, names, PAR_SPLIT)
            par_hold(f"{tag} {phase} step {k} against world 1 rendering its "
                     "synth batch in the ranks' stripes",
                     par_mean(ranks, phase, k),
                     plain[f"{phase} split_render"][k], names, PAR_STRIPED)
        for rk in ranks[1:]:
            need(torch.equal(rk[phase][-1]["params"],
                             ranks[0][phase][-1]["params"]),
                 f"{tag}: the ranks' {phase} parameters differ")
        whole, split = plain[phase][0], plain[f"{phase} split_render"][0]
        d = par_distances(split, whole, names)
        say(f"{tag} {phase} step 0, the witness: world 1 rendering its synth "
            f"batch in {len(ranks)} stripes against world 1 rendering it "
            "whole (one process, no collective): readings " + json.dumps(
                {k: float(f"{v:.4g}") for k, v in d.items()}))
        for r, rk in enumerate(ranks):
            rows = slice(r * TRAIN_BATCH // len(ranks),
                         (r + 1) * TRAIN_BATCH // len(ranks))
            img = rk[phase][0]["render"]
            gap = (img - whole["render"][rows]).abs()
            same = float((img != split["render"][rows]).float().mean())
            say(f"{tag} {phase} step 0 rank {r}: its synth render of "
                f"{img.shape[0]} rows against its rows of world 1's whole "
                f"render: {100 * float((gap > 0).float().mean()):.4g}% of "
                f"the pixels differ, {100 * float((gap > 1e-3).float().mean()):.4g}"
                f"% by more than 1e-3 (largest {float(gap.max()):.4g}), "
                "joints " + f"{float((rk[phase][0]['joints'] - whole['joints'][rows]).abs().max()):.4g}"
                f" mm apart; against world 1's striped render: "
                f"{100 * same:.4g}% differ")
            need(same <= PAR_RENDER, f"{tag} {phase} rank {r}: the synth "
                 f"render differs from world 1's striped one on {same:.3g} "
                 "of its pixels")
        par_hold(f"{tag} {phase} step 0, cuDNN off on both sides",
                 par_mean(ranks, f"{phase} no_cudnn", 0),
                 plain[f"{phase} no_cudnn"][0], names, PAR_SPLIT_NO_CUDNN)
        d = par_distances(par_mean(ranks, f"{phase} local_bn", 0),
                          plain[phase][0], names)
        caught = par_breaches(d, {k: PAR_SPLIT[k] for k in PAR_CAUGHT})
        say(f"{tag} {phase} step 0 with rank-local BatchNorm (the "
            "control): readings " + json.dumps(
                {k: float(f"{v:.4g}") for k, v in d.items()})
            + f"; outside PAR_SPLIT by {sorted(caught)}")
        need(len(caught) == len(PAR_CAUGHT), f"{tag} {phase}: rank-local "
             f"BatchNorm stays within PAR_SPLIT by {set(PAR_CAUGHT) - set(caught)}")
        say(f"{tag} {phase} step ms by rank (the first step chooses cuDNN's "
            "algorithms; the ranks share the card): " + json.dumps(
                [[round(s["ms"], 3) for s in rk[phase]] for rk in ranks])
            + "; cuDNN off: " + json.dumps(
                [round(rk[f"{phase} no_cudnn"][0]["ms"], 3) for rk in ranks]))
    one = par_bn_stack(None, "cuda")
    for g in (1, 2):
        y = torch.cat([torch.cat([rk["bn"][g]["y"].chunk(g)[i] for rk in ranks])
                       for i in range(g)])
        grads = {n: sum(rk["bn"][g]["grads"][n] for rk in ranks)
                 for n in one[g]["grads"]}
        dy = float((y - one[g]["y"]).abs().max() / one[g]["y"].abs().max())
        dg = max(rel_l2(grads, {n: v.double() for n, v in
                                one[g]["grads"].items()}).values())
        ds = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(
            ranks[0]["bn"][g]["stats"], one[g]["stats"]))
        say(f"{tag} conv+BN stack, {g} group(s), 8 rows a group over the "
            f"ranks against world 1: output {dy:.3g} of its scale, "
            f"gradients {dg:.3g} relative L2, statistics {ds:.3g}")
        need(dy <= 1e-5 and dg <= 1e-4 and ds <= 1e-5,
             f"{tag}: the synchronized BatchNorm differs from world 1's")


def check_zero3(gloo, names, smi):
    """Phase 9 (c): the guarded AdamW fed (b)'s gradients, and PAR_STEPS
    FinetuneStage steps under ZeRO-3 against (b)'s from the same seeded
    weights and inputs (both under deterministic algorithms): each rank's
    losses, parameters, gathered moments and running statistics bitwise,
    its launches phase 4's, its parameter and optimizer bytes at rest
    the pieces'; the mean gradient within PAR_SAME_SPLIT of (b)'s ranks'
    mean (and whether bitwise)."""
    import torch
    want = par_expected("FinetuneStage", "float32")
    for r, rk in enumerate(gloo):
        say(f"parallel (c) n_fsdp=2 rank {r}, the guarded AdamW fed "
            f"(b)'s gradients: parameters after each of {PAR_STEPS} "
            "updates, then the gathered moments, bitwise data "
            f"parallelism's: {rk['fsdp_same']}")
        need(all(rk["fsdp_same"]), "n_fsdp=2's update differs from "
             "data parallelism's on the same gradients")
        need(all(s["launches"] == want for s in rk["fsdp"]),
             f"n_fsdp=2 rank {r}: launches "
             f"{[s['launches'] for s in rk['fsdp']]}")
        for k, (z, d) in enumerate(zip(rk["fsdp"], rk["FinetuneStage"])):
            same = dict(
                loss=z["loss"] == d["loss"],
                params=torch.equal(z["params"], d["params"]),
                moments=z["moments"] == d["moments"],
                stats=all(torch.equal(v, d["stats"][n])
                          for n, v in z["stats"].items()),
                mean_grad=torch.equal(z["grad"], par_mean(
                    gloo, "FinetuneStage", k)["grad"]))
            say(f"parallel (c) rank {r} step {k}: ZeRO-3 against data "
                f"parallelism, bitwise by reading: {json.dumps(same)}; "
                f"loss {z['loss']:.9g} vs {d['loss']:.9g}; parameter bytes "
                f"{z['param_bytes']} vs {d['param_bytes']}, optimizer bytes "
                f"{z['opt_bytes']} vs {d['opt_bytes']} (this rank, at rest "
                f"after the step); step ms {z['ms']:.3f} vs {d['ms']:.3f}; "
                f"{smi}")
            need(all(v for key, v in same.items() if key != "mean_grad"),
                 f"n_fsdp=2 rank {r} step {k} differs from data "
                 f"parallelism: {same}")
            need(2 * z["param_bytes"] < d["param_bytes"] + 4 * 1024 ** 2
                 and 2 * z["opt_bytes"] < d["opt_bytes"] + 8 * 1024 ** 2,
                 f"n_fsdp=2 rank {r}: {z['param_bytes']} parameter and "
                 f"{z['opt_bytes']} optimizer bytes at rest, not half of "
                 f"{d['param_bytes']} and {d['opt_bytes']}")
    for k in range(PAR_STEPS):
        par_hold(f"parallel (c) n_fsdp=2 FinetuneStage step {k}, the mean "
                 "gradient against (b)'s ranks' mean", gloo[0]["fsdp"][k],
                 par_mean(gloo, "FinetuneStage", k), names, PAR_SAME_SPLIT)
    need(torch.equal(gloo[0]["fsdp"][-1]["params"],
                     gloo[1]["fsdp"][-1]["params"]),
         "n_fsdp=2: the ranks' gathered parameters differ")


def report_par_memory(mem, smi):
    """Phase 9 (c) at depth 152: each rank's parameter and optimizer bytes
    at rest, peak memory and step ms under ``n_fsdp`` 1 and 2; the
    parameter and optimizer bytes at rest must stay the same after each
    step, and halve (to within the units' padding) under ``n_fsdp=2``;
    the losses must be finite."""
    mib = lambda b: b / 2 ** 20
    for r, rk in enumerate(mem):
        m = rk["memory"]
        for n in (1, 2):
            rec = m[n]
            say(f"parallel (c) memory {PAR_MEMORY_NET} ({rec['numel']} "
                f"parameters) FinetuneStage float32, 16 rows a rank, "
                f"n_fsdp={n} rank {r}: parameter bytes at rest "
                f"{rec['rest'][0][0]} ({mib(rec['rest'][0][0]):.1f} MiB), "
                f"optimizer bytes {rec['rest'][0][1]} "
                f"({mib(rec['rest'][0][1]):.1f} MiB), after each step "
                + json.dumps(rec["rest"][1:])
                + f"; max_memory_allocated {rec['peak']} "
                f"({rec['peak'] / 2 ** 30:.3f} GiB); step ms "
                + json.dumps([round(t, 3) for t in rec["ms"]])
                + f"; losses {rec['loss']}; {smi}")
            need(all(x == rec["rest"][0] for x in rec["rest"]),
                 f"memory n_fsdp={n} rank {r}: the bytes at rest moved "
                 f"{rec['rest']}")
            need(all(np.isfinite(rec["loss"])),
                 f"memory n_fsdp={n} rank {r}: losses {rec['loss']}")
        (p1, o1), (p2, o2) = m[1]["rest"][0], m[2]["rest"][0]
        need(p1 == 4 * m[1]["numel"] and 2 * p2 < p1 + 4 * 2 ** 20
             and 2 * o2 < o1 + 8 * 2 ** 20,
             f"memory rank {r}: n_fsdp=2 holds {p2} parameter and {o2} "
             f"optimizer bytes for n_fsdp=1's {p1} and {o1}")
        say(f"parallel (c) memory rank {r}: n_fsdp=2 against n_fsdp=1, "
            f"parameters {mib(p1 - p2):.1f} MiB fewer at rest, peak "
            f"{(m[1]['peak'] - m[2]['peak']) / 2 ** 30:.3f} GiB lower, "
            f"second step {m[2]['ms'][-1] / m[1]['ms'][-1] - 1:+.1%} ms")


def run_parallel(mano_path, smi):
    """Phase 9: the multi-GPU path.  Returns the launch counts by path."""
    import torch
    import torch.distributed as dist
    from dsf_tpu_torch import demo, kernels
    from dsf_tpu_torch.parallel.mesh import Mesh
    from dsf_tpu_torch.serving import InferenceEngine
    from dsf_tpu_torch.models.weights import random_reference_state_dict
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (b) and (c): two ranks on this card over gloo
        gloo = par_world("gloo", mano_path, tmp)
        for r, rk in enumerate(gloo):
            by_path[f"parallel_gloo_rank{r}"] = {
                n: sum(s["launches"][n] for p in PAR_PHASES + ("fsdp",)
                       for s in rk[p]) for n in KERNELS}

        # (a) world 1 over NCCL: this process's group of one
        dist.init_process_group("nccl",
                                init_method=f"tcp://localhost:{free_port()}",
                                rank=0, world_size=1)
        try:
            one = Mesh(collectives=True)
            plain = {}
            for dtype in ("float32", "bfloat16"):
                for phase in PAR_PHASES:
                    f32 = dtype == "float32"
                    carry = ((lambda k, p=phase: os.path.join(
                        tmp, f"{p}_{k}.pt")) if f32 else None)
                    p_recs, names = par_steps(
                        mano_path, None, dtype, phase, PAR_STEPS, "cuda",
                        carry=carry, witness=f32)
                    kernels.reset_launch_counts()
                    c_recs, _ = par_steps(mano_path, one, dtype, phase,
                                          PAR_STEPS, "cuda")
                    by_path[f"parallel_world1_{phase.lower()}_"
                            f"{dtype}"] = dict(kernels.LAUNCHES)
                    need(all(c["launches"] == p["launches"]
                             == par_expected(phase, dtype)
                             for c, p in zip(c_recs, p_recs)),
                         f"world 1 {phase} {dtype}: launches "
                         f"{[c['launches'] for c in c_recs]} and "
                         f"{[p['launches'] for p in p_recs]}")
                    par_hold(f"parallel world 1 (NCCL) {phase} {dtype}",
                             c_recs[0], p_recs[0], names,
                             PAR_SAME_SPLIT if f32 else PAR_BF16)
                    say(f"parallel world 1 {phase} {dtype} second step ms "
                        f"(host clock to a synchronized loss): distributed "
                        f"path {c_recs[-1]['ms']:.3f}, one-device path "
                        f"{p_recs[-1]['ms']:.3f}; {smi}")
                    if f32:
                        plain[phase] = p_recs
                        plain[f"{phase} no_cudnn"], _ = par_steps(
                            mano_path, None, dtype, phase, 1, "cuda",
                            cudnn=False, deterministic=False)
                        plain[f"{phase} split_render"], _ = par_steps(
                            mano_path, None, dtype, phase, PAR_STEPS, "cuda",
                            carry=carry, witness=True,
                            render_parts=PAR_RANKS)
            n = sum(k for _, k in names)
            say(f"parallel world 1: the flat gradient's all-reduce "
                f"({n} float32) over NCCL, world 1: "
                f"{par_allreduce_ms(n, None, torch.device('cuda')):.4f} ms; {smi}")
        finally:
            dist.destroy_process_group()

        par_check_world("parallel (b) 2 ranks, gloo on one card", gloo,
                        plain, names)
        say(f"parallel (b): the flat gradient's all-reduce ({gloo[0]['numel']}"
            f" float32) over gloo between two processes on one card (not "
            f"NCCL's; gloo stages CUDA tensors through the host): "
            + json.dumps([round(rk["allreduce_ms"], 3) for rk in gloo])
            + f" ms by rank; {smi}")

        # (c) n_fsdp=2 (ZeRO-3) on the same two ranks
        check_zero3(gloo, names, smi)
        with tempfile.TemporaryDirectory() as tmp_mem:
            mem = par_world("gloo", mano_path, tmp_mem, mode="memory")
        report_par_memory(mem, smi)

        # (d) the engine on two replicas of this card
        sd = random_reference_state_dict(np.random.RandomState(SEED))
        cfg = train_config(mano_path, 2, SEED).replace(num_devices=2,
                                                      phase="test")
        single = InferenceEngine(cfg.replace(num_devices=1), sd,
                                 buckets=(8, 32), device="cuda")
        two = InferenceEngine(cfg, sd, buckets=(8, 32),
                              devices=("cuda:0", "cuda:0"))
        rng = np.random.RandomState(SEED + 90)
        kernels.reset_launch_counts()
        for n in (8, 32):
            req = demo.requests(single.renderer, n, rng)
            a, b = single.predict(*req), two.predict(*req)
            worst = {k: float(np.abs(a[k] - b[k]).max()) for k in a}
            bad = {k: v for k, v in worst.items() if v > atol_for(k)}
            say(f"parallel (d) engine on devices (cuda:0, cuda:0), bucket "
                f"{n}: largest difference from one device by output "
                + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
            need(not bad, f"the two-replica engine differs: {bad}")
        by_path["serve_two_replicas"] = dict(kernels.LAUNCHES)

        # (e) two cards over NCCL
        if torch.cuda.device_count() >= 2:
            with tempfile.TemporaryDirectory() as tmp2:
                nccl = par_world("nccl", mano_path, tmp2)
            par_check_world("parallel (e) 2 ranks, NCCL on two cards", nccl,
                            plain, names)
            say("parallel (e): the flat gradient's all-reduce over NCCL: "
                + json.dumps([round(rk["allreduce_ms"], 3) for rk in nccl])
                + f" ms by rank; {smi}")
        else:
            say(f"parallel (e) did not run: {torch.cuda.device_count()} "
                "card(s) here, two needed for NCCL between processes")
    return by_path


# ---------------------------------------------------------------- phase 10

CCSSL_PASSES = 5                # the labelling pass's test-time passes
CCSSL_COMPARE_BATCH = 4
CCSSL_ODD_SIZE = 96             # the warps again at a size not a power of 2
# one CCSSL step: K1 renders the stage-2 input and K5 encodes its remap
# (whose VJP is the only one needed), K5 encodes each stage's labels, K4
# decodes each stage (both with VJPs), K2 is the remap render's backward
CCSSL_STEP_LAUNCHES = launches(raster_skip=1, raster_moments=1,
                               codec_encode=3, codec_encode_bwd=1,
                               codec_decode=2, codec_decode_bwd=2)
# ... and one batch of the labelling pass: each test-time pass is an
# eval-mode forward (K1, K5), then one decode of the mean feature (K4)
CCSSL_LABEL_LAUNCHES = launches(raster_skip=CCSSL_PASSES,
                                codec_encode=CCSSL_PASSES, codec_decode=1)
# the labels' frame: a batch's normalized joints of pseudo labels inside
# this box are inside the crop, give or take a hand's reach
CCSSL_UVD_BOUND = 1.5
# the hourglass PoseNet at full width: card against CPU, relative L2
HOURGLASS_TOL = 1e-4


def ccssl_grad_tol(name):
    """The CCSSL step's gradients card against CPU and float64: the
    stage-2 offset head feeds the loss alone (1e-2, as ``grad_tol``);
    the stage-1 MANO head is reached only through the stage-2 render and
    the stage-2 trunk, so it takes phase 5's FinetuneStage rule with all
    of its share through the trunk (1e-2 + 0.2); every other layer 0.2.
    Its gradient follows the stage-2 render's silhouette: in this phase's
    first run (H100 at 700 W, B=4) the CPU's float32 bias gradient lay
    0.29 from float64 and the card's 0.31, so both comparisons also allow
    twice the CPU's own distance from float64, phase 5's witness rule."""
    if name.startswith("finals_s2"):
        return 1e-2
    return 1e-2 + 0.2 if name.startswith("mano_regress.") else 0.2


@contextlib.contextmanager
def watched_ccssl(rec):
    """``pipelines.run_ccssl`` with the labelling pass's launch deltas
    and wall time, and each step's launch deltas, host time to a
    synchronized loss and loss, in ``rec``."""
    from dsf_tpu_torch import kernels
    from dsf_tpu_torch.training import ccssl_trainer as CC
    from dsf_tpu_torch.training.trainer import Trainer
    orig_label, orig_step = CC.generate_pseudo_labels, Trainer.ccssl_step_fn
    rec.update(steps=[], ms=[], loss=[])

    def label(*a, **k):
        import torch
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        out = orig_label(*a, **k)
        torch.cuda.synchronize()
        rec["label_s"] = time.perf_counter() - t0
        rec["label"] = {n: kernels.LAUNCHES[n] - before[n] for n in before}
        return out

    def ccssl_step_fn(self):
        step = orig_step(self)

        def watched(state, batch):
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            rec["loss"].append(float(metrics["loss"]))
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["steps"].append({n: kernels.LAUNCHES[n] - before[n]
                                 for n in before})
            return state, metrics
        return watched

    CC.generate_pseudo_labels, Trainer.ccssl_step_fn = label, ccssl_step_fn
    try:
        yield rec
    finally:
        CC.generate_pseudo_labels = orig_label
        Trainer.ccssl_step_fn = orig_step


def ccssl_batch(root, n, pseudo_dir=None, seed=SEED + 101):
    """``n`` unaugmented frames of the fake set's train split: NYUDataset's
    batch, or NYUCCSSLDataset's on the labels of ``pseudo_dir``."""
    from dsf_tpu_torch.data import datasets as D
    nyu = os.path.join(root, "nyu")
    ds = (D.NYUDataset(nyu, "train", img_size=INPUT_SIZE) if pseudo_dir is None
          else D.NYUCCSSLDataset(nyu, "train", pseudo_dir,
                                 img_size=INPUT_SIZE))
    ds.augment = False
    idx = np.sort(np.random.RandomState(seed).permutation(len(ds))[:n])
    b = ds._fetch_batch(idx)
    ds.close()
    return b


def compare_ccssl(mano_path, root, pseudo_dir):
    """Card against CPU (the kernels' plain versions), and the CPU in
    float64 as the witness, from the same seeded weights at B=4:
    ``prediction_check``'s warps (bitwise but at counted ties), joints
    and confidences; one CCSSL loss and its gradients."""
    import copy
    import torch
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.ops.image import affine_grid, affine_warp, unnormalize
    from dsf_tpu_torch.tools.ccssl import (_ref_theta, prediction_check,
                                           ref_tta_draws)
    from dsf_tpu_torch.training.ccssl_trainer import ccssl_loss
    from dsf_tpu_torch.training.trainer import Trainer

    B = CCSSL_COMPARE_BATCH
    cfg = Config(dataset="nyu", batch_size=B, stage_num=2,
                 input_size=INPUT_SIZE, seed=SEED + 100,
                 mano_model_path=mano_path)
    gpu, cpu = (Trainer(cfg, mano_path, device=d) for d in ("cuda", "cpu"))
    sg, sc = gpu.init_state(), cpu.init_state()
    net64 = copy.deepcopy(sc.net).double()
    r64 = float64_renderer(cpu.renderer)
    b = ccssl_batch(root, B, pseudo_dir)
    t = {k: torch.from_numpy(b[k]) for k in ("img", "center", "cube",
                                             "uvd_gt", "weight")}
    runs = {"card": (sg.net, gpu.renderer, {k: v.cuda() for k, v in t.items()}),
            "cpu": (sc.net, cpu.renderer, t),
            "cpu64": (net64, r64, {k: v.double() for k, v in t.items()})}
    s, rot = ref_tta_draws(torch.Generator().manual_seed(SEED + 102), B,
                           CCSSL_PASSES)

    # each pass's warp of the image on both devices, from one theta; then
    # of its centre crop at CCSSL_ODD_SIZE, where 1 / size is inexact
    # (the grid divides on the device: the card's product with a rounded
    # reciprocal would move samples away from ties)
    odd = (INPUT_SIZE - CCSSL_ODD_SIZE) // 2
    for img in (t["img"], t["img"][..., odd:odd + CCSSL_ODD_SIZE,
                                   odd:odd + CCSSL_ODD_SIZE].contiguous()):
        size = img.shape[-1]
        differ, ties_all = 0, 0
        for i in range(CCSSL_PASSES):
            theta, _ = _ref_theta(s[i], rot[i])
            a = (affine_warp(img.cuda() - 1.0, theta.cuda(), "nearest")
                 + 1.0).cpu()
            c = affine_warp(img - 1.0, theta, "nearest") + 1.0
            grid = affine_grid(theta.double(), size, size)
            near = lambda x: ((x - torch.floor(x) - 0.5).abs() < 1e-4)
            ties = (near(unnormalize(grid[..., 0], size))
                    | near(unnormalize(grid[..., 1], size)))
            diff = (a != c)[:, 0]
            need(not bool((diff & ~ties).any()), f"ccssl warp {size}^2 pass "
                 f"{i}: card and CPU differ away from a tie "
                 f"({int((diff & ~ties).sum())} pixels)")
            differ += int(diff.sum())
            ties_all += int(ties.sum())
        say(f"ccssl compare B={B} {size}^2: {CCSSL_PASSES} test-time "
            f"warps, card vs CPU: {differ} pixels differ, all at ties "
            f"({ties_all} tie pixels of {CCSSL_PASSES * img.numel()})")

    checks = {}
    with torch.no_grad(), exact_float32():
        for key, (net, r, bt) in runs.items():
            net.eval()
            fwd = (lambda im, net=net, r=r, bt=bt:
                   net(im, r, bt["center"], bt["cube"])[-1][0])
            j, c = prediction_check(fwd, bt["img"], (s, rot),
                                    cfg.feature_para[0])
            checks[key] = (j.double().cpu(), c.double().cpu())
            net.train()
    # the engine's stage-2 bound (0.5 mm) in the crop frame of the cube
    tol_j = 0.5 / (float(b["cube"][0, 0]) / 2)
    (jg, cg), (jc, cc), (j64, c64) = (checks[k] for k in ("card", "cpu",
                                                          "cpu64"))
    dj, dc = float((jg - jc).abs().max()), float((cg - cc).abs().max())
    wj, wc = float((jc - j64).abs().max()), float((cc - c64).abs().max())
    say(f"ccssl compare prediction_check: joints card vs CPU max {dj:.3g} "
        f"(crop frame; bound {tol_j:.3g}, the engine's 0.5 mm), CPU vs "
        f"float64 {wj:.3g}; confidences card vs CPU max {dc:.3g}, CPU vs "
        f"float64 {wc:.3g}")
    need(dj <= tol_j, f"ccssl prediction_check joints: card vs CPU {dj}")
    need(dc <= max(1e-5, 3 * wc), f"ccssl prediction_check confidences: "
         f"card vs CPU {dc}, CPU vs float64 {wc}")

    loss, grads = {}, {}
    with exact_float32():
        for key, (net, r, bt) in runs.items():
            net.zero_grad(set_to_none=True)
            value, _ = ccssl_loss(net, r, bt, cfg)
            value.backward()
            loss[key] = value.item()
            grads[key] = {n: p.grad.detach().cpu() for n, p in
                          net.named_parameters() if p.grad is not None}
    unread = sorted({n.split(".")[0] for n, p in sg.net.named_parameters()
                     if n not in grads["card"]})
    need(unread == ["mano_regress_s2"] and all(
        set(grads[k]) == set(grads["card"]) for k in grads),
        f"ccssl loss: parameters without a gradient {unread}")
    rel_loss = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    g_c, g_64 = (rel_l2(grads["card"], grads[k]) for k in ("cpu", "cpu64"))
    c_64 = rel_l2(grads["cpu"], grads["cpu64"])
    say(f"ccssl compare loss card {loss['card']:.7g} CPU {loss['cpu']:.7g} "
        f"CPU float64 {loss['cpu64']:.10g}; gradient relative L2 per "
        f"parameter: card vs CPU {spread(g_c)}; card vs float64 "
        f"{spread(g_64)}; CPU vs float64 {spread(c_64)}")
    need(rel_loss <= 1e-4, f"ccssl loss: card {loss['card']} against CPU "
         f"{loss['cpu']}")
    for name, d in (("CPU", g_c), ("float64", g_64)):
        bad = {k: v for k, v in d.items()
               if not v <= max(ccssl_grad_tol(k), 2 * c_64[k])}
        need(not bad, f"ccssl gradients, card vs {name}: {bad}")
    ratio = (float(np.median(list(g_64.values())))
             / float(np.median(list(c_64.values()))))
    need(ratio <= MEDIAN_RATIO, f"ccssl gradients lie {ratio:.3g} times "
         "further from float64 than the CPU's, in the median")


def compare_hourglass(smi):
    """The hourglass PoseNet at full width (two stacks, 21 joints,
    inp_dim 256) on B=32 crops of 128^2 from seeded reference-layout
    weights: card against CPU in train mode (outputs and running
    statistics) and eval mode, within HOURGLASS_TOL relative L2; the
    card's forward ms in each mode."""
    import torch
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.models import weights as W
    from dsf_tpu_torch.models.hourglass import PoseNet

    sd = W.pose_net_from_reference(W.random_pose_net_state_dict(
        np.random.RandomState(SEED + 103), nstack=2))
    x = torch.from_numpy(np.random.RandomState(SEED + 104).rand(
        TRAIN_BATCH, 1, INPUT_SIZE, INPUT_SIZE).astype(np.float32))
    out, nets = {}, {}
    with exact_float32():
        for dev in ("cuda", "cpu"):
            net = PoseNet(**W.pose_net_dims(sd))
            W.load_into(net, sd)
            nets[dev] = net.to(dev)
            with torch.no_grad():
                net.train()
                p, hg = net(x.to(dev))
                stats = {k: v.cpu() for k, v in net.state_dict().items()
                         if "running" in k}
                net.eval()
                pe, hge = net(x.to(dev))
            out[dev] = ([t.cpu() for t in (*p, hg)],
                        [t.cpu() for t in (*pe, hge)], stats)
        rel = lambda a, b: float((a.double() - b.double()).norm()
                                 / b.double().norm())
        worst = {}
        for i, mode in enumerate(("train", "eval")):
            worst[mode] = max(rel(a, b) for a, b in zip(out["cuda"][i],
                                                        out["cpu"][i]))
        worst["statistics"] = max(rel(out["cuda"][2][k], out["cpu"][2][k])
                                  for k in out["cpu"][2])
        net = nets["cuda"]
        xg = x.cuda()
        with torch.no_grad():
            ms = {}
            for mode in ("train", "eval"):
                net.train(mode == "train")
                ms[mode] = time_ms(lambda: net(xg), 5)
    say(f"hourglass PoseNet (2 stacks, 21 joints, inp_dim 256, B="
        f"{TRAIN_BATCH}, {INPUT_SIZE}^2, outputs {tuple(out['cuda'][0][0].shape)}"
        f"), card vs CPU relative L2: " + json.dumps(
            {k: float(f"{v:.3g}") for k, v in worst.items()})
        + f"; card forward ms train {ms['train']:.3f}, eval "
        f"{ms['eval']:.3f}; {smi}")
    bad = {k: v for k, v in worst.items() if not v <= HOURGLASS_TOL}
    need(not bad, f"hourglass PoseNet card vs CPU: {bad}")


def run_ccssl_phase(mano_path, smi, root):
    """Phase 10: ``pipelines.run_ccssl`` at full width on phase 6's fake
    NYU set (B=32, 128^2, two stages, float32; one epoch): the labelling
    pass's launches and frames/s, each step's launches, the median step
    ms, the peak memory; the labels inside the frame and their batches
    inside CCSSL_UVD_BOUND; one bfloat16 CCSSL step; then
    ``compare_ccssl`` and ``compare_hourglass``.  Returns the launch
    counts of the pipeline."""
    import torch
    from dsf_tpu_torch import kernels
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.training import pipelines
    from dsf_tpu_torch.training.trainer import Trainer

    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(dataset="nyu", batch_size=TRAIN_BATCH,
                     input_size=INPUT_SIZE, stage_num=2, root_dir=root,
                     seed=SEED, mano_model_path=mano_path,
                     save_dir=os.path.join(tmp, "ckpt"))
        rec = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with watched_ccssl(rec):
            t0 = time.perf_counter()
            run_dir, state = pipelines.run_ccssl(cfg, epochs=1)
            secs = time.perf_counter() - t0
        counts["ccssl"] = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        n_steps = FAKE_TRAIN // TRAIN_BATCH
        n_batches = -(-FAKE_TRAIN // TRAIN_BATCH)
        need(rec["label"] == {k: v * n_batches for k, v in
                              CCSSL_LABEL_LAUNCHES.items()},
             f"the labelling pass's launches {rec['label']}")
        need(len(rec["steps"]) == n_steps == state.step,
             f"run_ccssl ran {len(rec['steps'])} steps")
        for i, d in enumerate(rec["steps"]):
            need(d == CCSSL_STEP_LAUNCHES, f"ccssl step {i} did not launch "
                 f"every kernel of the path as expected: {d} != "
                 f"{CCSSL_STEP_LAUNCHES}")
        need(all(np.isfinite(rec["loss"])), f"ccssl losses {rec['loss']}")
        for k in ("raster_skip", "raster_moments", "codec_decode",
                  "codec_decode_bwd", "codec_encode"):
            need(counts["ccssl"][k] > 0, f"ccssl: {k} never launched")
        med = float(np.median(rec["ms"]))
        say(f"ccssl launches (labelling {FAKE_TRAIN} frames, then "
            f"{n_steps} steps at B={TRAIN_BATCH}, {INPUT_SIZE}^2): "
            f"{json.dumps(counts['ccssl'])}")
        say(f"ccssl labelling: {FAKE_TRAIN} frames, {CCSSL_PASSES} "
            f"test-time passes each, in {rec['label_s']:.3f} s, "
            f"{FAKE_TRAIN / rec['label_s']:.1f} frames/s; losses "
            + json.dumps([float(f"{x:.6g}") for x in rec["loss"]])
            + "; step ms (host clock, to a synchronized loss) "
            + json.dumps([round(x, 3) for x in rec["ms"]])
            + f", median {med:.3f} ms, {TRAIN_BATCH * 1e3 / med:.1f} "
            f"images/s; the run with its set-up {secs:.3f} s; peak device "
            f"memory {peak:.1f} MiB; {smi}")

        pseudo = os.path.join(run_dir, "pseudo")
        uvd = np.loadtxt(os.path.join(pseudo, "joint_uvd.txt")).reshape(
            FAKE_TRAIN, -1, 3)
        inside = bool(((uvd[..., 0] >= 0) & (uvd[..., 0] < 640)
                       & (uvd[..., 1] >= 0) & (uvd[..., 1] < 480)
                       & (uvd[..., 2] > 0)).all())
        b = ccssl_batch(root, FAKE_TRAIN, pseudo)
        lo, hi = float(b["uvd_gt"].min()), float(b["uvd_gt"].max())
        say(f"ccssl labels: image-frame u in [{uvd[..., 0].min():.1f}, "
            f"{uvd[..., 0].max():.1f}], v in [{uvd[..., 1].min():.1f}, "
            f"{uvd[..., 1].max():.1f}] px, d in [{uvd[..., 2].min():.1f}, "
            f"{uvd[..., 2].max():.1f}] mm; their batches' uvd_gt in "
            f"[{lo:.3f}, {hi:.3f}]")
        need(inside, "ccssl labels outside the 640x480 frame")
        need(-CCSSL_UVD_BOUND <= lo and hi <= CCSSL_UVD_BOUND,
             f"ccssl labels' uvd_gt in [{lo}, {hi}]")

        # one bfloat16 CCSSL step on those labels
        tr = Trainer(cfg.replace(compute_dtype="bfloat16"), mano_path,
                     device="cuda")
        bb = ccssl_batch(root, TRAIN_BATCH, pseudo)
        _, m = tr.ccssl_step_fn()(tr.init_state(), bb)
        loss = float(m["loss"])
        say(f"ccssl bfloat16 step (B={TRAIN_BATCH}): loss {loss:.6g}")
        need(np.isfinite(loss), f"ccssl bfloat16 step: loss {loss}")
        compare_ccssl(mano_path, root, pseudo)
    compare_hourglass(smi)
    return counts


def phase9_alone():
    """``--phase9``: the kernels' build, then phase 9 alone; prints no
    result line."""
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.kernels import build
    from dsf_tpu_torch.mano import synthetic
    smi = nvidia_smi_line()
    build.build_all()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, exact_float32():
        path = os.path.join(tmp, "mano_synthetic.npz")
        synthetic.save_synthetic_mano(path)
        counts = run_parallel(path, smi)
    say(f"phase 9 alone: {time.perf_counter() - t0:.1f} s; "
        + json.dumps(counts))
    return 0


def phase10_alone():
    """``--phase10``: the kernels' build, phase 6's fake NYU set (K6 on
    the card), then phase 10 alone; prints no result line."""
    from dsf_tpu_torch.data.fake import make_fake_nyu
    from dsf_tpu_torch.kernels import build
    from dsf_tpu_torch.mano import synthetic
    smi = nvidia_smi_line()
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mano_synthetic.npz")
        synthetic.save_synthetic_mano(path)
        root = os.path.join(tmp, "fake_nyu")
        make_fake_nyu(root, path, n_train=FAKE_TRAIN, n_test=FAKE_TEST,
                      seed=SEED, batch_size=TRAIN_BATCH)
        counts = run_ccssl_phase(path, smi, root)
    say("phase 10 alone: " + json.dumps(counts))
    return 0


# ---------------------------------------------------------------- phase 11

# an artifact's call launches what live predict launches on a bucket
EXPORT_LAUNCHES = launches(raster_skip=1, codec_encode=1, codec_decode=2)
EXPORT_BINNED_LAUNCHES = launches(raster_binned=1, codec_encode=1,
                                  codec_decode=2)
# fit_params at the default config's batch and crops: one step renders
# the parameters once (K1) and takes the render's gradient once (K2)
FIT_BATCH, FIT_STEPS = 32, 50
FIT_STEP_LAUNCHES = launches(raster_skip=1, raster_moments=1)
FIT_COMPARE_BATCH = 4
# the fit's targets: hands within a fit's reach of the neutral init (the
# depth term's gradient is the hard raster's, through the hit face's
# depth plane only, so the silhouettes must overlap): pose coefficients
# of 0.15 rad, scale within 5%, translations of 0.03 (4 mm at the 250 mm
# cube), with their joints as labels
FIT_POSE_SD = 0.15
FIT_WORLD_STEPS = 20


def fit_targets(renderer, B, rng):
    """(target img, center, cube, target joints xyz) rendered on the
    renderer's device from seeded parameters near the neutral pose."""
    import torch
    from dsf_tpu_torch.render import renderer as rnd
    para = np.zeros((B, 62), np.float32)
    para[:, :48] = rng.randn(B, 48) * FIT_POSE_SD
    para[:, 58] = rng.uniform(0.95, 1.05, B)
    para[:, 59:] = rng.randn(B, 3) * 0.03
    center = rng.uniform([-40, -40, 650], [40, 40, 900], (B, 3))
    dev = renderer.mano.device
    para, center = (torch.from_numpy(x.astype(np.float32)).to(dev)
                    for x in (para, center))
    cube = torch.full((B, 3), 250.0, device=dev)
    with torch.no_grad():
        img, _, jxyz, _ = rnd.render_params(renderer, para, center, cube)
    return img, center, cube, jxyz


def median_call_ms(fn):
    """The median host-clock ms of ``fn()`` (which ends on the host) over
    LATENCY_CALLS calls after 3 warm ones."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(LATENCY_CALLS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def model_code_imported():
    """The modules of dsf_tpu_torch's model code (models, render, mano,
    training), or of JAX, that this process has imported."""
    return sorted(m for m in sys.modules if m.split(".")[:2] in (
        ["dsf_tpu_torch", "models"], ["dsf_tpu_torch", "render"],
        ["dsf_tpu_torch", "mano"], ["dsf_tpu_torch", "training"])
        or m.split(".")[0] in ("jax", "dsf_tpu"))


def export_artifact(job):
    """``--phase11-export JOB``: a child process of phase 11 that builds
    phase 3's engine (``demo.engine``, the same seed) in the job's dtype
    and exports it at the job's bucket, with the skip raster on or off;
    writes its export seconds beside the artifact."""
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.ops import rasterize as ras
    with open(job) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    eng = demo.engine(job["mano"], "cuda", INPUT_SIZE, BUCKETS, SEED,
                      compute_dtype=job["dtype"],
                      net=job.get("net", "ResNet_stage_18"))
    ras.USE_PALLAS_SKIP = job["skip"]
    t0 = time.perf_counter()
    eng.export(job["path"], bucket=job["bucket"])
    with open(job["path"] + ".json", "w") as f:
        json.dump({"export_s": time.perf_counter() - t0}, f)
    return 0


def load_artifact(job):
    """``--phase11-load JOB``: a child process of phase 11 (or 13) that
    imports ``dsf_tpu_torch.exported`` (and through it the op registry)
    and no model code.  It loads the job's artifact (timed), calls it once
    on the job's request with the launch counts of that call and saves the
    outputs (and, for a job with ``timed`` false, writes its report and
    stops there); when every job's process has got so far, it times
    LATENCY_CALLS calls to numpy while holding the jobs' lock, so that
    no two artifacts are timed at once; then it writes its report, with
    the model code this process imported."""
    import fcntl
    import torch
    from dsf_tpu_torch import kernels
    from dsf_tpu_torch.exported import load_exported
    with open(job) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    call = load_exported(job["path"])
    load_s = time.perf_counter() - t0
    req = np.load(job["request"])
    args = [req[k] for k in ("img", "center", "M", "cube")]
    call(*args)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = call(*args)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    np.savez(job["out"], **{k: v.float().cpu().numpy() for k, v in out.items()})
    if not job.get("timed", True):
        with open(job["report"], "w") as f:
            json.dump({"load_s": load_s, "launches": counts,
                       "dtypes": {k: str(v.dtype) for k, v in out.items()},
                       "model_code": model_code_imported()}, f)
        return 0
    open(os.path.join(job["ready"], job["name"]), "w").close()
    deadline = time.time() + 600
    while len(os.listdir(job["ready"])) < job["jobs"]:
        need(time.time() < deadline, "the other loaders never got ready")
        time.sleep(0.1)
    with open(job["lock"], "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        ms = median_call_ms(lambda: {k: v.cpu() for k, v in
                                     call(*args).items()})
        fcntl.flock(lock, fcntl.LOCK_UN)
    with open(job["report"], "w") as f:
        json.dump({"load_s": load_s, "launches": counts, "median_ms": ms,
                   "dtypes": {k: str(v.dtype) for k, v in out.items()},
                   "model_code": model_code_imported()}, f)
    return 0


def run_children(mode, jobs, what):
    """Run one child process of this script a job, all at once, each with
    ``mode`` and its job file; fail if any fails.  Returns the wall s."""
    t0 = time.perf_counter()
    procs = [(j, subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, j],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for j in jobs]
    try:
        for j, proc in procs:
            _, err = proc.communicate(timeout=600)
            need(proc.returncode == 0, f"{what} ({j}) failed:\n{err[-3000:]}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def run_export(mano_path, smi):
    """Phase 11 (a): phase 3's engine exported at each bucket in float32
    and bfloat16, and at the top bucket with the skip raster off, one
    child process an artifact (``export_artifact``), all at once; each
    artifact loaded in a child process of its own that imports no model
    code (``load_artifact``), and held against live ``predict`` on the
    same request.  Returns the launch counts of each artifact's call, by
    path name."""
    import torch
    from dsf_tpu_torch import demo, kernels
    from dsf_tpu_torch.ops import rasterize as ras

    engines = {dt: demo.engine(mano_path, "cuda", INPUT_SIZE, BUCKETS, SEED,
                               compute_dtype=dt)
               for dt in ("float32", "bfloat16")}
    rng = np.random.RandomState(SEED + 110)
    reqs = {b: demo.requests(engines["float32"].renderer, b, rng)
            for b in BUCKETS}
    # (path name, dtype, bucket, the skip raster on)
    plan = ([(f"export_f32_b{b}", "float32", b, True) for b in BUCKETS]
            + [(f"export_bf16_b{b}", "bfloat16", b, True) for b in BUCKETS]
            + [(f"export_binned_b{BUCKETS[-1]}", "float32", BUCKETS[-1],
                False)])
    by_path, worst = {}, {1: 0.0, 2: 0.0}
    skip = ras.USE_PALLAS_SKIP
    with tempfile.TemporaryDirectory() as tmp:
        ready = os.path.join(tmp, "ready")
        os.makedirs(ready)
        for b, r in reqs.items():
            np.savez(os.path.join(tmp, f"req_{b}.npz"),
                     **dict(zip(("img", "center", "M", "cube"), r)))
        jobs = []
        for name, dt, b, on in plan:
            job = {"name": name, "mano": mano_path, "dtype": dt, "bucket": b,
                   "skip": on, "path": os.path.join(tmp, name + ".pt2"),
                   "request": os.path.join(tmp, f"req_{b}.npz"),
                   "out": os.path.join(tmp, name + "_out.npz"),
                   "report": os.path.join(tmp, name + "_report.json"),
                   "ready": ready, "jobs": len(plan),
                   "lock": os.path.join(tmp, "timing.lock")}
            jobs.append(os.path.join(tmp, name + ".json"))
            with open(jobs[-1], "w") as f:
                json.dump(job, f)
        export_wall = run_children("--phase11-export", jobs, "an export")
        load_wall = run_children("--phase11-load", jobs, "a loader")
        say(f"export: {len(plan)} artifacts exported by as many processes "
            f"at once in {export_wall:.1f} s, loaded and called by as many "
            f"more (each importing load_exported's module alone) in "
            f"{load_wall:.1f} s")
        for (name, dt, b, on), job in zip(plan, jobs):
            with open(job) as f:
                job = json.load(f)
            with open(job["report"]) as f:
                row = json.load(f)
            with open(job["path"] + ".json") as f:
                export_s = json.load(f)["export_s"]
            need(not row["model_code"], f"{name}: loading the artifact "
                 f"imported the model code: {row['model_code']}")
            eng = engines[dt]
            ras.USE_PALLAS_SKIP = on
            try:
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                live = eng.predict(*reqs[b])
                torch.cuda.synchronize()
                live_counts = dict(kernels.LAUNCHES)
                live_ms = median_call_ms(lambda: eng.predict(*reqs[b]))
            finally:
                ras.USE_PALLAS_SKIP = skip
            want = EXPORT_LAUNCHES if on else EXPORT_BINNED_LAUNCHES
            need(row["launches"] == live_counts == want,
                 f"{name}: the artifact's call launched {row['launches']}, "
                 f"live predict {live_counts}, expected {want}")
            by_path[name] = row["launches"]
            out = np.load(job["out"])
            diff = {k: float(np.abs(out[k] - live[k]).max()) for k in live}
            for k, d in diff.items():
                need(d <= atol_for(k), f"{name}: {k} differs from live "
                     f"predict by {d} > {atol_for(k)}")
                if "mm" in k:
                    st = 1 if k.endswith("_0") else 2
                    worst[st] = max(worst[st], d)
            s1 = max(d for k, d in diff.items() if k.endswith("_0"))
            s2 = max(d for k, d in diff.items() if not k.endswith("_0"))
            say(f"{name}: export {export_s:.2f} s, "
                f"{os.path.getsize(job['path']) / 2**20:.1f} MB, load "
                f"{row['load_s']:.2f} s; launches a call "
                f"{ {k: v for k, v in row['launches'].items() if v} }; "
                f"against live predict max abs stage 1 {s1:.3g}, stage 2 "
                f"{s2:.3g}; median ms to numpy ({LATENCY_CALLS} calls, "
                f"host clock): artifact {row['median_ms']:.3f}, live "
                f"{live_ms:.3f}; mano_para dtype {row['dtypes']['mano_para_0']}")
    say(f"export: the artifacts' largest difference from live predict in "
        f"mm, stage 1 {worst[1]:.3g}, stage 2 {worst[2]:.3g} (predicted "
        f"under 1e-3 mm); {smi}")
    return by_path


def run_fit(mano_path, smi):
    """Phase 11 (b): ``fit_mano.fit_params`` at B=32, 128^2, 50 steps from
    the neutral init (K1 and K2 each step, m2d at most half its start),
    the card against the CPU at B=4 (one step's loss and gradient, the
    CPU in float64 the witness) and ``fit_params_world`` at B=32.
    Returns the launch counts of the 50 steps."""
    import torch
    from dsf_tpu_torch import demo, kernels
    from dsf_tpu_torch.mano import model as mano
    from dsf_tpu_torch.render import renderer as rnd
    from dsf_tpu_torch.tools import fit_mano

    r = rnd.Renderer.create(mano.load_model(mano_path, device="cuda"), "nyu",
                            demo.PARAS, (640, 480), (INPUT_SIZE, INPUT_SIZE))
    img, center, cube, jxyz = fit_targets(r, FIT_BATCH,
                                          np.random.RandomState(SEED + 120))
    p0 = torch.zeros((FIT_BATCH, 62), device="cuda")
    p0[:, 58] = 1.0
    with torch.no_grad():
        _, aux0 = fit_mano.fit_loss(r, p0, img, center, cube, jxyz)
    m2d0 = float(aux0["m2d"])
    fit_mano.fit_params(r, img, center, cube, jxyz, steps=2)    # warm
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _, terms = fit_mano.fit_params(r, img, center, cube, jxyz,
                                   steps=FIT_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / FIT_STEPS
    counts = dict(kernels.LAUNCHES)
    per_step = {k: v / FIT_STEPS for k, v in counts.items() if v}
    say(f"fit_params B={FIT_BATCH} {INPUT_SIZE}^2 {FIT_STEPS} steps: "
        f"{step_ms:.3f} ms a step (host clock, the whole call over the "
        f"steps); launches a step {per_step} (predicted K1 x1 forward, "
        f"K2 x1 backward); m2d {m2d0:.4f} -> {terms['m2d']:.4f} "
        f"({terms['m2d'] / m2d0:.3f} of its start), joint "
        f"{float(aux0['joint']):.4f} -> {terms['joint']:.4f}; {smi}")
    need(counts == {k: v * FIT_STEPS for k, v in FIT_STEP_LAUNCHES.items()},
         f"fit_params launched {counts}, expected {FIT_STEP_LAUNCHES} a "
         f"step")
    need(all(np.isfinite(v) for v in terms.values()),
         f"fit_params: a term is not finite: {terms}")
    need(terms["m2d"] <= 0.5 * m2d0, f"fit_params: m2d {terms['m2d']} is "
         f"more than half its start {m2d0}")

    compare_fit(r, mano_path)

    pcl_rng = np.random.RandomState(SEED + 121)
    B = FIT_BATCH
    quat = (pcl_rng.randn(B, 3) * 0.2).astype(np.float32)
    theta = (pcl_rng.randn(B, 45) * 0.2).astype(np.float32)
    cam = np.concatenate([np.ones((B, 1)), pcl_rng.randn(B, 3) * 20],
                         axis=1).astype(np.float32)
    with torch.no_grad():
        vt, jt = mano.get_mano_vertices(
            r.mano, *(torch.from_numpy(x).cuda() for x in
                      (quat + 0.1, theta + 0.1)),
            torch.zeros((B, 10), device="cuda"), torch.from_numpy(cam).cuda())
    sel = torch.from_numpy(pcl_rng.choice(vt.shape[1], 256, replace=False))
    pcl = vt[:, sel.cuda()] + torch.from_numpy(
        pcl_rng.randn(B, 256, 3).astype(np.float32)).cuda()
    t0 = time.perf_counter()
    _, hist = fit_mano.fit_params_world(r.mano, pcl, jt, quat, theta, cam,
                                        steps=FIT_WORLD_STEPS)
    world_ms = (time.perf_counter() - t0) * 1e3 / FIT_WORLD_STEPS
    say(f"fit_params_world B={B} (256 points, {FIT_WORLD_STEPS} steps): "
        f"loss {hist[0]:.4f} -> {hist[-1]:.4f}, {world_ms:.3f} ms a step")
    need(np.isfinite(hist).all() and hist[-1] < hist[0],
         f"fit_params_world: the loss did not fall: {hist}")
    return counts


def compare_fit(r, mano_path):
    """fit_params' first step at B=4, the card against the CPU from the
    same targets (rendered on the CPU): the loss within 1e-4 relative once
    the m2d share of the render's pixels that the two devices decide
    otherwise is out, and the gradient no further from the CPU's float64
    gradient than twice the CPU's float32 one (phase 5's witness rule)."""
    import torch
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.losses.basic import masked_depth_loss
    from dsf_tpu_torch.mano import model as mano
    from dsf_tpu_torch.render import renderer as rnd
    from dsf_tpu_torch.tools import fit_mano

    cpu = dataclasses.replace(r, mano=mano.load_model(mano_path,
                                                      device="cpu"))
    B = FIT_COMPARE_BATCH
    tgt = fit_targets(cpu, B, np.random.RandomState(SEED + 122))
    p0 = torch.zeros((B, 62))
    p0[:, 58] = 1.0

    def loss_grad(rr, p, args):
        p = p.clone().requires_grad_(True)
        loss, aux = fit_mano.fit_loss(rr, p, *args)
        (g,) = torch.autograd.grad(loss, p)
        return float(loss.detach()), float(aux["m2d"]), g.cpu().double()

    with exact_float32():
        l_gpu, _, g_gpu = loss_grad(r, p0.cuda(), [t.cuda() for t in tgt])
    l_cpu, m_cpu, g_cpu = loss_grad(cpu, p0, list(tgt))
    l_64, _, g_64 = loss_grad(float64_renderer(cpu), p0.double(),
                              [t.double() for t in tgt])
    with torch.no_grad():
        img_gpu = rnd.render_params(r, p0.cuda(), tgt[1].cuda(),
                                    tgt[2].cuda())[0].cpu()
        img_cpu = rnd.render_params(cpu, p0, tgt[1], tgt[2])[0]
    flipped = (img_gpu - img_cpu).abs() > 1e-3
    shift = float(masked_depth_loss(img_cpu, tgt[0]).mean()
                  - masked_depth_loss(torch.where(flipped, img_gpu, img_cpu),
                                      tgt[0]).mean())
    d_loss = abs(l_gpu - (l_cpu - shift)) / abs(l_cpu)
    d_gpu = float((g_gpu - g_64).norm() / g_64.norm())
    d_cpu = float((g_cpu - g_64).norm() / g_64.norm())
    say(f"fit_params B={B} card vs CPU, one step: loss {l_gpu:.7g} / "
        f"{l_cpu:.7g} (float64 {l_64:.7g}), {int(flipped.sum())} render "
        f"pixels decided otherwise (m2d share {shift:.3g}), relative "
        f"{d_loss:.3g}; gradient from float64: card {d_gpu:.3g}, CPU "
        f"{d_cpu:.3g}")
    need(d_loss <= 1e-4, f"fit_params: the card's loss lies {d_loss} from "
         f"the CPU's")
    need(d_gpu <= 2.0 * d_cpu, f"fit_params: the card's gradient lies "
         f"{d_gpu} from float64, more than twice the CPU's {d_cpu}")


def run_export_phase(mano_path, smi):
    """Phase 11: the serving export (``run_export``) and the offline MANO
    fits (``run_fit``), timed.  Returns the launch counts by path."""
    t0 = time.perf_counter()
    by_path = run_export(mano_path, smi)
    by_path["fit_mano"] = run_fit(mano_path, smi)
    say(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return by_path


def phase11_alone():
    """``--phase11``: the kernels' build, then phase 11 alone; prints no
    result line."""
    from dsf_tpu_torch.kernels import build
    from dsf_tpu_torch.mano import synthetic
    smi = nvidia_smi_line()
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mano_synthetic.npz")
        synthetic.save_synthetic_mano(path)
        counts = run_export_phase(path, smi)
    say("phase 11 alone: " + json.dumps(counts))
    return 0


# ---------------------------------------------------------------- phase 12

LIB_BATCH = 32
# rows of the card's batch the CPU recomputes where its raster or argmin
# at the full batch would take tens of seconds (4 rows: 34.7 s)
LIB_COMPARE = 2
LIB_INTERVAL = 4                # the labelers' interpolation (JAX's tests')
LIB_ITERS = 5                   # calls timed per function
LIB_SWITCH_ROWS = 1             # clouds of the ICP switches' card-vs-CPU check
# the four renders K1 once each, mesh_to_img with the skip raster off K10
# once, get_depth's backward K2 once; each ICP loss one nearest-face pass
# (K3); joint2feature K5 once and feature2joint K4 once, no VJP
LIBRARY_STEPS = {
    "normal_render": launches(raster_skip=1),
    "m_render": launches(raster_skip=1),
    "mesh_to_img": launches(raster_skip=1),
    "mesh_to_img_binned": launches(raster_binned=1),
    "get_depth_grad": launches(raster_skip=1, raster_moments=1),
    "icp_loss": launches(point_mesh_argmin=1),
    "joint_icp_loss": launches(point_mesh_argmin=1),
    "finger_icp_loss": launches(point_mesh_argmin=1),
    "joint2feature": launches(codec_encode=1),
    "feature2joint": launches(codec_decode=1),
}
LIBRARY_LAUNCHES = {k: sum(v[k] for v in LIBRARY_STEPS.values())
                    for k in KERNELS}


def library_inputs(r, rng, gen):
    """Phase 12's inputs on the CPU, from the seeds: crop centres, cubes
    and matrices; raw-unit parameters (mm, at the crop centres) with their
    world vertices and joints, and a view rotation; normalized parameters
    for normal_render with their MANO joints and mesh, the pixel branch's
    joints moved a little, a 2048-point cloud near each mesh and its
    15-part and finger labels; the occlusion, cloud-score and noise
    draws; a full frame for the warps."""
    import torch
    from dsf_tpu_torch import geometry as geo
    from dsf_tpu_torch.mano import model as mano, spheres
    from dsf_tpu_torch.ops import cloud
    from dsf_tpu_torch.render import renderer as rnd
    B, S = LIB_BATCH, INPUT_SIZE

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    center = t(rng.uniform([-30, -30, 650], [30, 30, 850], (B, 3)))
    cube = torch.full((B, 3), 250.0)
    com = geo.xyz_to_uvd(center[:, None], r.paras, r.flip)[:, 0]
    M = geo.crop_matrix(com, cube, r.paras, r.crop_size)
    raw = np.zeros((B, 62), np.float32)
    raw[:, :48] = rng.randn(B, 48) * 0.3
    raw[:, 58] = 1.0
    raw[:, 59:] = center.numpy()
    norm = np.zeros((B, 62), np.float32)
    norm[:, :48] = rng.randn(B, 48) * 0.3
    norm[:, 58] = 1.0
    norm[:, 59:] = rng.randn(B, 3) * 0.05 - 0.8
    raw, norm = t(raw), t(norm)
    with torch.no_grad():
        verts, joints = mano.get_mano_vertices(r.mano,
                                               *mano.split_params(raw))
        jn, mesh = rnd.get_mesh_xyz(r, norm)
    jxyz = jn + t(rng.randn(B, 21, 3) * 0.02)
    idx = torch.from_numpy(rng.randint(0, 778, (B, ICP_POINTS)))
    pcl = (torch.gather(mesh, 1, idx[..., None].expand(-1, -1, 3))
           + t(rng.randn(B, ICP_POINTS, 3) * 0.02))
    with torch.no_grad():
        seg = spheres.seg_pcl(r.mano, jxyz, jn, mesh, pcl)
        segf = spheres.seg_pcl_finger(r.mano, jxyz, jn, mesh, pcl)
    return dict(
        center=center, cube=cube, M=M, raw=raw, norm=norm, verts=verts,
        joints=joints, rot=t(rng.randn(B, 3) * 0.3), jn=jn, mesh=mesh,
        jxyz=jxyz, pcl=pcl, seg=seg, segf=segf,
        mask=rnd.draw_mask(gen, B, 21),
        scores=cloud.draw_scores(gen, B, S),
        normal=rnd.draw_synth2real(gen, (B, 1, S, S)),
        uniform=rnd.draw_patch_gaussian(gen, (B, 1, S, S)),
        frame=t(rng.uniform(0, 1, (B, 1, 480, 640))),
        uvd=t(np.concatenate([rng.uniform(-2, S + 2, (B, ICP_POINTS, 2)),
                              rng.uniform(100, 900, (B, ICP_POINTS, 1))],
                             -1)))


def library_calls(r, x, renders_only=False):
    """Phase 12's functions on ``r``'s device, each a thunk of its inputs
    ``x`` (already on that device): name -> callable returning its outputs
    as a list of tensors (detached; gradients appended where a backward
    runs)."""
    import torch
    from dsf_tpu_torch import geometry as geo
    from dsf_tpu_torch.losses import basic as lb, icp
    from dsf_tpu_torch.mano import spheres
    from dsf_tpu_torch.ops import (cloud, image, offset_codec as oc,
                                   rasterize as ras)
    from dsf_tpu_torch.render import renderer as rnd
    m, S = r.mano, INPUT_SIZE
    c, cu, M = x["center"], x["cube"], x["M"]

    def nograd(fn):
        def run():
            with torch.no_grad():
                out = fn()
            return list(out) if isinstance(out, (tuple, list)) else [out]
        return run

    def binned():
        ras.USE_PALLAS_SKIP = False
        try:
            return rnd.mesh_to_img(r, x["verts"], c, cu)
        finally:
            ras.USE_PALLAS_SKIP = True

    def get_depth_grad():
        v = x["verts"].clone().requires_grad_(True)
        img, juvd = rnd.get_depth(r, v, x["joints"], c, cu, M, x["rot"])
        img.sum().backward()
        return [img.detach(), juvd.detach(), v.grad]

    def icp_fn(name):
        tables = {"icp_loss": (),
                  "joint_icp_loss": (m.joint_face_mask, x["seg"]),
                  "finger_icp_loss": (m.finger_face_mask, x["segf"])}[name]

        def run():
            mesh = x["mesh"].clone().requires_grad_(True)
            pcl = x["pcl"].clone().requires_grad_(True)
            loss = getattr(icp, name)(mesh, pcl, m.faces, *tables)
            loss.sum().backward()
            return [loss.detach(), mesh.grad, pcl.grad]
        return run

    calls = {
        "normal_render": nograd(lambda: rnd.normal_render(r, x["norm"], c,
                                                          cu)),
        "m_render": nograd(lambda: rnd.m_render(r, x["raw"], c, cu, M,
                                                x["mask"])),
        "mesh_to_img": nograd(lambda: rnd.mesh_to_img(r, x["verts"], c, cu)),
        "mesh_to_img_binned": nograd(binned),
        "get_depth_grad": get_depth_grad,
    }
    if renders_only:
        return calls
    for name in ("icp_loss", "joint_icp_loss", "finger_icp_loss"):
        calls[name] = icp_fn(name)
    img, juvd, hand, jnl = x["img"], x["juvd"], x["synth"], x["jnl"]
    calls.update({
        "joint2feature": nograd(lambda: oc.joint2feature(juvd, img, (0.8,),
                                                         S // 2)),
        "feature2joint": nograd(lambda: oc.feature2joint(img, x["feature"])),
        "xyz_nl_to_uvd_nl": nograd(lambda: geo.xyz_nl_to_uvd_nl(
            x["pcl"], c, M, cu, r.paras, S)),
        "joint_to_bk_seg": nograd(lambda: cloud.joint_to_bk_seg(
            hand, jnl, c, M, cu, r.paras, S)),
        "joint_to_finger_seg": nograd(lambda: cloud.joint_to_finger_seg(
            hand, jnl, c, M, cu, r.paras, S, LIB_INTERVAL, x["bk"])),
        "joint_to_joint_seg": nograd(lambda: cloud.joint_to_joint_seg(
            hand, jnl, c, M, cu, r.paras, S, LIB_INTERVAL, x["bk"])),
        "pcl_to_joint_seg": nograd(lambda: cloud.pcl_to_joint_seg(
            x["pcl"], x["jxyz"], LIB_INTERVAL, (x["seg"] > 0).int())),
        "pcl_to_img": nograd(lambda: cloud.pcl_to_img(
            x["pcl"], S // 2, c, M, cu, r.paras, S)),
        "splat_points_min": nograd(lambda: ras.splat_points_min(x["uvd"],
                                                                S)),
        "img_to_pcl_fixed": nograd(lambda: cloud.img_to_pcl(
            None, img, c, M, cu, r.paras, S, feature_size=S)),
        "surface_loss": nograd(lambda: lb.surface_loss(
            x["scores"], img, x["mesh"], c, M, cu, r.paras, S)),
        "depth_loss_select": nograd(lambda: lb.depth_loss_select(img, hand)),
        "synth2real": nograd(lambda: rnd.synth2real(x["normal"], img)),
        "patch_gaussian": nograd(lambda: rnd.patch_gaussian(x["uniform"],
                                                            img)),
        "mass_center": nograd(lambda: rnd.mass_center(x["depth_mm"])),
        "warp_nearest": nograd(lambda: image.warp_perspective(
            x["frame"], M, (S, S))),
        "warp_bilinear": nograd(lambda: image.warp_perspective(
            x["frame"], M, (S, S), "bilinear")),
        "roi_align": nograd(lambda: image.roi_align(img, x["rois"], (32, 32),
                                                    1.0, 2)),
        "seg_pcl_21": nograd(lambda: spheres.seg_pcl_21(
            m, x["jxyz"], x["jn"], x["mesh"], x["pcl"])),
        "seg_pcl_finger": nograd(lambda: spheres.seg_pcl_finger(
            m, x["jxyz"], x["jn"], x["mesh"], x["pcl"])),
        "point2mesh_part_distance": nograd(
            lambda: spheres.point2mesh_part_distance(m, x["mesh"], x["pcl"],
                                                     x["seg"])),
        "point2sphere_distance": nograd(
            lambda: spheres.point2sphere_distance(
                m, x["jxyz"], x["mesh"], x["pcl"], x["seg"])),
        "point2sphere_distance_21": nograd(
            lambda: spheres.point2sphere_distance_21(
                m, x["jxyz"], x["mesh"], x["pcl"], x["seg21"])),
        "point2sphere_distance_finger": nograd(
            lambda: spheres.point2sphere_distance_finger(
                m, x["jxyz"], x["mesh"], x["pcl"], x["segf"])),
    })
    return calls


# how each card output is held against the CPU's: "exact" bitwise,
# ("abs", t) within t, ("rel", t) within t of the CPU's largest entry;
# renders and gradients have their own rules (hold_library)
LIB_TOL = {
    "icp_loss": ("rel", 1e-5), "joint_icp_loss": ("rel", 1e-5),
    "finger_icp_loss": ("rel", 1e-5),
    "joint2feature": ("abs", 1e-5), "feature2joint": ("abs", 1e-5),
    "xyz_nl_to_uvd_nl": ("abs", 1e-6),
    "joint_to_bk_seg": "exact", "joint_to_finger_seg": "exact",
    "joint_to_joint_seg": "exact", "pcl_to_joint_seg": "exact",
    "pcl_to_img": "exact", "splat_points_min": "exact",
    "img_to_pcl_fixed": ("abs", 1e-6), "surface_loss": ("rel", 1e-5),
    "depth_loss_select": ("rel", 1e-5), "synth2real": ("abs", 1e-6),
    "patch_gaussian": "exact", "mass_center": ("rel", 1e-5),
    "warp_nearest": "exact", "warp_bilinear": ("abs", 1e-6),
    "roi_align": ("abs", 1e-6), "seg_pcl_21": "exact",
    "seg_pcl_finger": "exact", "point2mesh_part_distance": ("rel", 1e-5),
    "point2sphere_distance": ("rel", 1e-5),
    "point2sphere_distance_21": ("rel", 1e-5),
    "point2sphere_distance_finger": ("rel", 1e-5),
}
# the renders whose vertices both devices take as the same input (no LBS
# or rotation on either), so that the raster's depths are bitwise once
# the pixels decided otherwise are out (hold_render)
LIB_SAME_VERTS = ("mesh_to_img", "mesh_to_img_binned")


def hold_render(name, got, ref, ref64=None):
    """A render card against CPU: the pixels beyond 1e-3 of the CPU's (the
    raster decides them otherwise) at most 1 in 4096 and removed; the rest
    bitwise where both devices take the same world vertices
    (LIB_SAME_VERTS).  Where each device poses or turns the hand itself,
    a vertex's rounding tilts the depth plane of a face seen nearly
    edge-on, so the rest is held to the CPU's own float64 render
    ``ref64``: the card no further from it than 3x the CPU's float32
    (phase 5's witness rule), + 1e-6.  Returns the reading."""
    d = (got - ref).abs()
    flipped = d > 1e-3
    rest = d[~flipped]
    unequal = int((rest > 0).sum())
    reading = (f"{int(flipped.sum())} of {d.numel()} px decided otherwise, "
               f"rest max {float(rest.max()):.3g}, {unequal} not bitwise")
    ok = unequal == 0
    if ref64 is not None:
        keep = ~flipped & ((ref.double() - ref64).abs() <= 1e-3)
        e_card = float((got.double() - ref64)[keep].abs().max())
        e_cpu = float((ref.double() - ref64)[keep].abs().max())
        reading += (f"; from float64 card {e_card:.3g}, CPU {e_cpu:.3g} "
                    f"(allowed 3x + 1e-6)")
        ok = e_card <= 3 * e_cpu + 1e-6
    need(float(flipped.float().mean()) <= 1 / 4096,
         f"{name}: too many pixels decided otherwise on the card: {reading}")
    need(ok, f"{name}: the card's pixels differ from the CPU's: {reading}")
    need(float((ref < FG).float().mean()) > 0.02, f"{name}: no hand")
    return reading


def hold_library(name, got, ref, ref64=None):
    """One function's card outputs against the CPU's, by LIB_TOL or the
    render and gradient rules (``ref64``: the CPU's float64 outputs, the
    witness of the renders that pose or turn the hand).  Returns the
    reading."""
    import torch
    got = [g.detach().cpu() for g in got]
    if name in LIBRARY_STEPS and name not in LIB_TOL:       # the renders
        reading = hold_render(name, got[0], ref[0],
                              None if ref64 is None else ref64[0])
        labels = 2 if name == "get_depth_grad" else len(got)
        for g, c in zip(got[1:labels], ref[1:labels]):
            e = float((g - c).abs().max())
            need(e <= 1e-4, f"{name}: labels lie {e} from the CPU's")
            reading += f"; labels {e:.3g} (allowed 1e-4)"
        if name == "get_depth_grad":
            # the hard raster gradient is ill-conditioned in float32 at
            # faces seen nearly edge-on (tests/test_torch_library_render_icp)
            g, c = got[2].double(), ref[2].double()
            far = float(((g - c).abs() > 1e-3 * c.abs().max()).float().mean())
            rel = float((g - c).norm() / c.norm())
            need(far <= 0.01 and rel <= 0.1, f"{name}: the vertex gradient "
                 f"lies {rel} relative from the CPU's, {far} of it beyond "
                 f"1e-3 of the largest")
            g64 = ref64[2]
            reading += (f"; vertex gradient {rel:.3g} relative L2, {far:.3g} "
                        f"beyond 1e-3 of the largest (allowed 0.1, 0.01); "
                        f"from float64 card "
                        f"{float((g - g64).norm() / g64.norm()):.3g}, CPU "
                        f"{float((c - g64).norm() / g64.norm()):.3g}")
        return reading
    kind = LIB_TOL[name]
    out = []
    for i, (g, c) in enumerate(zip(got, ref)):
        need(g.shape == c.shape and g.dtype == c.dtype,
             f"{name}: output {i} is {g.dtype}{tuple(g.shape)} on the card, "
             f"{c.dtype}{tuple(c.shape)} on the CPU")
        if name in ("icp_loss", "joint_icp_loss", "finger_icp_loss") and i:
            rel = float((g.double() - c.double()).norm()
                        / c.double().norm())
            need(rel <= 1e-2, f"{name}: gradient {i} lies {rel} from the "
                 f"CPU's")
            out.append(f"grad {rel:.3g} rel L2 (allowed 1e-2)")
            continue
        if kind == "exact":
            need(torch.equal(g, c), f"{name}: {int((g != c).sum())} entries "
                 f"differ from the CPU's")
            out.append("bitwise")
            continue
        fin = torch.isfinite(c)
        need(torch.equal(fin, torch.isfinite(g)),
             f"{name}: non-finite entries differ from the CPU's")
        e = float((g - c)[fin].abs().max()) if bool(fin.any()) else 0.0
        lim = kind[1] * (float(c[fin].abs().max()) if kind[0] == "rel"
                         else 1.0)
        need(e <= lim, f"{name}: lies {e} from the CPU's (allowed {lim})")
        out.append(f"{e:.3g} (allowed {lim:.3g})")
    return ", ".join(out)


def check_library_switches(gpu, cpu, xg, x):
    """The three ICP losses, forward and backward, under USE_V2_KERNEL (K7)
    and USE_CULLED_KERNEL (K8), which build their tables from no part
    table, the 15-column joint table and the 5-column finger table: the
    card against the CPU (the kernels' plain versions) on the first
    LIB_SWITCH_ROWS clouds, as ``hold_library`` holds them.  Outside the
    counted run: these launches compare kernels with their plain
    versions."""
    import torch
    from dsf_tpu_torch.ops import point_mesh as pm
    R = LIB_SWITCH_ROWS

    def rows(d):
        return {k: (v[:R] if torch.is_tensor(v) else v) for k, v in d.items()}

    xg, x = rows(xg), rows(x)
    for switch, flag in (("v2", "USE_V2_KERNEL"),
                         ("culled", "USE_CULLED_KERNEL")):
        setattr(pm, flag, True)
        try:
            card, ref = library_calls(gpu, xg), library_calls(cpu, x)
            for name in ("icp_loss", "joint_icp_loss", "finger_icp_loss"):
                say(f"  {name} under {flag} ({R} cloud): "
                    f"{hold_library(name, card[name](), ref[name]())}")
        finally:
            setattr(pm, flag, False)


def run_library(mano_path, smi, device="cuda"):
    """Phase 12: the library surface at full width (``library_calls``),
    once with the launch counts read around each call (LIBRARY_STEPS),
    then card against CPU (``hold_library``; the first LIB_COMPARE rows
    for the renders, the ICP losses and point2mesh_part_distance), then
    timed.  Returns the launch counts of the counted run.  ``device``
    "cpu" rehearses the phase without a card (no kernel launches: its
    launch checks fail)."""
    import torch
    from dsf_tpu_torch import demo, kernels
    from dsf_tpu_torch.data import pcl_utils
    from dsf_tpu_torch.mano import model as mano, spheres
    from dsf_tpu_torch.ops import cloud, image, offset_codec as oc
    from dsf_tpu_torch.render import renderer as rnd

    t0 = time.perf_counter()
    S, C = INPUT_SIZE, LIB_COMPARE
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    cpu = rnd.Renderer.create(mano.load_model(mano_path, device="cpu"), "nyu",
                              demo.PARAS, (640, 480), (S, S))
    gpu = dataclasses.replace(cpu, mano=mano.load_model(mano_path,
                                                        device=device))
    x = library_inputs(cpu, np.random.RandomState(SEED + 130),
                       torch.Generator().manual_seed(SEED + 130))
    inputs_s = time.perf_counter() - t0

    xg = {k: v.to(device) for k, v in x.items()}
    # the card's renders first: their images and joints feed the rest
    kernels.reset_launch_counts()
    got, steps = {}, {}
    for name, fn in library_calls(gpu, xg, renders_only=True).items():
        before = dict(kernels.LAUNCHES)
        got[name] = fn()
        sync()
        steps[name] = {k: kernels.LAUNCHES[k] - before[k] for k in KERNELS}
    # the rest reads the card's renders (the CPU the same values): the
    # rotated hand of get_depth and its joints (the codec, the cloud, the
    # losses), the hand of mesh_to_img with its joints in normalized units
    # (the labelers), its foreground depth in mm (mass_center); the feature
    # decoded
    # is the plain encoding of get_depth's joints, so that both devices
    # decode one input
    img, juvd = got["get_depth_grad"][0], got["get_depth_grad"][1]
    hand = got["mesh_to_img"][0]
    B = img.shape[0]
    box = torch.tensor([20.5, 20.5, 100.25, 100.25], device=device)
    extra = {"img": img, "juvd": juvd, "synth": hand,
             "jnl": (xg["joints"] - xg["center"][:, None])
             / (xg["cube"][:, None] / 2.0),
             "depth_mm": torch.where(
                 hand < FG, hand * 125.0 + xg["center"][:, 2, None, None, None],
                 torch.zeros_like(hand)),
             "rois": torch.cat([torch.arange(B, device=device)[:, None]
                                .float(), box.expand(B, 4)], 1)}
    with torch.no_grad():
        extra["feature"] = oc.joint2offset_plain(
            juvd, image.resize_nearest(img, (S // 2, S // 2)), 0.8)
    xg.update(extra)
    x.update({k: v.cpu() for k, v in extra.items()})
    with torch.no_grad():
        for d, r in ((x, cpu), (xg, gpu)):
            d["seg21"] = spheres.seg_pcl_21(r.mano, d["jxyz"], d["jn"],
                                            d["mesh"], d["pcl"])
            d["bk"] = cloud.joint_to_bk_seg(d["synth"], d["jnl"],
                                            d["center"], d["M"], d["cube"],
                                            r.paras, S)
    for name, fn in library_calls(gpu, xg).items():
        if name in got:
            continue
        before = dict(kernels.LAUNCHES)
        got[name] = fn()
        sync()
        steps[name] = {k: kernels.LAUNCHES[k] - before[k] for k in KERNELS}
    counts = dict(kernels.LAUNCHES)
    main_s = time.perf_counter() - t0
    for name, step in steps.items():
        want = LIBRARY_STEPS.get(name, launches())
        need(step == want, f"{name} launched {step}, expected {want}")
    need(counts == LIBRARY_LAUNCHES, f"phase 12 launched {counts}, expected "
         f"{LIBRARY_LAUNCHES}")

    # the CPU: the renders, the ICP losses and the part distance to every
    # vertex on the first C rows, the rest on the whole batch
    heavy = ("normal_render", "m_render", "mesh_to_img", "mesh_to_img_binned",
             "get_depth_grad", "icp_loss", "joint_icp_loss",
             "finger_icp_loss", "point2mesh_part_distance")
    xc = {k: (v[:C] if torch.is_tensor(v) else v) for k, v in x.items()}
    xc["mask"] = rnd.MaskDraws(x["mask"].n_active, x["mask"].joint_ids,
                               x["mask"].offs[:C], x["mask"].radius[:C])
    x_calls = library_calls(cpu, x)
    c_calls = library_calls(cpu, xc)
    xc64 = {k: (v.double() if torch.is_tensor(v) and v.is_floating_point()
                else v) for k, v in xc.items()}
    xc64["mask"] = rnd.MaskDraws(xc["mask"].n_active, xc["mask"].joint_ids,
                                 xc["mask"].offs.double(),
                                 xc["mask"].radius.double())
    c64_calls = library_calls(float64_renderer(cpu), xc64, renders_only=True)
    witness = ("normal_render", "m_render", "get_depth_grad")
    refs = {}
    say(f"library B={B} {S}^2, {ICP_POINTS}-point clouds: launches "
        f"{ {k: v for k, v in counts.items() if v} } (predicted K1 x4, K10 "
        f"x1, K2 x1, K3 x3, K5 x1, K4 x1); card against CPU (first {C} rows "
        f"for the renders, the ICP losses and point2mesh_part_distance):")
    for name in got:
        t1 = time.perf_counter()
        ref64 = c64_calls[name]() if name in witness else None
        if name == "mesh_to_img_binned":
            # the CPU's routes give one image (tests/test_torch_raster*)
            ref = refs["mesh_to_img"]
        elif name in heavy:
            ref = c_calls[name]()
        else:
            ref = x_calls[name]()
        refs[name] = ref
        card = got[name]
        if name in heavy:
            card = [g[:C] if g.dim() and g.shape[0] == B else g for g in card]
        say(f"  {name}: {hold_library(name, card, ref, ref64)} (CPU "
            f"{time.perf_counter() - t1:.2f} s)")
    check_library_switches(gpu, cpu, xg, x)
    # pcl_utils, the host's numpy tools, on a card render
    cloud_np = pcl_utils.get_pcl(x["synth"][0, 0].double().numpy(),
                                 x["center"][0].double().numpy(),
                                 x["cube"][0].double().numpy(),
                                 x["M"][0].double().numpy(), cpu.paras)
    need(cloud_np.shape[0] > 100 and np.isfinite(cloud_np).all(),
         "pcl_utils.get_pcl: no finite cloud from the card's render")
    sampled = pcl_utils.pca_point(cloud_np, x["jnl"][0].double().numpy(),
                                  512)[0]
    need(sampled.shape == (512, 3) and np.isfinite(sampled).all(),
         "pcl_utils.pca_point: no finite 512-point cloud")
    say(f"  pcl_utils: get_pcl of the card's first render "
        f"{cloud_np.shape[0]} points, pca_point 512, finite")
    compare_s = time.perf_counter() - t0 - main_s

    ms = {}
    for name, fn in library_calls(gpu, xg).items():
        ms[name] = round(time_ms(fn, LIB_ITERS, warmup=1), 4)
    say(f"library ms a call (CUDA events, {LIB_ITERS} calls each; the ICP "
        f"losses and get_depth_grad forward and backward): {json.dumps(ms)}; "
        f"{smi}")
    say(f"phase 12: {time.perf_counter() - t0:.1f} s (inputs on the CPU "
        f"{inputs_s:.1f} s, card run {main_s - inputs_s:.1f} s, CPU "
        f"comparison {compare_s:.1f} s)")
    return counts


def phase12_alone():
    """``--phase12``: the kernels' build, then phase 12 alone; prints no
    result line."""
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.kernels import build
    from dsf_tpu_torch.mano import synthetic
    smi = nvidia_smi_line()
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp, exact_float32():
        path = os.path.join(tmp, "mano_synthetic.npz")
        synthetic.save_synthetic_mano(path)
        counts = run_library(path, smi)
    say("phase 12 alone: " + json.dumps(counts))
    return 0


# ----------------------------------------------------------------- phase 13

DEEP_NETS = ("ResNet_stage_50", "ResNet_stage_101", "ResNet_stage_152")
R50 = DEEP_NETS[0]
DEEP_REQUESTS = (1, 5)          # card against CPU: buckets 1 and 8
DEEP_LATENCY_CALLS = 10
REMAT_NET = DEEP_NETS[-1]
REMAT_BATCH = 32
REMAT_PROBES = (4, 8)           # batches whose peaks size the runs without remat
MEMORY_SHARE = 0.85             # of the card's memory a batch may plan on
DEEP_EXPORT_BUCKET = 32
CLI_BATCH = 64                  # four steps an epoch on phase 6's 256 frames
PEAK_BYTES = {}                 # peak device memory by path tag


@contextlib.contextmanager
def drawn_once():
    """``random_reference_state_dict`` memoized for the duration, by the
    generator's state, ``refine`` and ``depth``, in ``demo`` and the
    trainer: the engines and trainers of one depth share a draw (a
    152-layer draw takes seconds on the host).  The state dicts are only
    read (``load_into`` copies them)."""
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.models import weights
    from dsf_tpu_torch.training import trainer as T
    memo = {}

    def draw(rng, refine=True, depth=18):
        st = rng.get_state()
        key = (st[1].tobytes(), st[2], refine, depth)
        if key not in memo:
            memo[key] = weights.random_reference_state_dict(rng, refine, depth)
        return memo[key]

    saved = demo.random_reference_state_dict, T.random_reference_state_dict
    demo.random_reference_state_dict = T.random_reference_state_dict = draw
    try:
        yield
    finally:
        demo.random_reference_state_dict, T.random_reference_state_dict = saved


def start_deep_export(mano_path, tmp, rng):
    """Phase 13's export: the depth-50 engine (``demo.engine``, the same
    seed) exported at bucket DEEP_EXPORT_BUCKET by a child process
    (``--phase11-export``) started now, so that it traces while the card
    serves and trains.  Returns (the process, the job file, the request)."""
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.config import CAMERA
    from dsf_tpu_torch.mano import model as mano
    from dsf_tpu_torch.render import renderer as rnd
    r = rnd.Renderer.create(mano.load_model(mano_path, device="cuda"), "nyu",
                            CAMERA["nyu"][0], (640, 480),
                            (INPUT_SIZE, INPUT_SIZE))
    req = demo.requests(r, DEEP_EXPORT_BUCKET, rng)
    name = f"export_r50_f32_b{DEEP_EXPORT_BUCKET}"
    np.savez(os.path.join(tmp, "req_r50.npz"),
             **dict(zip(("img", "center", "M", "cube"), req)))
    job = {"name": name, "mano": mano_path, "dtype": "float32",
           "bucket": DEEP_EXPORT_BUCKET, "skip": True, "net": R50,
           "timed": False, "path": os.path.join(tmp, name + ".pt2"),
           "request": os.path.join(tmp, "req_r50.npz"),
           "out": os.path.join(tmp, name + "_out.npz"),
           "report": os.path.join(tmp, name + "_report.json"),
           "ready": tmp, "jobs": 1, "lock": os.path.join(tmp, "lock")}
    path = os.path.join(tmp, name + ".json")
    with open(path, "w") as f:
        json.dump(job, f)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase11-export", path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, path, req


def load_deep_export(proc, job_path, t_start):
    """Wait for the export child, then start the loader child (an untimed
    ``--phase11-load``: no model code, one call with its launches).
    Returns (the loader process, the s waited since the export began)."""
    _, err = proc.communicate(timeout=900)
    need(proc.returncode == 0, f"the depth-50 export failed:\n{err[-3000:]}")
    wait_s = time.perf_counter() - t_start
    loader = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase11-load",
         job_path], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return loader, wait_s


def check_deep_export(loader, job_path, live, wait_s, smi):
    """The loader child's report: no model code imported, depth 18's
    launches a call, and its outputs against live ``predict`` (``live``)
    at phase 11's tolerances.  Returns the call's launch counts."""
    _, err = loader.communicate(timeout=600)
    need(loader.returncode == 0, f"loading the depth-50 export failed:\n"
         f"{err[-3000:]}")
    with open(job_path) as f:
        job = json.load(f)
    with open(job["report"]) as f:
        row = json.load(f)
    with open(job["path"] + ".json") as f:
        export_s = json.load(f)["export_s"]
    need(not row["model_code"], f"loading the depth-50 artifact imported "
         f"the model code: {row['model_code']}")
    need(row["launches"] == EXPORT_LAUNCHES, f"the depth-50 artifact's call "
         f"launched {row['launches']}, not {EXPORT_LAUNCHES}")
    out = np.load(job["out"])
    diff = {k: float(np.abs(out[k] - live[k]).max()) for k in live}
    for k, d in diff.items():
        need(d <= atol_for(k), f"the depth-50 artifact: {k} differs from "
             f"live predict by {d} > {atol_for(k)}")
    s1 = max(d for k, d in diff.items() if k.endswith("_0"))
    s2 = max(d for k, d in diff.items() if not k.endswith("_0"))
    say(f"{job['name']}: export {export_s:.2f} s (in a child process while "
        f"the card served and trained; done {wait_s:.1f} s after its "
        f"start), {os.path.getsize(job['path']) / 2**20:.1f} MB, load "
        f"{row['load_s']:.2f} s (in a child process while the card ran "
        f"the remat steps); launches a call "
        f"{ {k: v for k, v in row['launches'].items() if v} }; against live "
        f"predict max abs stage 1 {s1:.3g}, stage 2 {s2:.3g} (allowed "
        f"{atol_for('x_mm_0')} / {atol_for('x_mm_1')} mm); {smi}")
    return row["launches"]


def deep_serving(mano_path, net, rng, smi, dtype="float32", f32=None):
    """The two-stage engine with the trunks of ``net`` on the card in
    ``dtype``: requests of DEEP_REQUESTS crops, each one bucket call
    launching what depth 18's does (K1, K5, K4 x2), outputs finite, the
    stage-2 render of the largest request covering > 2%; the card against
    the CPU engine (``atol_for``; in bfloat16 the witness rule of phase 3
    against ``f32``, the float32 engines' requests and outputs); the
    median latency per bucket.  Returns (launch counts, the card engine,
    {"reqs", "gpu", "cpu"})."""
    import torch
    from dsf_tpu_torch import demo, kernels
    from dsf_tpu_torch.render import renderer as rnd

    tag = f"serve{'' if dtype == 'float32' else '_bf16'}{net_tag(net)}"
    eng = demo.engine(mano_path, "cuda", INPUT_SIZE, BUCKETS, SEED,
                      compute_dtype=dtype, net=net)
    cpu = demo.engine(mano_path, "cpu", INPUT_SIZE, BUCKETS, SEED,
                      compute_dtype=dtype, net=net)
    reqs = (f32["reqs"] if f32 else
            [demo.requests(eng.renderer, n, rng) for n in DEEP_REQUESTS])
    eng.warmup()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = [eng.predict(*r) for r in reqs]
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    calls = len(reqs)
    need(counts == launches(raster_skip=calls, codec_encode=calls,
                            codec_decode=2 * calls),
         f"{tag}: predict did not launch depth 18's kernels once a call: "
         f"{counts}")
    for r, out in zip(reqs, outs):
        for k, v in out.items():
            need(v.shape[0] == len(r[0]) and np.isfinite(v).all(),
                 f"{tag}: {k} not finite or of shape {v.shape}")
    r = reqs[-1]
    with torch.inference_mode():
        img2, _, _, _ = rnd.render_params(
            eng.renderer, torch.from_numpy(outs[-1]["mano_para_0"]).cuda(),
            torch.from_numpy(r[1]).cuda(), torch.from_numpy(r[3]).cuda(),
            img_stride=2)
    cover = float((img2 < FG).float().mean())
    need(cover > 0.02, f"{tag}: the stage-2 render covers {cover} <= 2%")
    t0 = time.perf_counter()
    refs = [cpu.predict(*r) for r in reqs]
    cpu_s = time.perf_counter() - t0
    worst = {}
    for out, ref in zip(outs, refs):
        for k in out:
            worst[k] = max(worst.get(k, 0.0),
                           float(np.abs(out[k] - ref[k]).max()))
    fmt = lambda d: json.dumps({k: float(f"{v:.3g}") for k, v in d.items()
                                if "mm" in k})
    if f32 is None:
        for k, d in worst.items():
            need(d <= atol_for(k), f"{tag}: {k} differs from the CPU engine "
                 f"by {d} > {atol_for(k)}")
        say(f"{tag} launches over requests {DEEP_REQUESTS}: "
            f"{json.dumps({k: v for k, v in counts.items() if v})} (depth "
            f"18's per call); stage-2 render coverage {cover:.4f}; card vs "
            f"CPU engine max abs (mm keys; CPU {cpu_s:.1f} s): {fmt(worst)}")
    else:
        witness, gpu_f32 = {}, {}
        for out, ref, c32, g32 in zip(outs, refs, f32["cpu"], f32["gpu"]):
            for k in out:
                witness[k] = max(witness.get(k, 0.0),
                                 float(np.abs(ref[k] - c32[k]).max()))
                gpu_f32[k] = max(gpu_f32.get(k, 0.0),
                                 float(np.abs(out[k] - g32[k]).max()))
        for k in witness:
            tol = BF16_SERVE_RATIO * witness[k] + atol_for(k)
            need(worst[k] <= tol and gpu_f32[k] <= tol, f"{tag} {k}: the "
                 f"card's engine lies {worst[k]} from the CPU's and "
                 f"{gpu_f32[k]} from its float32 one (allowed {tol})")
            need(gpu_f32[k] >= witness[k] / BF16_SERVE_RATIO, f"{tag} {k}: "
                 f"the card's engine lies only {gpu_f32[k]} from its float32 "
                 f"one against the CPU's {witness[k]}: not bfloat16")
        say(f"{tag} launches {json.dumps({k: v for k, v in counts.items() if v})}; "
            f"coverage {cover:.4f}; max abs (mm keys) card vs CPU "
            f"{fmt(worst)}, CPU bf16 vs CPU f32 (the witness) "
            f"{fmt(witness)}, card bf16 vs card f32 {fmt(gpu_f32)}")
    lat = predict_latency(eng, rng, DEEP_LATENCY_CALLS)
    top = BUCKETS[-1]
    say(f"{tag} median predict latency ms per bucket ({DEEP_LATENCY_CALLS} "
        "calls, host clock, to numpy): " + json.dumps(lat)
        + f"; bucket {top} throughput {top * 1e3 / lat[top]:.1f} images/s; "
        f"{smi}")
    return counts, eng, {"reqs": reqs, "gpu": outs, "cpu": refs}


def remat_step(tr, state, batch, draws, remat):
    """One FinetuneStage step with DSF_REMAT set to ``remat``: (loss,
    gradients, running statistics, ms to a synchronized loss, peak
    memory since the step began)."""
    import torch
    os.environ["DSF_REMAT"] = "1" if remat else "0"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = tr.train_step_fn("FinetuneStage")(state, draws, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        os.environ.pop("DSF_REMAT", None)
    net = state.net
    return (loss, {n: p.grad for n, p in net.named_parameters()},
            {n: b for n, b in net.named_buffers() if "running" in n}, ms,
            torch.cuda.max_memory_allocated())


def run_remat(mano_path, smi):
    """FinetuneStage at depth 152 with DSF_REMAT=0 and 1.  The batch comes
    from a measurement: one step without remat at each of REMAT_PROBES
    gives its peak memory, extrapolated linearly in B; the runs without
    remat take B=32 where that stays within MEMORY_SHARE of the card,
    else the largest multiple of 4 that does, and remat also runs alone
    at B=32.  At the compared batch one step from the same state and
    batch with each setting, under cuDNN's and PyTorch's deterministic
    algorithms: loss, gradients and running statistics bitwise.  With
    the default algorithms the card's own steps do not repeat bitwise
    (nor does a train-mode forward's BatchNorm statistics): a second
    step without remat, the control, and the remat step are printed
    against the first.  Then TRAIN_STEPS steps of each setting (default
    algorithms), median ms and peak memory.  Returns the launch counts of
    the remat run at B=32 (depth 18's per step)."""
    import torch
    from dsf_tpu_torch import demo, kernels
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.training.trainer import Trainer

    need(not torch.backends.cudnn.benchmark, "cuDNN's benchmark is on")
    tr = Trainer(train_config(mano_path, 2, SEED, net=REMAT_NET), mano_path,
                 device="cuda")
    state = tr.init_state()
    host = lambda d: {k: v.detach().cpu().clone() if torch.is_tensor(v)
                      else v for k, v in d.items()}
    snap = {"net": host(state.net.state_dict()),
            "optimizer": host(state.optimizer.state_dict())}
    para, cube = next(random_param_source(REMAT_BATCH, seed=SEED + 140))
    real = demo.real_batch(tr.renderer, REMAT_BATCH,
                           np.random.RandomState(SEED + 141))

    def batch(B):
        return dict({k: v[:B] for k, v in real.items()},
                    model_para=para[:B], cube_synth=cube[:B])

    def reset():
        state.net.load_state_dict(snap["net"])
        state.optimizer.load_state_dict(snap["optimizer"])

    peaks = {}
    for B in REMAT_PROBES:
        reset()
        peaks[B] = remat_step(tr, state, batch(B),
                              tr.draw(B, "FinetuneStage"), False)[4]
    total = torch.cuda.get_device_properties(0).total_memory
    b0, b1 = REMAT_PROBES
    fit = lambda B: peaks[b0] + (peaks[b1] - peaks[b0]) / (b1 - b0) * (B - b0)
    B_plain = max(B for B in range(4, REMAT_BATCH + 1, 4)
                  if B == 4 or fit(B) <= MEMORY_SHARE * total)
    say(f"remat {REMAT_NET} FinetuneStage: peak memory without remat at B="
        f"{REMAT_PROBES} {[round(peaks[b] / 2**30, 3) for b in REMAT_PROBES]}"
        f" GiB, extrapolated to B={REMAT_BATCH} {fit(REMAT_BATCH) / 2**30:.2f}"
        f" GiB of {total / 2**30:.1f} (planned within {MEMORY_SHARE}): the "
        f"runs without remat take B={B_plain}")

    def distance(a, b):
        """(losses equal, gradients not bitwise, their largest relative
        L2, statistics not bitwise, their largest share of the tensor's
        largest entry) of step b from step a."""
        g_off = [k for k in a[1] if not torch.equal(a[1][k], b[1][k])]
        s_off = [k for k in a[2] if not torch.equal(a[2][k], b[2][k])]
        g = max((float((b[1][k] - a[1][k]).norm()
                       / a[1][k].norm().clamp_min(1e-30)) for k in g_off),
                default=0.0)
        st = max((float((b[2][k] - a[2][k]).abs().max()
                        / a[2][k].abs().max()) for k in s_off), default=0.0)
        return a[0] == b[0], len(g_off), g, len(s_off), st

    draws = tr.draw(B_plain, "FinetuneStage")
    got = {}
    for det, runs in ((True, ("plain", "remat")),
                      (False, ("plain", "again", "remat"))):
        with (deterministic_algorithms() if det
              else contextlib.nullcontext()):
            for run in runs:
                reset()
                loss, grads, stats, _, _ = remat_step(
                    tr, state, batch(B_plain), draws, run == "remat")
                got[det, run] = (
                    loss, {k: v.detach().cpu() for k, v in grads.items()},
                    {k: v.detach().cpu() for k, v in stats.items()})
    det = distance(got[True, "plain"], got[True, "remat"])
    fmt = lambda d: (f"loss equal {d[0]}, gradients not bitwise {d[1]} of "
                     f"{len(got[True, 'plain'][1])} (largest relative L2 "
                     f"{d[2]:.3g}), running statistics not bitwise {d[3]} "
                     f"of {len(got[True, 'plain'][2])} (largest {d[4]:.3g} "
                     f"of the tensor's scale)")
    say(f"remat {REMAT_NET} FinetuneStage B={B_plain}, one step from the "
        f"same state, deterministic algorithms, DSF_REMAT=1 against 0: "
        f"{fmt(det)}")
    say(f"remat {REMAT_NET} FinetuneStage B={B_plain}, default algorithms: "
        f"DSF_REMAT=0 again against 0 (the control): "
        f"{fmt(distance(got[False, 'plain'], got[False, 'again']))}; "
        f"DSF_REMAT=1 against 0: "
        f"{fmt(distance(got[False, 'plain'], got[False, 'remat']))}")
    need(det[0] and not det[1] and not det[3], "DSF_REMAT=1 is not bitwise "
         "DSF_REMAT=0 on the card under deterministic algorithms")

    # TRAIN_STEPS steps of each, timed
    runs = [(False, B_plain), (True, B_plain)]
    if B_plain != REMAT_BATCH:
        runs.append((True, REMAT_BATCH))
    counts = None
    for remat, B in runs:
        reset()
        draws = [tr.draw(B, "FinetuneStage") for _ in range(TRAIN_STEPS)]
        kernels.reset_launch_counts()
        ms, peak = [], 0
        for d in draws:
            before = dict(kernels.LAUNCHES)
            loss, _, _, t, p = remat_step(tr, state, batch(B), d, remat)
            delta = {k: kernels.LAUNCHES[k] - before[k]
                     for k in kernels.LAUNCHES}
            need(delta == FS_STEP_LAUNCHES and np.isfinite(loss),
                 f"remat={remat} B={B}: launches {delta}, loss {loss}")
            ms.append(t)
            peak = max(peak, p)
        if remat and B == REMAT_BATCH:
            counts = dict(kernels.LAUNCHES)
        say(f"remat {REMAT_NET} FinetuneStage B={B} DSF_REMAT="
            f"{int(remat)}: step ms {[round(t, 2) for t in ms]}, median "
            f"{float(np.median(ms)):.2f} ms ({2 * B * 1e3 / float(np.median(ms)):.1f}"
            f" images/s); peak memory {peak / 2**30:.3f} GiB; {smi}")
    return counts


def run_deep_cli(mano_path, smi, root):
    """``python -m dsf_tpu_torch.training --net ResNet_stage_50``'s main on
    phase 6's fake NYU set (``root``), in this process so that the epoch
    count can be set: one epoch of FinetuneStage at B=CLI_BATCH (four
    steps; B=32, eight steps, where twice the B=32 step's measured peak
    would not stay within MEMORY_SHARE of the card) with its per-epoch
    test, latest and best, and the 3-view evaluation; each step's and eval
    batch's launches depth 18's; then a run resumed from it (one more
    epoch), and its checkpoint restored on the card bitwise; then a
    depth-18 checkpoint given to the depth-50 command line, which must
    raise, naming the keys, before any step.  Returns the launch counts
    of the first run."""
    import torch
    from dsf_tpu_torch import kernels
    from dsf_tpu_torch.training import __main__ as cli
    from dsf_tpu_torch.training import checkpoints as ck
    from dsf_tpu_torch.training.trainer import Trainer

    total = torch.cuda.get_device_properties(0).total_memory
    batch = (CLI_BATCH if 2 * PEAK_BYTES["finetune_stage_r50"]
             <= MEMORY_SHARE * total else TRAIN_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--net", R50, "--root_dir", root, "--mano_model_path",
                mano_path, "--save_dir", os.path.join(tmp, "ckpt"),
                "--transferNet_pth", STAND_IN, "--batch_size", str(batch),
                "--image_every", "0"]
        rec = {}
        t0 = time.perf_counter()
        with max_epochs(1), watched_loop(rec):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            cli.main(argv + ["--add_info", "r50"])
            torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)
        secs = time.perf_counter() - t0
        cfg = cli.parse_config(argv + ["--add_info", "r50"])
        run_dir = os.path.join(cfg.save_dir, "nyu", cfg.run_name())
        steps = FAKE_TRAIN // batch
        evals = 4 * -(-FAKE_TEST // batch)
        need(len(rec["steps"]) == steps and len(rec["evals"]) == evals,
             f"the depth-50 CLI ran {len(rec['steps'])} steps and "
             f"{len(rec['evals'])} eval batches, not {steps} and {evals}")
        need(all(d == FS_STEP_LAUNCHES for d in rec["steps"])
             and all(d == EVAL_LAUNCHES for d in rec["evals"]),
             f"the depth-50 CLI's launches: {rec['steps']} {rec['evals']}")
        losses = [float(m["loss"]) for m in rec["metrics"]]
        errs = torch.stack(rec["errors"]).cpu().numpy()
        need(np.isfinite(losses).all() and np.isfinite(errs).all(),
             "the depth-50 CLI: a non-finite loss or eval error")
        for name in ("latest", "best"):
            need(os.path.exists(os.path.join(run_dir, name, ck.FILE)),
                 f"the depth-50 CLI wrote no {name}")
        for view in range(3):
            rows = np.loadtxt(os.path.join(run_dir, f"result_1_{view}.txt"))
            need(rows.shape == (FAKE_TEST, 63) and np.isfinite(rows).all(),
                 f"the depth-50 CLI's result_1_{view}: {rows.shape}")
        say(f"cli {R50}: {steps} FinetuneStage steps of B={batch} and "
            f"{evals} eval batches in {secs:.1f} s (the process's whole "
            f"run: trainer, loader, epoch, checkpoints, 3-view evaluation); "
            f"losses {[float(f'{x:.6g}') for x in losses]}; epoch "
            f"{rec['epochs'][0]:.2f} s; 3-view evaluation "
            f"{rec['views_s'][-1]:.2f} s; eval errors mm (mean per row) "
            f"{np.round(errs.mean(axis=(0, 2)), 3).tolist()}; {smi}")

        rec2 = {}
        with max_epochs(2), watched_loop(rec2):
            cli.main(argv + ["--add_info", "r50_resume", "--load_model",
                             run_dir, "--test_during_train", "false"])
        state, epoch = rec2["restored"][0]
        need(epoch == 1 and len(rec2["steps"]) == steps
             and all(np.isfinite(float(m["loss"])) for m in rec2["metrics"])
             and int(state.updates) == 2 * steps,
             f"the depth-50 resume: epoch {epoch}, {len(rec2['steps'])} "
             f"steps, updates {int(state.updates)}")
        need(all(d == FS_STEP_LAUNCHES for d in rec2["steps"]),
             f"the depth-50 resume's launches: {rec2['steps']}")
        # the restore itself: the saved net and AdamW moments, on the card
        tr = Trainer(cfg, mano_path, device="cuda")
        state, _ = ck.restore(run_dir, tr, tr.init_state())
        saved = torch.load(os.path.join(run_dir, "latest", ck.FILE),
                           map_location="cpu", weights_only=True)
        pairs = list(state.net.state_dict().items()) + [
            (f"optimizer.{k}", v) for k, v in state.optimizer.buffers.items()]
        ref = dict(saved["net"], **{f"optimizer.{k}": v
                                    for k, v in saved["optimizer"].items()})
        off = [k for k, v in pairs if v.device.type != "cuda"
               or not torch.equal(v.cpu(), ref[k])]
        need(not off, f"the depth-50 restore: tensors off the card or not "
             f"bitwise the saved ones: {off[:5]}")
        say(f"cli {R50} resume: epoch {epoch}, {len(rec2['steps'])} more "
            f"steps, updates {int(rec2['restored'][0][0].updates)}; the "
            f"checkpoint's {len(pairs)} tensors restored on the card "
            f"bitwise")

        # a depth-18 checkpoint into the depth-50 command line
        cfg18 = cfg.replace(net="ResNet_stage_18", transferNet_pth="")
        tr18 = Trainer(cfg18, mano_path, device="cuda")
        path18 = os.path.join(tmp, "r18")
        ck.save(path18, tr18, tr18.init_state(), 0)
        ck.wait_until_finished()
        rec3 = {}
        with max_epochs(1), watched_loop(rec3):
            try:
                cli.main(argv + ["--add_info", "r50_from18", "--load_model",
                                 path18])
                refused = None
            except RuntimeError as e:
                refused = str(e)
        need(refused is not None and "layer1.0.conv3.weight" in refused
             and not rec3["steps"], f"the depth-18 checkpoint was not "
             f"refused before any step: {refused!r}, {len(rec3['steps'])} "
             "steps")
        say(f"cli {R50} from a depth-18 checkpoint: refused before any "
            f"step: {refused[:160]}...")
    return counts


def run_deep(mano_path, smi, root):
    """Phase 13: the ResNet-50/101/152 trunks on every entry point, and
    DSF_REMAT.  Returns the launch counts by path."""
    import torch
    t0 = time.perf_counter()
    by_path = {}
    rng = np.random.RandomState(SEED + 130)
    with tempfile.TemporaryDirectory() as tmp, drawn_once():
        export = start_deep_export(mano_path, tmp, rng)
        f32 = None
        for net in DEEP_NETS:
            counts, eng, outs = deep_serving(mano_path, net, rng, smi)
            by_path[f"serve{net_tag(net)}"] = counts
            if net == R50:
                f32, live_eng = outs, eng
        by_path["serve_bf16_r50"], _, _ = deep_serving(
            mano_path, R50, rng, smi, "bfloat16", f32)
        req = export[2]
        live = live_eng.predict(*req)
        serve_s = time.perf_counter() - t0

        t1 = time.perf_counter()
        for dtype, bf in (("float32", ""), ("bfloat16", "_bf16")):
            by_path[f"train{bf}_r50"] = run_training(mano_path, dtype, R50)
            by_path[f"finetune_stage{bf}_r50"] = run_self_supervised(
                mano_path, "FinetuneStage", dtype=dtype, net=R50)
            by_path[f"finetune{bf}_r50"] = run_self_supervised(
                mano_path, "Finetune", dtype=dtype, net=R50)
        for tag in ("train", "finetune_stage", "finetune"):
            for bf in ("", "_bf16"):
                if f"{tag}{bf}" in STEP_MEDIAN_MS:
                    say(f"{tag}{bf}: median step {STEP_MEDIAN_MS[tag + bf]:.2f}"
                        f" ms at depth 18 (phase 4), "
                        f"{STEP_MEDIAN_MS[tag + bf + '_r50']:.2f} ms at 50")
        steps_s = time.perf_counter() - t1

        loader, wait_s = load_deep_export(export[0], export[1], t0)
        t1 = time.perf_counter()
        by_path["finetune_stage_remat_r152"] = run_remat(mano_path, smi)
        remat_s = time.perf_counter() - t1
        by_path[f"export_r50_f32_b{DEEP_EXPORT_BUCKET}"] = check_deep_export(
            loader, export[1], live, wait_s, smi)
        export_s = time.perf_counter() - t1 - remat_s
        compare_s = []
        for compare in (compare_step, compare_finetune_stage,
                        compare_finetune):
            t1 = time.perf_counter()
            compare(mano_path, net=R50, **({} if compare is compare_finetune
                                           else {"bf16": False}))
            compare_s.append(round(time.perf_counter() - t1, 1))
        del live_eng
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        by_path["cli_r50"] = run_deep_cli(mano_path, smi, root)
        cli_s = time.perf_counter() - t1
    say(f"phase 13: {time.perf_counter() - t0:.1f} s (serving "
        f"{serve_s:.1f}, steps {steps_s:.1f}, remat {remat_s:.1f}, the "
        f"export's load after them {export_s:.1f}, card vs CPU "
        f"{sum(compare_s):.1f} (Pretrain, FinetuneStage, Finetune "
        f"{compare_s}), CLI {cli_s:.1f})")
    return by_path


def phase13_alone():
    """``--phase13``: the kernels' build, phase 6's fake NYU set (K6), then
    phase 13 alone; prints no result line."""
    import torch
    from dsf_tpu_torch.data.fake import make_fake_nyu
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.kernels import build
    from dsf_tpu_torch.mano import synthetic
    smi = nvidia_smi_line()
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp, exact_float32():
        path = os.path.join(tmp, "mano_synthetic.npz")
        synthetic.save_synthetic_mano(path)
        root = os.path.join(tmp, "fake_nyu")
        make_fake_nyu(root, path, n_train=FAKE_TRAIN, n_test=FAKE_TEST,
                      seed=SEED, batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()
        by_path = run_deep(path, smi, root)
    say("phase 13 alone: " + json.dumps(by_path))
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--phase11-load"]:
        # before any model code is imported: the child loads an artifact
        # with load_exported's module alone
        return load_artifact(sys.argv[2])
    if sys.argv[1:2] == ["--phase11-export"]:
        return export_artifact(sys.argv[2])
    try:
        from dsf_tpu_torch import demo
        from dsf_tpu_torch.device import exact_float32
        from dsf_tpu_torch.kernels import build
        from dsf_tpu_torch.mano import model as mano, synthetic
        from dsf_tpu_torch.render import renderer as rnd
    except ImportError as e:
        print(f"chip_smoke: the dsf_tpu_torch package is missing ({e}); run "
              "from the root of the repository", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--phase9-rank"]:
        return parallel_rank(sys.argv[2])
    if sys.argv[1:2] == ["--phase9"]:
        return phase9_alone()
    if sys.argv[1:2] == ["--phase10"]:
        return phase10_alone()
    if sys.argv[1:2] == ["--phase11"]:
        return phase11_alone()
    if sys.argv[1:2] == ["--phase12"]:
        return phase12_alone()
    if sys.argv[1:2] == ["--phase13"]:
        return phase13_alone()

    smi = nvidia_smi_line()
    say(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    msgs = build.build_all(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    say(f"build: {len(msgs)} sources in {secs:.1f} s (one nvcc each, parallel)")
    for name, text in msgs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                say(f"  ptxas {name}: {line.strip()}")

    record = []
    marks = [("build", time.perf_counter())]
    with tempfile.TemporaryDirectory() as tmp, exact_float32():
        path = os.path.join(tmp, "mano_synthetic.npz")
        synthetic.save_synthetic_mano(path)
        renderer = rnd.Renderer.create(mano.load_model(path, device="cuda"),
                                       "nyu", demo.PARAS, (640, 480),
                                       (INPUT_SIZE, INPUT_SIZE))
        rng = np.random.RandomState(SEED)
        with torch.inference_mode():
            record.append(check_raster(renderer, KERNEL_BATCH, 2, rng,
                                       record=True))
            check_raster(renderer, KERNEL_BATCH, 1, rng, record=False)
            check_raster_cases(renderer, KERNEL_BATCH, rng)
            record += check_codec(renderer, KERNEL_BATCH, rng)
        record.append(check_moments_shapes(renderer, rng))
        record += check_codec_bwd(renderer, KERNEL_BATCH, rng)
        with torch.inference_mode():
            sc = icp_scene(renderer, 2 * TRAIN_BATCH, rng)
            record.append(check_point_mesh(sc))
            record.append(check_tail_conv(renderer, TRAIN_BATCH, rng))
            record.append(check_tail_conv_bf16(renderer, TRAIN_BATCH, rng))
            record.append(check_icp_v2(sc))
            record.append(check_icp_culled(sc))
            record.append(check_raster_dense(renderer, PRERENDER_BATCH, rng))
            check_raster_binned(renderer, KERNEL_BATCH, 2, rng)
            check_raster_binned(renderer, KERNEL_BATCH, 1, rng)
        marks.append(("kernels", time.perf_counter()))
        by_path = {}
        by_path["serve"], by_path["serve_binned"], k10, f32 = run_slice(path)
        record.append(k10)
        by_path["serve_bf16"] = run_slice_bf16(path, f32)
        marks.append(("slice", time.perf_counter()))
        by_path["train"] = run_training(path)
        by_path["finetune_stage"] = run_self_supervised(path, "FinetuneStage")
        by_path["finetune_stage_v2"] = run_self_supervised(
            path, "FinetuneStage", icp="v2")
        by_path["finetune_stage_culled"] = run_self_supervised(
            path, "FinetuneStage", icp="culled")
        by_path["finetune"] = run_self_supervised(path, "Finetune")
        by_path["train_bf16"] = run_training(path, "bfloat16")
        by_path["finetune_stage_bf16"] = run_self_supervised(
            path, "FinetuneStage", dtype="bfloat16")
        by_path["finetune_bf16"] = run_self_supervised(path, "Finetune",
                                                       dtype="bfloat16")
        by_path["prerender"] = run_prerender(path)
        marks.append(("training", time.perf_counter()))
        compare_bf16_layers(np.random.RandomState(SEED + 40))
        compare_step(path)
        compare_finetune_stage(path)
        compare_finetune_stage(path, "icvl")
        compare_finetune(path)
        compare_m2p(path)
        marks.append(("GPU = CPU", time.perf_counter()))
        fake_nyu = os.path.join(tmp, "fake_nyu")
        for name, phase in (
                ("loop", lambda: run_loop(path, smi, fake_nyu)),
                ("datasets", lambda: run_datasets(path, smi)),
                ("cyclegan", lambda: run_cyclegan_phase(path, smi, fake_nyu)),
                ("parallel", lambda: run_parallel(path, smi)),
                ("ccssl", lambda: run_ccssl_phase(path, smi, fake_nyu)),
                ("export", lambda: run_export_phase(path, smi)),
                ("library", lambda: {"library": run_library(path, smi)}),
                ("deep", lambda: run_deep(path, smi, fake_nyu))):
            by_path.update(phase())
            marks.append((name, time.perf_counter()))
    say("phase seconds: " + json.dumps(
        {name: round(t - t_prev, 1) for (_, t_prev), (name, t)
         in zip(marks, marks[1:])}))
    need(sorted(r["name"] for r in record) == sorted(KERNELS),
         "the kernels' record does not list every kernel once")
    for rec in record:
        rec["launches_by_path"] = {k: v[rec["name"]] for k, v in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        need(rec["launches"] > 0, f"{rec['name']} never launched on a path")
    say(json.dumps({"kernels": record}))
    say(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
