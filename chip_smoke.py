#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dsf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printed on its own line(s); any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), and the build of
   every CUDA kernel from csrc/ (one nvcc per source, in parallel), timed,
   with ptxas's register and shared-memory report;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving and training paths give it (K1 skip-raster and
   K2 raster moments at B=32 with 64x64 and 128x128 pixels; K5 encode,
   K4 decode and their VJPs at B=32, J=21, S=64; K3 point->mesh argmin at
   the FinetuneStage step's 128 clouds x 2048 points x 1554 faces under the
   ICP's 16-column part table; K9, the CycleGAN generator's tail conv, on
   the generator's own head input at the training steps' B=32, 64 x 134^2,
   from the seeded stand-in generator on rendered hands): error, kernel
   and plain
   device time (CUDA events, warm L2, the host's enqueue hidden behind a
   sleep kernel), the time of one PyTorch library call computing the same
   function where there is one, and the bound (the larger of bytes over
   3.35 TB/s and float operations over 67 TFLOP/s, the H100 SXM's
   published float32 non-tensor rate);
3. slice: the two-stage ManoOCRStage InferenceEngine at full width
   (ResNet-18 trunks, 128x128 crops, 21 joints, buckets (1, 8, 32), f32)
   with a synthetic MANO asset and seeded random weights, answering
   requests of 1, 5, 32 and 40 crops.  The launch counters, zeroed just
   before, must show every kernel of the path; outputs must be finite,
   the stage-2 render must cover > 2% of its pixels, and the outputs must
   agree with the same engine on the CPU (the kernels' plain versions);
   then the median latency per bucket;
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
   then the median step time and the peak memory;
5. GPU = CPU: one Pretrain loss and one FinetuneStage loss (without the
   generator) and their gradients at B=4, on the card (twice) and on the
   CPU (the kernels' plain versions), from the same weights and the same
   synth (and real) batch; silhouette flips, part labels and nearest
   faces that differ between the devices are counted.  The same loss on
   the CPU in float64 is the witness: each float32 run's gradients and
   metrics are printed against it, and the GPU's second run against its
   first.  Then the stand-in generator's image of a B=4 synth batch on the
   card against the CPU's and float64's, and one Finetune loss with the
   generator and its gradients, held as the FinetuneStage loss is.

The last two lines are the kernels' JSON record and the device JSON.
Without CUDA, or outside the repository, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12          # H100 SXM float32, CUDA cores
SEED = 0
INPUT_SIZE = 128                # full width: the default config's crops
BUCKETS = (1, 8, 32)
REQUEST_SIZES = (1, 5, 32, 40)  # 40 > 32 exercises the chunking
KERNEL_BATCH = 32
LATENCY_CALLS = 25
TRAIN_BATCH = 32                # the default config's batch
TRAIN_STEPS = 5
COMPARE_BATCH = 4               # GPU step vs CPU step
# launches of each kernel in one two-stage Pretrain step: K1 renders the
# synth batch and the stage-2 input; K5 encodes both stages' labels and
# the stage-2 remap, whose VJP is the only one needed; K4 decodes both
# stages; K2 is the stage-2 render's backward
STEP_LAUNCHES = {"raster_skip": 2, "raster_moments": 1, "codec_encode": 3,
                 "codec_encode_bwd": 1, "codec_decode": 2,
                 "codec_decode_bwd": 2, "point_mesh_argmin": 0,
                 "tail_conv": 1}
# ... and in one FinetuneStage step: K1 renders the synth batch (B), the
# stage-2 input inside the stacked forward (2B) and both stages' loss
# render (2B), and K2 is the backward of the last two; K5 encodes the synth
# labels and the stage-2 remap (whose VJP is needed); K4 decodes the synth
# outputs of both stages, the teacher (no VJP) and the real outputs of both
# stages; K3 is the ICP's one nearest-face pass over 4B clouds
FS_STEP_LAUNCHES = {"raster_skip": 3, "raster_moments": 2, "codec_encode": 2,
                    "codec_encode_bwd": 1, "codec_decode": 3,
                    "codec_decode_bwd": 2, "point_mesh_argmin": 1,
                    "tail_conv": 1}
# ... and in one Finetune step: K1 renders the synth batch and the real
# outputs' loss render, K2 is the latter's backward; K5 encodes the synth
# labels (no VJP: the labels are data); K4 decodes the synth and the real
# outputs (both with VJPs); K3 is the ICP's pass over 2B clouds.  In every
# step K9 is the generator's head, once (no backward: the generator is
# frozen)
F_STEP_LAUNCHES = {"raster_skip": 2, "raster_moments": 1, "codec_encode": 1,
                   "codec_encode_bwd": 0, "codec_decode": 2,
                   "codec_decode_bwd": 2, "point_mesh_argmin": 1,
                   "tail_conv": 1}
# a transferNet_pth that names no file: the trainer's seeded stand-in
# generator, as the JAX package's bench.py and __graft_entry__.py set it
STAND_IN = "__random_init__"
ICP_POINTS = 2048               # points per cloud of the FinetuneStage step
FS_PER_PAIR_FLOPS = 63          # K3's float adds and multiplies per pair
HOLD_CYCLES = 200_000_000       # ~0.1 s of the card's clock, see time_ms
# the codec's foreground test on a normalized depth image; the background
# normalizes to 1.0, or just under it in float32 when the crop centre's
# depth is large
FG = 0.99


class SmokeFailure(RuntimeError):
    pass


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


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
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


def check_raster(renderer, B, stride, rng, record):
    import torch
    from dsf_tpu_torch.ops import raster_kernel
    from dsf_tpu_torch.ops import rasterize as ras

    proj, rays, faces, H, W = raster_scene(renderer, B, stride, rng)
    P = H * W
    F = faces.shape[0]

    rows, cbox = ras.skip_tables(proj, faces)
    zk, ik = raster_kernel.raster_skip_cuda(rows, cbox, rays, (H, W))
    zp, ip = ras.raster_scan(proj, rays, faces)
    torch.cuda.synchronize()
    z_bad = int((zk != zp).sum())
    i_bad = int((ik != ip).sum())
    covered = int((zp > 0).sum())
    err = float((zk - zp).abs().max())

    ms = time_ms(lambda: raster_kernel.raster_skip_cuda(rows, cbox, rays,
                                                       (H, W)), 50)
    tables_ms = time_ms(lambda: ras.skip_tables(proj, faces), 20)
    plain_ms = time_ms(lambda: ras.raster_scan(proj, rays, faces), 5, 1)
    # of each face's 16-float row, the 12 coefficients and the valid flag
    # carry information; the other 3 pad the row for float4 reads
    nbytes = B * F * 13 * 4 + cbox.numel() * 4 + rays.numel() * 4 + B * P * 8
    pairs = raster_pair_count(proj, faces, rays)
    bms, by = bound_ms(nbytes, 16 * pairs)
    say(f"kernel K1 raster_skip B={B} {H}x{W} F={F}: zbuf mismatches "
        f"{z_bad}, id mismatches {i_bad}, covered pixels {covered}/{B * P}, "
        f"max_abs_err {err}, kernel {ms:.4f} ms (+ tables {tables_ms:.4f} ms),"
        f" plain {plain_ms:.4f} ms, bound {bms:.6f} ms by {by} "
        f"({pairs} pixel-face pairs in bbox, {nbytes} bytes)")
    need(z_bad == 0 and i_bad == 0,
         f"K1 disagrees with its plain version at stride {stride}")
    need(covered > 0.02 * B * P, "K1 scene covers too little of the crop")
    if record:
        return {"name": "raster_skip", "route": "cuda",
                "source": "dsf_tpu_torch/csrc/raster_skip.cu",
                "replaces": "dsf_tpu/ops/pallas_raster.py:322",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": None}
    return None


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
    dec_k = codec_kernel.decode_cuda(offset, img, 0.8, 30.0)
    dec_p = oc.offset2joint_plain(offset, img, 0.8, 30.0)
    dec_err = float((dec_k - dec_p).abs().max())
    torch.cuda.synchronize()

    out = []
    for name, err, kfn, pfn, nbytes, flops, replaces in (
            ("codec_encode", enc_err,
             lambda: codec_kernel.encode_cuda(juvd, img, 0.8),
             lambda: oc.joint2offset_plain(juvd, img, 0.8),
             (B * J * 3 + B * P + B * 4 * J * P) * 4, 22 * B * J * P,
             "dsf_tpu/ops/pallas_codec.py:253"),
            ("codec_decode", dec_err,
             lambda: codec_kernel.decode_cuda(offset, img, 0.8, 30.0),
             lambda: oc.offset2joint_plain(offset, img, 0.8, 30.0),
             (B * 4 * J * P + B * P + B * J * 3) * 4, 25 * B * J * P,
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
    return out


def check_moments(renderer, B, stride, rng, record):
    """K2 on the face ids of a real raster and the rows the raster backward
    builds from them (random cotangent)."""
    import torch
    from dsf_tpu_torch.ops import moments_kernel, raster_kernel
    from dsf_tpu_torch.ops import rasterize as ras

    proj, rays, faces, H, W = raster_scene(renderer, B, stride, rng)
    T = faces.shape[0]
    rows, cbox = ras.skip_tables(proj, faces)
    _, idx = raster_kernel.raster_skip_cuda(rows, cbox, rays, (H, W))
    g = torch.from_numpy(rng.randn(B, H * W).astype(np.float32)).cuda()
    gm = g * (idx >= 0).float()
    upd = torch.stack([gm, gm * rays[..., 0], gm * rays[..., 1]], -1).contiguous()
    got = moments_kernel.face_moments_cuda(idx, upd, T)
    ref = moments_kernel.face_moments_plain(idx, upd.double(), T)
    absum = moments_kernel.face_moments_plain(idx, upd.abs().double(), T)
    torch.cuda.synchronize()
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
        f"(vs float64; worst / sum|rows| {worst:.3g}), {hits} covered pixels, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms, bound {bms:.6f} ms by {by}")
    need(worst <= 2e-5, f"K2 disagrees with its plain version: {worst}")
    if record:
        return {"name": "raster_moments", "route": "cuda",
                "source": "dsf_tpu_torch/csrc/moments.cu",
                "replaces": "dsf_tpu/ops/pallas_raster.py:169",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
    return None


def check_codec_bwd(renderer, B, rng):
    """K5 bwd and K4 bwd against autograd of the plain versions on rendered
    hands, with random cotangents."""
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
    # the work this data needs: the encode VJP reads g only where a joint's
    # cone meets the foreground (elsewhere the field is 0 whatever the
    # joint); the decode VJP reads the field only at foreground pixels (the
    # mask zeroes the rest), but every pixel keeps its softmax mass, so its
    # weight, its share of the sums and its depth gradient (~10 operations
    # per joint) remain.  The images, the joints and every output are read
    # or written whole.
    fg = img < FG
    coords = oc._coords(img, S)
    dist = ((juvd[..., None, None] - coords[:, None]) ** 2).sum(2).sqrt()
    cone = int(((dist <= 0.8) & fg).sum())
    n_fg = int(fg.sum())

    def vjp(f, xs, g):
        xs = [x.detach().requires_grad_(True) for x in xs]
        with torch.enable_grad():
            return torch.autograd.grad(f(*xs), xs, g)

    enc_plain = lambda: vjp(lambda j, d: oc.joint2offset_plain(j, d, 0.8),
                            (juvd, img), g_enc)
    dec_plain = lambda: vjp(lambda o, d: oc.offset2joint_plain(o, d, 0.8, 30.0),
                            (offset, img), g_dec)
    enc_k = lambda: codec_kernel.encode_bwd_cuda(juvd, img, g_enc, 0.8)
    dec_k = lambda: codec_kernel.decode_bwd_cuda(offset, img, g_dec, 0.8, 30.0)
    out = []
    for name, kfn, pfn, nbytes, flops, replaces in (
            ("codec_encode_bwd", enc_k, enc_plain,
             (2 * B * J * 3 + 2 * B * P + 4 * cone) * 4, 40 * cone,
             "dsf_tpu/ops/pallas_codec.py:280"),
            ("codec_decode_bwd", dec_k, dec_plain,
             (4 * J * n_fg + B * 4 * J * P + 2 * B * P + B * J * 3) * 4,
             55 * J * n_fg + 10 * J * (B * P - n_fg),
             "dsf_tpu/ops/pallas_codec.py:154")):
        got, ref = kfn(), pfn()
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, ref))
        ms = time_ms(kfn, 50)
        plain_ms = time_ms(pfn, 20)
        bms, by = bound_ms(nbytes, flops)
        say(f"kernel {name} B={B} J={J} S={S}: max_abs_err {err:.3g} "
            f"({rel:.3g} of the gradient's largest entry), kernel {ms:.4f} ms, "
            f"plain (autograd) {plain_ms:.4f} ms, bound {bms:.6f} ms by {by} "
            f"({n_fg} foreground pixels of {B * P}, {cone} joint-pixel pairs "
            "in a cone)")
        # sums over pixels and joints in other orders; near a joint the
        # encode's 1/dist^2 amplifies rounding
        need(rel <= 1e-4, f"{name} disagrees with its plain version: {rel}")
        out.append({"name": name, "route": "cuda",
                    "source": "dsf_tpu_torch/csrc/codec.cu",
                    "replaces": replaces, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "library_ms": None})
    return out


def check_point_mesh(renderer, B, rng):
    """K3 at the FinetuneStage step's shape: the ICP's 4B clouds of 2048
    points against the 2B stage meshes (each mesh twice: its full cloud
    admits every face, part 15; its joint cloud's points take a bone part
    0..14 or -1, none), 1554 faces, the 16-column part table.  Held by the
    exact distance of the kernel's winning face against the plain minimum;
    index disagreements are counted."""
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.ops import point_mesh as pm
    from dsf_tpu_torch.ops import point_mesh_kernel as pk
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
    tris = mesh[:, faces].contiguous()

    dk, ik = pk.argmin_faces_cuda(pts, tris, table, part)
    dp, ip = pm.argmin_faces_plain(pts, tris, table, part)
    torch.cuda.synchronize()
    none = dp >= 1e10
    win = torch.gather(tris, 1, ik.long()[..., None, None].expand(N, P, 3, 3))
    d_win = pm.point_tri_sqdist(pts, win)
    err = float((d_win - dp)[~none].abs().max())
    # the divide-free form subtracts p.p + v.v ~ 1 in these unit-sized
    # coordinates: its rounding, ~1e-7, may pick a face that much further
    worst = float(((d_win - dp).abs() - 1e-5 * dp.abs())[~none].max())
    idx_diff = int((ik != ip).sum())
    none_ok = bool((ik[none] == 0).all()) and bool((dk[none] >= 1e10).all())
    admissible = bool(table[ik[~none].long(), part[~none]].all())

    fc = pk.face_constants(tris)
    words = pk.part_words(table)
    parts = torch.where((part >= 0) & (part < 16), part,
                        torch.full_like(part, 16)).to(torch.int32).contiguous()
    ms = time_ms(lambda: pk.argmin_faces_launch(pts, fc, words, parts), 20)
    prep_ms = time_ms(lambda: (pk.face_constants(tris), pk.part_words(table)),
                      20)
    plain_ms = time_ms(lambda: pm.argmin_faces_plain(pts, tris, table, part),
                       3, 1)
    # the pairs this data needs: each point against the faces its part
    # admits (none for part -1); bytes: points, triangles, the table and
    # the parts read once, dmin and imin written once
    per_part = torch.cat([table.sum(0), torch.zeros(1, device=dev,
                                                    dtype=torch.long)])
    pairs = int(per_part[torch.where(part >= 0, part,
                                     torch.full_like(part, 16))].sum())
    nbytes = (pts.numel() * 4 + tris.numel() * 4 + table.numel()
              + part.numel() * 8 + N * P * 8)
    bms, by = bound_ms(nbytes, FS_PER_PAIR_FLOPS * pairs)
    say(f"kernel K3 point_mesh_argmin {N} clouds x {P} points x {T} faces, "
        f"K=16: winning-face distance max_abs_err {err:.3g} against the plain "
        f"minimum, index disagreements {idx_diff} of {N * P}, points that "
        f"admit no face {int(none.sum())} (imin 0 there: {none_ok}), winners "
        f"admissible: {admissible}; kernel {ms:.4f} ms (+ face rows and part "
        f"words {prep_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bms:.6f} ms "
        f"by {by} ({pairs} admissible pairs of {N * P * T}, {nbytes} bytes)")
    need(worst <= 1e-6, f"K3's winners lie {worst} beyond 1e-5 relative + 1e-6 "
         "from the plain minimum")
    # the index may differ where faces tie: a point nearest to a vertex is
    # as near to every face around it, and the two distance forms round
    # those equal distances differently
    need(none_ok and admissible, "K3 returned an inadmissible face or a "
         "nonzero index where no face is admissible")
    return {"name": "point_mesh_argmin", "route": "cuda",
            "source": "dsf_tpu_torch/csrc/point_mesh.cu",
            "replaces": "dsf_tpu/ops/pallas_point_mesh.py:316",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def check_tail_conv(renderer, B, rng):
    """K9 on the generator's own head input at the training steps' shape:
    the stand-in generator run up to its head on B rendered hands, (B, 64,
    S+6, S+6).  Held within 1e-5 absolute on the tanh output against the
    plain version; the library call is one cuDNN convolution with its bias
    and a tanh, TF32 off, as the plain version computes it."""
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
        f"max_abs_err {err:.3g} (tanh output; {sat:.3f} of it beyond 0.99), "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN conv2d + tanh "
        f"{lib_ms:.4f} ms, bound {bms:.6f} ms by {by}; the whole stand-in "
        f"generator on {tuple(img.shape)} {gen_ms:.3f} ms")
    need(err <= 1e-5, f"K9 disagrees with its plain version: {err}")
    return {"name": "tail_conv", "route": "cuda",
            "source": "dsf_tpu_torch/csrc/tail_conv.cu",
            "replaces": "dsf_tpu/ops/pallas_tapsum.py:122",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


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


def run_slice(mano_path):
    import torch
    from dsf_tpu_torch import demo, kernels
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
    need(counts == {"raster_skip": bucket_calls, "raster_moments": 0,
                    "codec_encode": bucket_calls, "codec_encode_bwd": 0,
                    "codec_decode": 2 * bucket_calls, "codec_decode_bwd": 0,
                    "point_mesh_argmin": 0, "tail_conv": 0},
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

    worst = {}
    for n, r, out in zip(sizes, reqs, outs):
        ref = cpu.predict(*r)
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

    lat = {}
    for b in BUCKETS:
        r = demo.requests(eng.renderer, b, rng)
        for _ in range(3):
            eng.predict(*r)
        times = []
        for _ in range(LATENCY_CALLS):
            t0 = time.perf_counter()
            eng.predict(*r)
            times.append((time.perf_counter() - t0) * 1e3)
        lat[b] = float(np.median(times))
    top = BUCKETS[-1]
    say(f"slice median predict latency ms per bucket ({LATENCY_CALLS} calls, "
        "host clock, to numpy): " + json.dumps(lat)
        + f"; bucket {top} throughput {top * 1e3 / lat[top]:.1f} images/s")
    say(f"slice peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return counts


# ----------------------------------------------------------------- phase 4

def train_config(mano_path, stage_num, seed):
    """The training phases' full-width config, with the stand-in
    generator."""
    from dsf_tpu_torch.config import Config
    return Config(dataset="nyu", batch_size=TRAIN_BATCH, stage_num=stage_num,
                  input_size=INPUT_SIZE, seed=seed, mano_model_path=mano_path,
                  transferNet_pth=STAND_IN)


def run_training(mano_path):
    """TRAIN_STEPS Pretrain steps at full width; returns the launch counts."""
    import torch
    from dsf_tpu_torch import kernels
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.training.trainer import Trainer

    tr = Trainer(train_config(mano_path, 2, SEED), mano_path, device="cuda")
    need(tr.transfer_net is not None, "no transfer net")
    say(f"train: transferNet_pth {STAND_IN!r} names no file: the trainer "
        "runs its seeded stand-in generator (ngf 64, 9 blocks) on every "
        "synth batch")
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
        need(delta == STEP_LAUNCHES,
             f"train step {i} did not launch every kernel of the path as "
             f"expected: {delta} != {STEP_LAUNCHES}")
        need(np.isfinite(losses[-1]), f"train step {i}: loss {losses[-1]}")
    counts = dict(kernels.LAUNCHES)
    say(f"train launches over {TRAIN_STEPS} Pretrain steps (B={TRAIN_BATCH}, "
        f"{INPUT_SIZE}^2): {json.dumps(counts)}")
    say("train losses: " + json.dumps([float(f"{x:.6g}") for x in losses])
        + f"; updates applied {state.updates}/{TRAIN_STEPS}")
    say("train step ms (host clock, to a synchronized loss): "
        + json.dumps([round(t, 3) for t in times])
        + f"; median {float(np.median(times)):.3f} ms, "
        f"{TRAIN_BATCH * 1e3 / float(np.median(times)):.1f} images/s")
    say(f"train peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return counts


def run_self_supervised(mano_path, phase):
    """TRAIN_STEPS Finetune (one stage) or FinetuneStage (two stages) steps
    at full width; returns the launch counts."""
    import torch
    from dsf_tpu_torch import demo, kernels
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.training.trainer import Trainer

    stages = 1 if phase == "Finetune" else 2
    expected = F_STEP_LAUNCHES if stages == 1 else FS_STEP_LAUNCHES
    tag = phase.lower() if stages == 1 else "finetune_stage"
    tr = Trainer(train_config(mano_path, stages, SEED), mano_path,
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
    say(f"{tag} launches over {TRAIN_STEPS} {phase} steps "
        f"(B={TRAIN_BATCH} synth + {TRAIN_BATCH} real, {INPUT_SIZE}^2, "
        f"stand-in generator): {json.dumps(counts)}")
    say(f"{tag} losses: "
        + json.dumps([float(f"{x:.6g}") for x in losses])
        + f"; updates applied {state.updates}/{TRAIN_STEPS}; parameter "
        f"tensors moved {moved} of {len(before_params)}; generator tensors "
        f"moved {gen_moved}")
    say(f"{tag} first step metrics: "
        + json.dumps({k: float(f"{v:.5g}") for k, v in metrics[0].items()}))
    say(f"{tag} step ms (host clock, to a synchronized loss): "
        + json.dumps([round(t, 3) for t in times])
        + f"; median {med:.3f} ms, {2 * TRAIN_BATCH * 1e3 / med:.1f} images/s "
        f"(B synth + B real images a step)")
    say(f"{tag} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    need(state.updates == TRAIN_STEPS and moved >= 0.95 * len(before_params),
         f"{phase} updates were not applied")
    need(gen_moved == 0, f"{phase} moved the frozen generator")
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


def compare_step(mano_path):
    """One Pretrain loss and its gradients on the card and on the CPU, from
    the same weights, on the card's synth batch; and the same loss on the
    CPU in float64, the witness that says how far float32 rounding alone
    moves each gradient."""
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
                 mano_model_path=mano_path)
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
    say(f"compare B={B} {INPUT_SIZE}^2: synth batch GPU vs CPU: {synth_flips} "
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


def compare_finetune_stage(mano_path):
    """One FinetuneStage loss and its gradients on the card and on the CPU,
    from the same weights, on the card's synth batch and one real batch
    (the same cloud-sampling scores); the same loss on the CPU in float64
    is the witness.  The stage-1 MANO head feeds the losses and, through
    the stage-2 remap render, the stage-2 trunk: the share of its gradient
    that comes that way (measured on the CPU run) is held at the trunks'
    tolerance, the rest at the heads'.  On the card (H100 80GB HBM3 at
    700 W) the GPU lay a median 0.0496 (max 0.0696) from the CPU in the
    trunks and 0.00398 in that head; the CPU lay a median 0.0908 from
    float64, and 0.0709 in that head."""
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
    cfg = Config(dataset="nyu", batch_size=B, stage_num=2,
                 input_size=INPUT_SIZE, seed=SEED + 7,
                 mano_model_path=mano_path)
    gpu = Trainer(cfg, mano_path, device="cuda")
    cpu = Trainer(cfg, mano_path, device="cpu")
    sg, sc = gpu.init_state(), cpu.init_state()
    net64 = copy.deepcopy(sc.net).double()
    r64 = float64_renderer(cpu.renderer)
    para, cube = next(random_param_source(B, seed=SEED + 8))
    para, cube = torch.from_numpy(para), torch.from_numpy(cube)
    draws = gpu.draw(B, "FinetuneStage")
    real = demo.real_batch(cpu.renderer, B, np.random.RandomState(SEED + 9))
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
    say(f"compare FinetuneStage B={B} {INPUT_SIZE}^2: joint-cloud part labels "
        f"that differ between the GPU and CPU runs {seg_diff} of {n_pts}; "
        f"ICP nearest faces (K3 against the plain argmin) {win_diff} of "
        f"{4 * n_pts}")
    gpu_cpu = rel_l2(grads["gpu"], grads["cpu"])
    gpu_64 = rel_l2(grads["gpu"], grads["cpu64"])
    cpu_64 = rel_l2(grads["cpu"], grads["cpu64"])
    gpu_gpu = rel_l2(grads["gpu_again"], grads["gpu"])
    say(f"compare FinetuneStage loss GPU {loss['gpu']:.7g} CPU "
        f"{loss['cpu']:.7g} CPU float64 {loss['cpu64']:.10g}; gradient "
        f"relative L2 per parameter: GPU vs CPU {spread(gpu_cpu)}; GPU vs "
        f"float64 {spread(gpu_64)}; CPU vs float64 {spread(cpu_64)}; GPU vs "
        f"GPU again {spread(gpu_gpu)}; the stage-1 MANO head's share through "
        f"the stage-2 trunk {share:.4g}")
    rows = {}
    for k in mets["cpu"]:
        v = {run: mets[run][k] for run in mets}
        rows[k] = {run: float(f"{x:.7g}") for run, x in v.items()}
    say("compare FinetuneStage metrics (GPU, GPU again, CPU, CPU float64): "
        + json.dumps(rows))
    rel_loss = abs(loss["gpu"] - loss["cpu"]) / abs(loss["cpu"])
    need(rel_loss <= 1e-4, f"FinetuneStage GPU loss {loss['gpu']} differs "
         f"from the CPU's {loss['cpu']}")
    for k in FS_METRICS:
        m64 = mets["cpu64"][k]
        tol = (3 * max(abs(mets["cpu"][k] - m64),
                       abs(mets["gpu"][k] - mets["gpu_again"][k]))
               + 1e-3 * abs(m64))
        need(abs(mets["gpu"][k] - mets["cpu"][k]) <= tol,
             f"FinetuneStage metric {k}: GPU {mets['gpu'][k]} CPU "
             f"{mets['cpu'][k]} float64 {m64} (tolerance {tol:.3g})")

    heads = {k: (float(f"{gpu_cpu[k]:.3g}"), float(f"{cpu_64[k]:.3g}"))
             for k in gpu_cpu if k.startswith(("mano_regress", "finals_s2"))}
    say("compare FinetuneStage heads' gradients (GPU vs CPU, CPU vs float64): "
        + json.dumps(heads))

    def tol(name):
        """Pretrain's tolerance, with the stage-1 MANO head's share through
        the stage-2 trunk held at the trunks'."""
        if name.startswith("mano_regress."):
            return grad_tol(name) + grad_tol("trunk") * share
        return grad_tol(name)

    bad = {k: v for k, v in gpu_cpu.items() if not v <= tol(k)}
    need(not bad, f"FinetuneStage GPU gradients differ from the CPU's: {bad}")
    # against float64, also twice the CPU's own distance where float32
    # rounding alone moves a gradient further: the part labels, nearest
    # faces and silhouettes the losses select move with it, and a second
    # float32 run that far from float64 may lie twice as far
    bad = {k: v for k, v in gpu_64.items()
           if not v <= max(tol(k), 2 * cpu_64[k])}
    need(not bad, f"FinetuneStage GPU gradients differ from float64: {bad}")
    ratio = (float(np.median(list(gpu_64.values())))
             / float(np.median(list(cpu_64.values()))))
    need(ratio <= MEDIAN_RATIO, f"FinetuneStage GPU gradients lie {ratio:.3g} "
         "times further from float64 than the CPU's, in the median")


# the Finetune metrics held in phase 5, as FS_METRICS
F_METRICS = ("d2m", "pd2m", "m2d", "coll", "P2M", "M2P")


def compare_finetune(mano_path):
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
    the metrics as FinetuneStage's."""
    import copy
    import torch
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.training import phases
    from dsf_tpu_torch.training.trainer import Trainer

    B = COMPARE_BATCH
    cfg = dataclasses.replace(train_config(mano_path, 1, SEED + 10),
                              batch_size=B)
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
    say(f"compare Finetune B={B} {INPUT_SIZE}^2 with the generator: loss GPU "
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
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
            record += check_codec(renderer, KERNEL_BATCH, rng)
        record.append(check_moments(renderer, KERNEL_BATCH, 2, rng,
                                    record=True))
        check_moments(renderer, KERNEL_BATCH, 1, rng, record=False)
        record += check_codec_bwd(renderer, KERNEL_BATCH, rng)
        with torch.inference_mode():
            record.append(check_point_mesh(renderer, 2 * TRAIN_BATCH, rng))
            record.append(check_tail_conv(renderer, TRAIN_BATCH, rng))
        serve_counts = run_slice(path)
        train_counts = run_training(path)
        fs_counts = run_self_supervised(path, "FinetuneStage")
        f_counts = run_self_supervised(path, "Finetune")
        compare_step(path)
        compare_finetune_stage(path)
        compare_finetune(path)
    for rec in record:
        by_path = {"serve": serve_counts[rec["name"]],
                   "train": train_counts[rec["name"]],
                   "finetune_stage": fs_counts[rec["name"]],
                   "finetune": f_counts[rec["name"]]}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
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
