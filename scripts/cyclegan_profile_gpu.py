#!/usr/bin/env python3
"""Where a CycleGAN training step's time goes on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/cyclegan_profile_gpu.py [--batch 32]

One ``CycleGANTrainer`` step at full width (two ResnetGenerators, ngf 64,
9 blocks, two PatchGAN discriminators, 128^2 crops, float32 without TF32)
from seeded weights, on two batches of synth crops rendered from random
MANO parameters (``pipelines.synth_batch``; the "real" batch is a second
render: the step's work does not depend on the images).  After two
warm-up steps it times ``--steps`` steps on the host clock (each to a
synchronized g_loss), then runs them again under ``torch.profiler`` and
prints, per step, the device time by family of kernel name (K9, the
convolutions, the instance norms, elementwise, reductions, the
optimizer, the rest), the busy share of the wall, the top kernels and
the peak memory; then, with CUDA events, one generator head's forward
(K9) and its backward (``TailConvFn.backward``: the plain version
recomputed and its two 64 -> 1 convolution gradients in cuDNN) at the
step's head shape (B, 64, 134, 134), of which a step runs six; and the
card's name and power limit.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def family(name: str) -> str:
    """The family of a CUDA kernel's name."""
    n = name.lower()
    if "tail_conv" in n:
        return "K9 (tail conv kernel)"
    if "adam" in n or "multi_tensor" in n:
        return "optimizer"
    if any(k in n for k in ("conv", "cudnn", "sm90_", "implicit", "gemm",
                            "wgrad", "dgrad", "winograd", "fft")):
        return "convolution (cuDNN / cuBLAS)"
    if "norm" in n or "welford" in n:
        return "instance norm"
    if "reduce" in n:
        return "reductions"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("cyclegan_profile_gpu: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.device import exact_float32
    from dsf_tpu_torch.mano import model as mano, synthetic
    from dsf_tpu_torch.render import renderer as rnd
    from dsf_tpu_torch.training.cyclegan_trainer import CycleGANTrainer
    from dsf_tpu_torch.training.pipelines import synth_batch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    path = synthetic.save_synthetic_mano(
        os.path.join(ROOT, "runs", "cyclegan_profile_mano.npz"))
    r = rnd.Renderer.create(mano.load_model(path, device="cuda"), "nyu",
                            demo.PARAS, (640, 480), (128, 128))
    src = random_param_source(args.batch, seed=0)
    gen = torch.Generator().manual_seed(0)
    synth, real = (synth_batch(r, gen, *next(src)) for _ in range(2))
    gan = CycleGANTrainer()
    state = gan.init_state(torch.Generator().manual_seed(0))
    step = gan.train_step_fn()

    def run(n):
        nonlocal state
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            state, m = step(state, synth, real)
            float(m["g_loss"])
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    run(2)
    torch.cuda.reset_peak_memory_stats()
    times = run(args.steps)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(args.steps)
    wall = (time.perf_counter() - t0) * 1e3 / args.steps
    fams, kernels = {}, {}
    for e in prof.key_averages():
        # the kernels alone (the CPU ops that launch them carry their
        # device time too)
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev = (getattr(e, "self_device_time_total", 0)
               or getattr(e, "self_cuda_time_total", 0))
        if dev <= 0:
            continue
        ms = dev / 1e3 / args.steps
        kernels[e.key] = ms
        f = family(e.key)
        fams[f] = fams.get(f, 0.0) + ms
    device = sum(fams.values())
    peak = torch.cuda.max_memory_allocated() / 2 ** 20

    # one generator head, forward (K9) and backward, with CUDA events
    from dsf_tpu_torch.ops import tapsum_kernel
    g = torch.Generator(device="cuda").manual_seed(0)
    head = state.G_A.model[-1]
    x = torch.randn(args.batch, 64, 134, 134, device="cuda", generator=g,
                    requires_grad=True)
    w, b = head.weight, head.bias
    cot = torch.randn(args.batch, 1, 128, 128, device="cuda", generator=g)

    def timed(fn, n=20):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    with exact_float32():
        y = tapsum_kernel.TailConvFn.apply(x, w, b)
        fwd = timed(lambda: tapsum_kernel.TailConvFn.apply(x, w, b))
        bwd = timed(lambda: torch.autograd.grad(y, (x, w, b), cot,
                                                retain_graph=True))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    out = {
        "batch": args.batch, "steps": args.steps, "card": smi,
        "step_ms_host": [round(t, 3) for t in times],
        "step_ms_median": float(np.median(times)),
        "images_per_s": 2 * args.batch * 1e3 / float(np.median(times)),
        "profiled_wall_ms_per_step": round(wall, 3),
        "device_ms_per_step": round(device, 3),
        "busy": round(device / wall, 3),
        "families_ms": {k: round(v, 3) for k, v in
                        sorted(fams.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": [[k[:120], round(v, 3)] for k, v in top],
        "peak_mib": round(peak, 1),
        "head_forward_ms": round(fwd, 4), "head_backward_ms": round(bwd, 4),
        "heads_ms_per_step": round(6 * (fwd + bwd), 3),
    }
    print(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
