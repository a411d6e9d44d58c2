"""Where the serving predict's and the training steps' time goes on the
card.

    python -m dsf_tpu_torch.profiling

Builds the full-width two-stage engine from seeded inputs (demo.py),
warms it up, then, for each of its buckets (1, 8, 32), runs ``CALLS``
predicts under torch.profiler (CPU + CUDA activities).  Then the same for
``CALLS`` two-stage Pretrain train steps, ``CALLS`` one-stage Finetune
train steps and ``CALLS`` two-stage FinetuneStage train steps at B=32
(Trainer, seeded weights, 128x128 crops; the self-supervised steps' real
half is demo.real_batch), each with the frozen CycleGAN generator's
seeded stand-in (``transferNet_pth`` set to a missing path, as the JAX
package's bench does); then the same buckets and the same three steps in
the bfloat16 compute dtype (``Config(compute_dtype="bfloat16")``).  For each it prints, per call: the host wall time
(timed without the profiler), the device time summed over kernels, the
device busy share (that sum over the wall time; one stream, so kernels do
not overlap), the device time by kernel family and by the top kernels,
and the float operations (torch.utils.flop_counter) over the
convolutions' device time (the pose net's and the generator's convolution
kernels), against the card's float32 rate outside the tensor cores
(float32 cells) or its dense bfloat16 tensor-core rate (bfloat16 cells).  The
generator's kernels (those inside its profiler range, ``transfer_net``)
but K9 are their own family, "CycleGAN generator"; "convolution" is the
pose net's.  (The float operations leave out K9's,
which no PyTorch operator computes: 3.3 GFLOP a step at B=32.)  One JSON
summary line per bucket and one per step.  Needs a CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from dsf_tpu_torch import demo
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.data.synth_params import random_param_source
from dsf_tpu_torch.mano import synthetic
from dsf_tpu_torch.training.trainer import TRANSFER_RANGE, Trainer

# H100 SXM: float32 on the CUDA cores, bfloat16 dense on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
CALLS = 10                      # profiled predicts per bucket, and steps
TRAIN_BATCH = 32                # the default config's batch
GEN_FAMILY = "CycleGAN generator"
MISSING_GENERATOR = "__random_init__"   # a missing path: the stand-in

FAMILIES = (
    ("K1 raster_skip", ("raster_skip_kernel", "face_setup_kernel")),
    ("K2 raster moments", ("moments_kernel",)),
    ("K5 codec encode", ("encode_fwd_kernel",)),
    ("K5 codec encode VJP", ("encode_bwd",)),
    ("K4 codec decode", ("decode_fwd_kernel",)),
    ("K4 codec decode VJP", ("decode_bwd_kernel",)),
    ("K3 point-mesh argmin", ("Form27", "setup27_kernel")),
    ("K9 tail conv", ("tail_conv_kernel",)),
    ("batchnorm", ("batch_norm", "bn_fw", "bn_bw")),
    ("convolution", ("conv", "cudnn", "xmma", "implicit_gemm", "winograd",
                     "dgrad", "wgrad", "fprop", "cutlass", "fft",
                     "pointwise_mult_and_sum_complex")),
    ("gemm", ("gemm", "gemv", "splitk")),
    ("elementwise and reductions", ("elementwise", "reduce", "Kernel")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("profiling: needs a CUDA card", file=sys.stderr)
        return 1
    for dtype in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as tmp:
            path = synthetic.save_synthetic_mano(os.path.join(tmp, "mano.npz"))
            eng = demo.engine(path, "cuda", compute_dtype=dtype)
            trainers = {n: Trainer(
                Config(dataset="nyu", batch_size=TRAIN_BATCH, stage_num=n,
                       transferNet_pth=MISSING_GENERATOR,
                       compute_dtype=dtype), path, device="cuda")
                for n in (1, 2)}
        for bucket in eng.buckets:
            profile_bucket(eng, bucket)
        profile_pretrain(trainers[2])
        profile_self_supervised(trainers[1], "Finetune")
        profile_self_supervised(trainers[2], "FinetuneStage")
        del eng, trainers
    return 0


def profile_bucket(eng, bucket: int) -> None:
    req = demo.requests(eng.renderer, bucket, np.random.RandomState(1))
    dtype = eng.cfg.compute_dtype
    measure(f"bucket {bucket} {dtype}", {"bucket": bucket, "dtype": dtype},
            "predict calls", lambda: eng.predict(*req), dtype)


def profile_pretrain(trainer: Trainer) -> None:
    state = trainer.init_state()
    step = trainer.train_step_fn("Pretrain")
    src = random_param_source(TRAIN_BATCH, seed=1)

    def one():
        para, cube = next(src)
        step(state, trainer.draw(TRAIN_BATCH),
             {"model_para": para, "cube_synth": cube})

    dtype = trainer.cfg.compute_dtype
    measure(f"Pretrain step B={TRAIN_BATCH} {dtype}",
            {"phase": "Pretrain", "batch": TRAIN_BATCH, "dtype": dtype},
            "train steps", one, dtype)


def profile_self_supervised(trainer: Trainer, phase: str) -> None:
    state = trainer.init_state()
    step = trainer.train_step_fn(phase)
    src = random_param_source(TRAIN_BATCH, seed=2)
    real = demo.real_batch(trainer.renderer, TRAIN_BATCH,
                           np.random.RandomState(3))

    def one():
        para, cube = next(src)
        step(state, trainer.draw(TRAIN_BATCH, phase),
             dict(real, model_para=para, cube_synth=cube))

    dtype = trainer.cfg.compute_dtype
    measure(f"{phase} step B={TRAIN_BATCH} {dtype}",
            {"phase": phase, "batch": TRAIN_BATCH, "dtype": dtype},
            "train steps", one, dtype)


def generator_ranges(events):
    """The device-time intervals of the generator's profiler ranges."""
    return [(ev.time_range.start, ev.time_range.end) for ev in events
            if ev.name == TRANSFER_RANGE and ev.is_user_annotation
            and ev.device_type == torch.autograd.DeviceType.CUDA]


def measure(label: str, key: dict, what: str, call, dtype: str) -> None:
    """Warm ``call`` up, count its float operations, time ``CALLS`` calls
    on the host clock, then profile ``CALLS`` more and print the report;
    the convolutions' rate against the card's peak for ``dtype``."""
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    with FlopCounterMode(display=False) as counter:
        call()
    flops = counter.get_total_flops()

    # the wall time is taken without the profiler, which slows the host
    t0 = time.perf_counter()
    for _ in range(CALLS):
        call()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()

    # device-side kernels only: a CPU op's device time repeats its kernels',
    # and a user annotation's device range (the optimizer's step, the
    # generator) spans kernels that are counted on their own
    events = prof.events()
    gen = generator_ranges(events)
    by_name, fams = defaultdict(float), defaultdict(float)
    gen_conv_ms = 0.0
    for ev in events:
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.is_user_annotation):
            continue
        ms = ev.self_device_time_total / 1e3 / CALLS
        by_name[ev.name] += ms
        fam = family(ev.name)
        if (not fam.startswith("K")
                and any(a <= ev.time_range.start < b for a, b in gen)):
            gen_conv_ms += ms if fam == "convolution" else 0.0
            fam = GEN_FAMILY
        fams[fam] += ms
    device_ms = sum(by_name.values())
    conv_ms = fams.get("convolution", 0.0) + gen_conv_ms
    peak = PEAK_FLOPS[dtype]
    conv_share = flops / (conv_ms * 1e-3) / peak if conv_ms else 0.0
    print(f"{label}: {CALLS} {what}, host wall "
          f"{wall_ms:.3f} ms/call, device kernels {device_ms:.3f} ms/call, "
          f"{len(gen) // CALLS if gen else 0} generator range(s) a call, "
          f"device busy share {device_ms / wall_ms:.3f}, "
          f"{flops / 1e9:.1f} GFLOP/call, convolutions at "
          f"{conv_share:.3f} of the {dtype} peak ({peak / 1e12:.0f} TFLOP/s)")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  family {fam}: {ms:.3f} ms/call ({ms / device_ms:.1%})")
    print("  (the generator's family holds its kernels but K9, of which "
          f"convolutions {gen_conv_ms:.3f} ms/call; convolution is the pose "
          "net's)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    for name, ms in top:
        print(f"  kernel {ms:8.3f} ms/call  {name[:110]}")
    print(json.dumps(dict(key, wall_ms=wall_ms, device_ms=device_ms,
                          busy_share=device_ms / wall_ms,
                          gflop=flops / 1e9,
                          conv_share_of_peak=conv_share,
                          generator_conv_ms=gen_conv_ms,
                          families_ms=dict(fams),
                          device=torch.cuda.get_device_name(0))))


if __name__ == "__main__":
    sys.exit(main())
