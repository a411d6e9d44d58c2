#!/usr/bin/env python3
"""Pretrain convergence of the PyTorch/CUDA port on one NVIDIA GPU, in
float32 and in bfloat16 from the same seed and draws: the counterpart of
scripts/convergence_tpu.py, on synthetic parameters only.

    PYTHONPATH=. python3 scripts/convergence_gpu.py [--steps 400]

For each compute dtype it builds a Trainer (two-stage ResNet-18, 128^2
crops, B=32, the seeded stand-in generator, seeded random weights, the
synthetic MANO asset) and runs N Pretrain steps, each on fresh random
61-D MANO parameters drawn as convergence_tpu.py draws them (numpy seed 0,
the same for both dtypes) and the trainer's own augmentation draws (its
generator seeded from the config, the same for both).  Every ``--every``
steps it logs the loss and the per-stage pixel and MANO mm errors.  It
prints one JSON line per log point, then per dtype the mean of each error
over the first log point (the random-init errors) and over the last
three, the step time (host clock) and whether every tail mean fell below
0.6x its head mean; and the card's name and power limit.  The whole curve
goes to ``--out`` (default runs/convergence_gpu.json, git-ignored).  Exits
non-zero without a GPU (``--device cpu`` rehearses it on the CPU's plain
kernels, e.g. with ``--input-size 64 --batch 2 --steps 3``) or when a
loss is not finite.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def synth_batch(rng: np.random.RandomState, B: int) -> dict:
    """convergence_tpu.py's MANO parameter distribution."""
    para = np.concatenate(
        [rng.uniform(-1, 1, (B, 3)), rng.randn(B, 45) * 0.5,
         rng.randn(B, 10) * 0.5, np.ones((B, 1)), np.zeros((B, 3))],
        axis=1).astype(np.float32)
    return {"model_para": para,
            "cube_synth": np.full((B, 3), 250.0, np.float32)}


def run(dtype: str, args, mano_path: str) -> dict:
    import torch
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.training.trainer import Trainer

    cfg = Config(dataset="nyu", batch_size=args.batch, stage_num=2,
                 input_size=args.input_size, seed=0,
                 transferNet_pth="__random_init__", compute_dtype=dtype)
    tr = Trainer(cfg, mano_path, device=args.device)
    state = tr.init_state()
    step = tr.train_step_fn("Pretrain")
    rng = np.random.RandomState(0)
    curve, times = [], []
    for i in range(args.steps):
        batch = synth_batch(rng, args.batch)
        t0 = time.perf_counter()
        state, metrics = step(state, tr.draw(args.batch), batch)
        loss = float(metrics["loss"])          # waits for the device
        times.append(time.perf_counter() - t0)
        if not np.isfinite(loss):
            raise SystemExit(f"{dtype} step {i}: loss {loss}")
        if i % args.every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()
                 if k.startswith(("pixel_error", "mano_error")) or k == "loss"}
            m.update(step=i, dtype=dtype)
            curve.append(m)
            print(json.dumps(m), flush=True)
    if args.device == "cuda":
        torch.cuda.synchronize()
    head, tail = curve[:1], curve[-3:]
    summary = {"dtype": dtype, "steps": args.steps,
               "median_step_ms": float(np.median(times[1:] or times) * 1e3),
               "updates": int(state.updates), "ok": True}
    for k in sorted(curve[-1]):
        if not k.startswith(("pixel_error", "mano_error")):
            continue
        h = float(np.mean([p[k] for p in head]))
        t = float(np.mean([p[k] for p in tail]))
        summary[k] = {"head_mm": round(h, 3), "tail_mm": round(t, 3)}
        summary["ok"] = summary["ok"] and bool(t < 0.6 * h)
    return {"summary": summary, "curve": curve}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--every", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--input-size", type=int, default=128)
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=os.path.join("runs",
                                                  "convergence_gpu.json"))
    args = ap.parse_args()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("convergence_gpu: needs a CUDA card (or --device cpu)",
              file=sys.stderr)
        return 1
    from dsf_tpu_torch.mano import synthetic

    with tempfile.TemporaryDirectory() as tmp:
        path = synthetic.save_synthetic_mano(os.path.join(tmp, "mano.npz"))
        runs = [run(dt, args, path) for dt in args.dtypes.split(",")]
    for r in runs:
        print(json.dumps(r["summary"]), flush=True)
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(f"device: {smi}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": args.device, "runs": runs}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
