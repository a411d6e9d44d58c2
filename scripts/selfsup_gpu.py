#!/usr/bin/env python3
"""Self-supervision efficacy of the PyTorch/CUDA port on one NVIDIA GPU:
does the label-free FinetuneStage improve accuracy on a shifted "real"
domain?  The counterpart of scripts/selfsup_tpu.py, with its protocol
and its environment variables:

    PYTHONPATH=. python3 scripts/selfsup_gpu.py

  1. a fake NYU set from ``data.fake.make_fake_nyu`` (512 train + 128
     test frames, seed 7: rotations over +-pi, pose std 0.3), built on the
     card unless ``SELFSUP_DATA`` already holds one;
  2. ``SELFSUP_PRETRAIN_STEPS`` (1200) Pretrain steps on synthetic MANO
     parameters from a narrower distribution (rotations +-1 rad), so the
     fake real set lies out of the synth domain;
  3. evaluate view 0 of the test split: E_pretrain;
  4a. control: ``SELFSUP_STEPS`` (600) more Pretrain steps: E_control;
  4b. treatment, from the state of step 3: as many FinetuneStage steps on
     the train split's augmented crops (``NYUDataset.prefetch_batches``;
     the labels only feed the monitoring metrics): E_selfsup.
  PASS when the stage-2 pixel and MANO errors of the treatment are below
  the control's and the pretrained ones, else FAIL (exit code 1).

Two-stage ResNet-18, 128^2 crops, B=32, the bfloat16 compute dtype, no
transfer net (``transferNet_pth=""``: the fake real images come from the
same renderer), the synthetic MANO asset, weights and draws seeded from
``SELFSUP_SEED`` (0).  The JSON of selfsup_tpu.py's keys, with the card's
name and power limit (``nvidia-smi``), goes to ``SELFSUP_OUT`` (default
runs/selfsup_gpu.json, git-ignored).  Exits non-zero without a GPU;
``run(..., device="cpu")`` rehearses the protocol on the plain kernels at
a small size.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
EVAL_KEYS = ("img", "xyz_gt", "center", "M", "cube")


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def run(pretrain_steps=1200, steps=600, seed=0, out_path=None,
        data_root=None, device=None, batch=32, size=128):
    """The protocol on ``device`` (``cuda`` when None; raises without it).
    Returns the summary dict (also written to ``out_path``)."""
    import torch
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.data import datasets as D
    from dsf_tpu_torch.data.fake import make_fake_nyu
    from dsf_tpu_torch.device import resolve_device
    from dsf_tpu_torch.mano import synthetic
    from dsf_tpu_torch.training.loop import _to_device
    from dsf_tpu_torch.training.trainer import Trainer

    dev = resolve_device(device)
    smi = nvidia_smi_line() if dev.type == "cuda" else None
    out_path = out_path or os.path.join(ROOT, "runs", "selfsup_gpu.json")
    data_root = data_root or os.path.join(ROOT, "runs", "selfsup_fake_nyu")
    os.makedirs(data_root, exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    mano_path = os.path.join(data_root, "mano_synthetic.npz")
    if not os.path.exists(mano_path):
        synthetic.save_synthetic_mano(mano_path)

    B = batch
    cfg = Config(dataset="nyu", batch_size=B, stage_num=2, input_size=size,
                 transferNet_pth="", compute_dtype="bfloat16", seed=seed)
    tr = Trainer(cfg, mano_path, steps_per_epoch=1000, device=dev)

    # ---- 1. the fake real domain: rotations over +-pi
    if not os.path.isdir(os.path.join(data_root, "nyu", "train")):
        t0 = time.time()
        make_fake_nyu(data_root, mano_path, n_train=512, n_test=128, seed=7,
                      device=dev)
        print(f"fake NYU built in {time.time() - t0:.1f} s", flush=True)
    nyu_root = os.path.join(data_root, "nyu")
    train_ds = D.NYUDataset(nyu_root, "train", img_size=size,
                            aug_para=cfg.augment_para)
    test_ds = D.NYUDataset(nyu_root, "test", view=0, img_size=size)

    rng = np.random.RandomState(seed)

    def synth_params():
        # the narrow pretraining distribution (rotations +-1 rad against
        # the real set's +-pi): the controlled domain gap
        return {"model_para": np.concatenate(
                    [rng.uniform(-1, 1, (B, 3)), rng.randn(B, 45) * 0.5,
                     rng.randn(B, 10) * 0.5, np.ones((B, 1)),
                     np.zeros((B, 3))], axis=1).astype(np.float32),
                "cube_synth": np.full((B, 3), 250.0, np.float32)}

    def eval_state(state):
        batches = ({k: b[k] for k in EVAL_KEYS}
                   for b in test_ds.batches(B, shuffle=False, drop_last=True))
        e = tr.evaluate(state, batches)      # [pix0, mano0, pix1, mano1]
        return {"pixel_mm_s1": round(float(e[0]), 2),
                "mano_mm_s1": round(float(e[1]), 2),
                "pixel_mm_s2": round(float(e[2]), 2),
                "mano_mm_s2": round(float(e[3]), 2)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def reseed(s):
        tr.generator = torch.Generator().manual_seed(s)

    # ---- 2. pretrain on the narrow synth distribution
    state = tr.init_state()
    pre_step = tr.train_step_fn("Pretrain")
    reseed(seed * 100)
    sync()
    t0 = time.perf_counter()
    for i in range(pretrain_steps):
        state, metrics = pre_step(state, tr.draw(B), synth_params())
        if i % 200 == 0:
            print(json.dumps({"phase": "pretrain", "step": i,
                              "loss": float(metrics["loss"])}), flush=True)
    sync()
    t_pre = time.perf_counter() - t0
    base = copy.deepcopy(state)

    # ---- 3. after pretraining
    e_pretrain = eval_state(state)
    print(json.dumps({"eval": "pretrain", **e_pretrain}), flush=True)

    # ---- 4a. control: more Pretrain steps
    reseed(seed * 100 + 1)
    for i in range(steps):
        state, metrics = pre_step(state, tr.draw(B), synth_params())
    e_control = eval_state(state)
    print(json.dumps({"eval": "control", **e_control}), flush=True)

    # ---- 4b. treatment: FinetuneStage steps from the same pretrained state
    state = base
    fin_step = tr.train_step_fn("FinetuneStage")
    reseed(seed * 100 + 1)
    real_it = train_ds.prefetch_batches(B, shuffle=True, loop=True,
                                        drop_last=True, seed=seed * 100 + 3,
                                        transform=_to_device(dev))
    sync()
    t0 = time.perf_counter()
    try:
        for i in range(steps):
            rb = next(real_it)
            batch = dict(synth_params(), **{k: rb[k] for k in EVAL_KEYS})
            state, metrics = fin_step(state, tr.draw(B, "FinetuneStage"),
                                      batch)
            if i % 100 == 0:
                print(json.dumps(
                    {"phase": "selfsup", "step": i,
                     "loss": float(metrics["loss"]),
                     "mano_error_1": float(metrics["mano_error_1"])}),
                    flush=True)
        sync()
        t_fin = time.perf_counter() - t0
    finally:
        real_it.close()
        train_ds.close()
    e_selfsup = eval_state(state)
    print(json.dumps({"eval": "selfsup", **e_selfsup}), flush=True)

    ok = all(e_selfsup[k] < e_control[k] and e_selfsup[k] < e_pretrain[k]
             for k in ("pixel_mm_s2", "mano_mm_s2"))
    summary = {
        "K1_pretrain": pretrain_steps, "K2": steps, "seed": seed,
        "pretrain_fps": round(pretrain_steps * B / t_pre, 1),
        "selfsup_fps": round(steps * B / t_fin, 1),
        "e_pretrain": e_pretrain, "e_control": e_control,
        "e_selfsup": e_selfsup, "ok": bool(ok),
        "device": str(dev) if smi is None else torch.cuda.get_device_name(dev),
        "nvidia_smi": smi, "torch": torch.__version__,
        "batch": B, "input_size": size, "compute_dtype": cfg.compute_dtype,
    }
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


def main():
    summary = run(
        pretrain_steps=int(os.environ.get("SELFSUP_PRETRAIN_STEPS", "1200")),
        steps=int(os.environ.get("SELFSUP_STEPS", "600")),
        seed=int(os.environ.get("SELFSUP_SEED", "0")),
        out_path=os.environ.get("SELFSUP_OUT"),
        data_root=os.environ.get("SELFSUP_DATA"))
    if summary["nvidia_smi"]:
        print(summary["nvidia_smi"], flush=True)
    print("PASS" if summary["ok"] else "FAIL", flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
