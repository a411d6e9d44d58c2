#!/usr/bin/env python3
"""The trainer's command line on ICVL and MSRA, on the card.

    PYTHONPATH=. python3 scripts/datasets_cli_gpu.py

Builds small ICVL and MSRA stand-ins (tests/torch_fake_sets.py: rendered
MANO hands, K6 on the card) and a synthetic MANO asset in a temporary
directory, then runs, each in its own process as a user would,

    python -m dsf_tpu_torch.training --dataset icvl   (FinetuneStage)
    python -m dsf_tpu_torch.training --dataset msra --test_id 2 --stage_num 1

with the seeded stand-in generator, for the datasets' own epoch counts
(ICVL 8, MSRA 10) of 2 steps each at B=32.  Each run must leave train.log
with every epoch, ``latest``, ``best`` and view 0's result_0/1 with one
finite row per test frame, and no other view.  Prints each run's wall
time with the card's name and power limit; exits non-zero on a failure
or without CUDA.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
TRAIN, TEST = 64, 20


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("datasets_cli_gpu: needs a CUDA device", file=sys.stderr)
        return 1
    import torch_fake_sets as F
    from dsf_tpu_torch.config import EPOCH
    from dsf_tpu_torch.mano import synthetic
    from dsf_tpu_torch.training.checkpoints import FILE

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        mano = os.path.join(tmp, "mano.npz")
        synthetic.save_synthetic_mano(mano)
        data = os.path.join(tmp, "data")
        F.make_icvl(data, mano, TRAIN, TEST, seed=0)
        F.make_msra(data, mano, {2: (("1",), TEST), 3: (("1",), TRAIN // 2),
                                 7: (("1",), TRAIN // 2)}, seed=1)
        for dataset, extra in (("icvl", []),
                               ("msra", ["--test_id", "2", "--stage_num",
                                         "1"])):
            save = os.path.join(tmp, "ckpt")
            cmd = [sys.executable, "-m", "dsf_tpu_torch.training",
                   "--dataset", dataset, "--root_dir", data,
                   "--mano_model_path", mano, "--save_dir", save,
                   "--transferNet_pth", "__random_init__",
                   "--model_save", dataset, "--image_every", "0"] + extra
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 cwd=ROOT, env=dict(os.environ,
                                                    PYTHONPATH=ROOT))
            secs = time.perf_counter() - t0
            if res.returncode:
                print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
                print(f"datasets_cli_gpu: {dataset} exited {res.returncode}",
                      file=sys.stderr)
                return 1
            run = os.path.join(save, dataset, dataset)
            log = open(os.path.join(run, "train.log")).read()
            epochs = EPOCH[dataset]
            ok = all(f"Epoch#{e}:" in log for e in range(epochs))
            ok &= all(os.path.exists(os.path.join(run, n, FILE))
                      for n in ("latest", "best"))
            for i in (0, 1):
                rows = np.loadtxt(os.path.join(run, f"result_{i}_0.txt"))
                ok &= rows.shape == (TEST, 63) and bool(np.isfinite(rows).all())
            ok &= not os.path.exists(os.path.join(run, "result_0_1.txt"))
            print(f"datasets_cli_gpu {dataset}: {epochs} epochs of "
                  f"{TRAIN // 32} steps, {TEST} test frames, in {secs:.1f} s "
                  f"(the process, kernel builds included); "
                  f"{res.stdout.strip().splitlines()[-1]}; {smi}")
            if not ok:
                print(f"datasets_cli_gpu: {dataset}'s run directory lacks an "
                      "epoch, a checkpoint or its exports", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
