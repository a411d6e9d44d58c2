"""Host input-pipeline throughput (counterpart of
dsf_tpu/tools/bench_input.py): frames a second of the NYU train loader's
``prefetch_batches`` (read, crop and augment on a background thread,
``data.datasets.NYUDataset``), from the PNGs and then from the RAM depth
cache that ``training.loop`` turns on, so that an input-bound step shows
beside the device's.

Usage:
    python -m dsf_tpu_torch.tools.bench_input --root <data root>
    python -m dsf_tpu_torch.tools.bench_input --fake

``--fake`` (or no ``--root``) first writes a fake NYU set of 256 + 8
frames (``data.fake.make_fake_nyu``, rendered on the card) into a
temporary directory, removed at the end.  Prints one JSON line a
measurement, host clock, unrounded.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def bench_dataset(ds, batch_size=32, n_batches=50, **kw):
    """Frames a second over ``n_batches`` batches of the looping,
    shuffled ``prefetch_batches``, after one batch that starts its
    thread."""
    it = ds.prefetch_batches(batch_size, shuffle=True, loop=True,
                             drop_last=True, **kw)
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        dt = time.perf_counter() - t0
    finally:
        it.close()
    return batch_size * n_batches / dt


def run(root, batch_size=32, n_batches=50, img_size=128):
    """Measure the NYU train split under ``root``/nyu: returns
    {"nyu_input_pipeline_fps": ..., "nyu_input_pipeline_fps_cached": ...}."""
    from dsf_tpu_torch.data.datasets import NYUDataset
    ds = NYUDataset(os.path.join(root, "nyu"), "train", img_size=img_size)
    try:
        n = min(n_batches, max(len(ds) // batch_size, 1) * 4)
        out = {"nyu_input_pipeline_fps": bench_dataset(ds, batch_size, n)}
        # the steady state of the train loop (loop.py turns the cache on):
        # epochs after the first crop and augment without decoding
        ds.enable_depth_cache()
        for i in range(len(ds)):
            ds._read_depth_cached(i)
        out["nyu_input_pipeline_fps_cached"] = bench_dataset(ds, batch_size,
                                                             n)
    finally:
        ds.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--n_batches", type=int, default=50)
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--fake", action="store_true",
                    help="generate a fake NYU dataset to measure against")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="dsf_input_bench_") as tmp:
        root = args.root
        if args.fake or not root:
            from dsf_tpu_torch.data.fake import make_fake_nyu
            from dsf_tpu_torch.mano import synthetic
            npz = os.path.join(tmp, "m.npz")
            synthetic.save_synthetic_mano(npz)
            root = make_fake_nyu(tmp, npz, n_train=256, n_test=8)
        out = run(root, args.batch_size, args.n_batches, args.img_size)
    for metric, value in out.items():
        print(json.dumps({"metric": metric, "value": value,
                          "unit": "frames/sec"}))
    return out["nyu_input_pipeline_fps_cached"]


if __name__ == "__main__":
    main()
